"""Serving driver: request generation scheduled BY DaphneSched (the port of
``examples/serve_lm.py``).

Incoming requests are the rows of a PipelineDAG stage: each row runs one
request's prefill -> decode loop at batch 1 on a pool worker thread, the
decode slots are the pool's workers, and the stage's DLS technique sizes
the admission chunks (GSS: big chunks while the backlog is deep, small
near the tail). The job enters through the ``Submission`` front door, and
the scheduled tokens are held bitwise to the direct (unscheduled)
generation of the same requests: greedy int32 tokens, bitwise on the card
too (the model's kernels are deterministic and each request runs alone).

The model is Granite-8B reduced to 4 layers, d_model 128, d_ff 256, 4
heads over 1 kv head of 16 (a width K4 takes), weights drawn from seed 0
on the device, a float32 cache. A prompt over 1,024 tokens takes its
prefill attention through K4 (``csrc/flash_attention.cu``) on the card.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --requests 24 --torch-device cpu
    # on the card, K4 in every prefill
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --prompt-len 2048
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ._common import add_device_flag, kernel_launches, resolve_device, sync

__all__ = ["config", "main", "make_generate", "run"]


def config():
    """The served model: Granite-8B's reduced config at 4 layers, d_model
    128, d_ff 256 (head width 16)."""
    from ..configs import get_config

    cfg = get_config("granite-8b").reduced()
    return dataclasses.replace(cfg, n_layers=4, d_model=128, d_ff=256)


def make_generate(model, params, requests: np.ndarray, gen_len: int, device):
    """``generate(_ins, r)``: request ``r`` end to end at batch 1 (prefill,
    then ``gen_len - 1`` greedy decode steps) as host int32 tokens
    ``(gen_len,)``, the row a ``concat`` stage stacks. Runs without
    autograd on whatever thread calls it."""
    prompt_len = requests.shape[1]
    s_max = prompt_len + gen_len

    def generate(_ins, r):
        with torch.no_grad():   # grad mode is per thread: set on the pool's
            sl = torch.from_numpy(requests[r][None]).to(device)
            cache = model.init_cache(1, s_max, dtype=torch.float32, device=device)
            logits, cache = model.prefill(params, {"tokens": sl}, cache)
            out = [logits[:, -1].argmax(-1)]
            for t in range(gen_len - 1):
                logits, cache = model.decode_step(params, out[-1][:, None], cache,
                                                  prompt_len + t)
                out.append(logits[:, 0].argmax(-1))
            return torch.stack(out)[:, 0].to(torch.int32).cpu().numpy()

    return generate


def run(requests: int = 24, slots: int = 4, prompt_len: int = 32, gen_len: int = 16,
        config_spec: str = "gss/percore", torch_device="cuda", params=None,
        model=None) -> dict:
    """Serve ``requests`` prompts of ``prompt_len`` random tokens (seed 0)
    for ``gen_len`` tokens each on ``slots`` workers under ``config_spec``.
    ``model`` / ``params``: the served model (``config()`` by default) and
    its weights (drawn from seed 0 on the device by default)."""
    from ..core import PipelineDAG, PipelineExecutor, make_config
    from ..core.lower import row_stage
    from ..core.submit import Submission
    from ..models import Model

    dev = resolve_device(torch_device)
    model = model or Model(config())
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = model.init_params(gen, dev)
    rng = np.random.default_rng(0)
    prompts = np.stack([rng.integers(0, model.cfg.vocab_size, prompt_len)
                        for _ in range(requests)]).astype(np.int32)
    generate = make_generate(model, params, prompts, gen_len, dev)

    # DaphneSched as the admission scheduler: rows = requests, chunk sizes
    # from the stage's DLS technique, submitted through the front door
    dag = PipelineDAG([row_stage("generate", generate, requests)])
    pool = make_config(config_spec, n_workers=slots)
    sub = Submission(dag=dag, name="serve-lm", tenant="lm",
                     stage_costs={"generate": np.full(requests, 1.0)})
    generate(None, 0)  # warm up outside the timed run
    with kernel_launches() as launches:
        t0 = time.perf_counter()
        res = PipelineExecutor(dag, pool).run(sub)
        sync(dev)
        dt = time.perf_counter() - t0
    tokens = np.asarray(res.values["generate"])  # (requests, gen_len)

    # the scheduled path must reproduce direct generation bit for bit
    check = min(3, requests)
    direct = np.stack([generate(None, r) for r in range(check)])
    if not np.array_equal(tokens[:check], direct):
        raise AssertionError("scheduled != direct")

    chunk_trace = [int(z) for _, z in res.stages["generate"].schedule]
    total_tokens = requests * gen_len
    print(f"served {requests} requests x {gen_len} tokens in {dt:.1f}s "
          f"({total_tokens / dt:.1f} tok/s on {dev.type}), steals={res.steals}")
    print(f"admission chunks ({config_spec}): {chunk_trace} "
          f"(self-scheduling: large while backlog is deep, small at the tail)")
    return dict(tokens=tokens, seconds=dt, tokens_per_second=total_tokens / dt,
                scheduled_vs_direct="bitwise", chunks=chunk_trace, launches=launches)


def main(argv: list[str] | None = None) -> dict:
    """Parse the reference's flags and ``--torch-device``; serve."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--slots", type=int, default=4, help="decode slots = scheduler workers")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--config", default="gss/percore",
                    help="make_config spec: technique[/layout[/victim]]")
    add_device_flag(ap)
    a = ap.parse_args(argv)
    return run(requests=a.requests, slots=a.slots, prompt_len=a.prompt_len,
               gen_len=a.gen_len, config_spec=a.config, torch_device=a.torch_device)


if __name__ == "__main__":
    main()
