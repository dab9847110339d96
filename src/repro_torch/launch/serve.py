"""LM serving with DLS-technique admission chunks (the port's copy of the
``--mode lm`` path of ``launch/serve.py``).

    # on the card, Granite-8B at full size
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        --requests 8 --slots 4 --prompt-len 2048 --gen-len 16 --technique GSS
    # RWKV6-3B or Zamba2-7B the same way: --arch rwkv6-3b / zamba2-7b
    # on the CPU, the reduced config
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

The loop is the reference's: the partitioner of ``--technique`` cuts the
backlog into chunks (``next_chunk() or 1``); a chunk is padded to a
multiple of ``--slots`` by repeating its last request; each slot batch
gets a fresh cache, one prefill and ``gen_len - 1`` greedy decode steps
(argmax over the unmasked padded-vocab logits, the token at position
``prompt_len + t``). The weights are fp32, drawn on ``--device`` from a
``torch.Generator`` seeded 0 (the reference's ``jax.random`` key 0 gives
other numbers). The cache (KV for the dense family; token shifts and
the WKV state for RWKV6; conv rows, SSM state and the shared attention's
KV for Zamba2) is updated in place where the reference donates it to a
functional update. On a CUDA device a prompt over 1,024 tokens prefills
its attention through K4 (``models/attention.py:chunked_attention``), an
RWKV6 prompt its WKV through K6 and a Zamba2 prompt its SSD scan through
K5.

``--mode pipelines`` and ``--mode openloop`` wait for the server and
front-door stack (ROADMAP A14).
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..configs import get_config
from ..core import make_partitioner
from ..models import Model

__all__ = ["ServeResult", "serve_lm", "main"]


@dataclass
class ServeResult:
    """What ``serve_lm`` served, and how long it took.

    Per slot batch: the requests of its rows (a padded chunk repeats its
    last request), the generated tokens ``(slots, gen_len)`` and the
    logits each token was taken from ``(slots, gen_len, padded_vocab)``.
    Seconds are host-clock, synchronised with the device at the end of
    each batch's prefill and of its decode steps.
    """

    model: Any
    params: dict
    prompts: np.ndarray
    requests: list = field(default_factory=list)
    tokens: list = field(default_factory=list)
    logits: list = field(default_factory=list)
    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0
    seconds: float = 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_lm(args, params: dict | None = None) -> ServeResult:
    """LM continuous batching with DLS-technique admission chunks.

    ``args`` carries the command line's fields (``arch``, ``smoke``,
    ``requests``, ``slots``, ``prompt_len``, ``gen_len``, ``technique``,
    ``device``). ``params`` are the weights to serve (for instance the
    reference's, through ``model_params_from_reference``); None draws them.
    Prints the reference's summary line.
    """
    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    model = Model(cfg)
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        params = model.init_params(gen, device)
    s_max = args.prompt_len + args.gen_len

    rng = np.random.default_rng(0)
    prompts = np.stack([rng.integers(0, cfg.vocab_size, args.prompt_len,
                                     dtype=np.int32) for _ in range(args.requests)])
    part = make_partitioner(args.technique, args.requests, args.slots)
    res = ServeResult(model, params, prompts)

    served, t0 = 0, time.perf_counter()
    while served < args.requests:
        n = min(part.next_chunk() or 1, args.requests - served)
        reqs = list(range(served, served + n))
        served += n
        reqs += [reqs[-1]] * ((-len(reqs)) % args.slots)
        for i in range(0, len(reqs), args.slots):
            rows = reqs[i:i + args.slots]
            toks = torch.from_numpy(prompts[rows]).to(device)
            t = time.perf_counter()
            cache = model.init_cache(len(rows), s_max, device=device)
            logits, cache = model.prefill(params, {"tokens": toks}, cache)
            step_logits = [logits[:, -1]]
            tok = logits[:, -1].argmax(-1)[:, None]
            out = [tok]
            _sync(device)
            t1 = time.perf_counter()
            for step in range(args.gen_len - 1):
                logits, cache = model.decode_step(params, tok, cache,
                                                  args.prompt_len + step)
                step_logits.append(logits[:, 0])
                tok = logits[:, 0].argmax(-1)[:, None]
                out.append(tok)
            _sync(device)
            res.prefill_seconds += t1 - t
            res.decode_seconds += time.perf_counter() - t1
            res.requests.append(rows)
            res.tokens.append(torch.cat(out, dim=1))
            res.logits.append(torch.stack(step_logits, dim=1))
    res.seconds = time.perf_counter() - t0
    print(f"[serve] {args.requests} requests x {args.gen_len} tokens in "
          f"{res.seconds:.1f}s ({args.requests * args.gen_len / res.seconds:.1f} tok/s)",
          flush=True)
    return res


def main(argv: list[str] | None = None) -> None:
    """Entry point: LM serving (``--mode lm``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["lm", "pipelines", "openloop"], default="lm")
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--technique", default="GSS",
                    help="admission-chunk technique (11 options)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (the tests pass cpu)")
    args = ap.parse_args(argv)
    if args.mode != "lm":
        raise NotImplementedError(f"--mode {args.mode} needs the server and "
                                  "front-door stack: ROADMAP A14")
    serve_lm(args)


if __name__ == "__main__":
    main()
