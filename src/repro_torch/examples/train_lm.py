"""End-to-end LM training: a DaphneSched-scheduled data pipeline ->
scheduler-accumulated gradients -> the fault-tolerant loop with
checkpoints (the port of ``examples/train_lm.py``).

The train step runs THROUGH the scheduler: each step's batch is split into
gradient microbatches that form the rows of a one-stage PipelineDAG
(``combine="sum"``), submitted through the ``Submission`` front door; the
pool's DLS technique chunks the microbatches, each chunk's op takes its
microbatches' ``[loss, flat fp32 grads]`` on a pool worker thread (on the
device, where the vectors stay), the stage sums the chunks' vectors in
completion order, and AdamW is applied to the sum over the microbatch
count. The flat vector's leaf order is ``flatten``'s (the params' dict
keys sorted, lists in order); ``unflatten`` undoes it.

The model is a dense decoder scaled from ``--arch`` by ``--d-model``,
``--layers``, ``--heads`` (kv heads a quarter of them), ``--d-ff`` and
``--vocab``, with ``--heads`` setting the head width. On the card a
sequence over 1,024 tokens takes its attention, forward and gradient,
through K4 and K4' (``csrc/flash_attention.cu``, ``flash_attention_bwd.cu``).
The reference's "~100M configuration" runs there as its README gives it,
with the default 8 heads (two kv heads) of 96, a width K4 is compiled for:

    PYTHONPATH=src python -m repro_torch.examples.train_lm --d-model 768 --layers 12 \
        --seq 2048 --batch 8 --microbatches 4 --steps 20

58,608,384 parameters, 2,048 tokens a row so that K4 runs. On the CPU
(the kernels' plain versions), a small model:

    PYTHONPATH=src python -m repro_torch.examples.train_lm --torch-device cpu \
        --d-model 64 --layers 2 --heads 4 --d-ff 128 --vocab 512 --seq 32 --steps 6 --lr 3e-3

One device: ``--data`` or ``--model`` above 1 raises, naming ROADMAP A17
(the mesh layer). Checkpoints go to ``--ckpt-dir``, by default
``repro_torch_train_ckpt`` in the temporary directory (not the reference's
directory: ``run_loop`` resumes from whatever it finds there).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import tempfile
import time

import numpy as np
import torch

from ._common import add_device_flag, kernel_launches, resolve_device, sync

__all__ = ["DEFAULT_CKPT_DIR", "apply_flat", "flatten", "main", "micro_grads",
           "run", "scaled_config", "scheduled_grads", "unflatten"]

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt")


def scaled_config(arch: str = "granite-8b", d_model: int = 256, layers: int = 8,
                  heads: int = 8, d_ff: int = 1024, vocab: int = 8192):
    """``arch``'s config as a dense decoder of the given widths."""
    from ..configs import get_config

    return dataclasses.replace(
        get_config(arch), n_layers=layers, d_model=d_model, n_heads=heads,
        n_kv_heads=max(1, heads // 4), d_ff=d_ff, d_head=0, vocab_size=vocab,
        vocab_pad_multiple=64, moe=None, mla=None, ssm=None, rwkv=None, encdec=None,
        frontend=None, family="dense", first_layer_dense=False, tie_embeddings=False)


def _walk(tree, leaf):
    """``tree`` rebuilt with ``leaf`` applied to each leaf, in
    ``flatten``'s order."""
    if isinstance(tree, dict):
        return {k: _walk(tree[k], leaf) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_walk(v, leaf) for v in tree]
    return leaf(tree)


def flatten(tree) -> torch.Tensor:
    """Every leaf of ``tree`` as float32, raveled and concatenated (dict
    keys sorted, lists in order): the counterpart of ``ravel_pytree``."""
    leaves = []
    _walk(tree, lambda t: leaves.append(t.float().reshape(-1)))
    return torch.cat(leaves)


def unflatten(flat: torch.Tensor, like):
    """``flat`` cut back into a tree shaped as ``like`` (views of ``flat``)."""
    offset = 0

    def take(t):
        nonlocal offset
        n = t.numel()
        offset += n
        return flat[offset - n:offset].view(t.shape)

    return _walk(like, take)


def micro_grads(model, params, tokens: torch.Tensor) -> torch.Tensor:
    """One microbatch's ``[loss, flat grads]`` vector (float32, on the
    tokens' device). Sets its own grad mode, as a pool thread needs."""
    from ..runtime import loss_and_grads

    loss, _, grads = loss_and_grads(model, params, {"tokens": tokens})
    return torch.cat([loss.float().reshape(1), flatten(grads)])


def scheduled_grads(model, params, tokens: torch.Tensor, n_micro: int, pool_cfg):
    """The step's gradient stage: ``tokens (B, S + 1)`` split into
    ``n_micro`` microbatches, the rows of a one-stage ``combine="sum"`` DAG
    on the pool ``pool_cfg``. Returns ``(summed [loss, grads], DagResult)``:
    the sum over the microbatches, folded in completion order."""
    from ..core import PipelineDAG, PipelineExecutor, Stage
    from ..core.submit import Submission

    mb = tokens.reshape(n_micro, tokens.shape[0] // n_micro, -1)

    def grads_op(_inputs, s, z):
        acc = None
        for m in range(s, s + z):
            v = micro_grads(model, params, mb[m])
            acc = v if acc is None else acc + v
        return acc

    dag = PipelineDAG([Stage("micrograds", n_micro, grads_op, combine="sum")])
    sub = Submission(dag=dag, name="train-step", tenant="train",
                     stage_costs={"micrograds": np.full(n_micro, 1.0)})
    res = PipelineExecutor(dag, pool_cfg).run(sub)
    return res.values["micrograds"], res


def apply_flat(state, summed: torch.Tensor, n_micro: int, opt_cfg):
    """AdamW on the microbatches' mean gradient: ``(state, metrics)``, the
    metrics with the mean ``loss``."""
    from ..optim import apply_updates
    from ..runtime.steps import TrainState

    loss = summed[0] / n_micro
    grads = unflatten(summed[1:] / n_micro, state.params)
    new_p, new_opt, metrics = apply_updates(state.params, grads, state.opt, opt_cfg)
    return TrainState(params=new_p, opt=new_opt, step=state.step + 1), {**metrics,
                                                                         "loss": loss}


def run(arch: str = "granite-8b", d_model: int = 256, layers: int = 8, heads: int = 8,
        d_ff: int = 1024, vocab: int = 8192, seq: int = 256, batch: int = 8,
        steps: int = 20, lr: float = 3e-4, microbatches: int = 4, sched: str = "fac2",
        workers: int = 2, data: int = 1, model: int = 1,
        ckpt_dir: str | None = DEFAULT_CKPT_DIR, compress_grads: bool = False,
        torch_device="cuda", params=None) -> dict:
    """Train for ``steps`` steps (the flags' meanings above). ``params``:
    the initial weights (for instance the reference's, through
    ``model_params_from_reference``), drawn from seed 0 on the device by
    default. Returns the losses, seconds, tokens/s, the median step's and
    pool wait's seconds, and the kernels' launches."""
    from ..core import SchedulerConfig, make_config
    from ..data import DataPipeline, SyntheticCorpus
    from ..models import Model, count_params
    from ..optim import AdamWConfig, init_opt_state
    from ..runtime import init_train_state
    from ..runtime.fault import FaultConfig, run_loop
    from ..runtime.steps import TrainState

    if batch % microbatches:
        raise ValueError("--batch must be divisible by --microbatches")
    if data * model > 1:
        raise NotImplementedError(
            f"--data {data} --model {model}: the port trains on one device; the "
            "mesh waits for ROADMAP A17")
    dev = resolve_device(torch_device)
    cfg = scaled_config(arch, d_model, layers, heads, d_ff, vocab)
    net = Model(cfg)
    n_params = count_params(cfg)
    print(f"model: {n_params / 1e6:.1f}M params ({cfg.n_layers}L d={cfg.d_model}, "
          f"{cfg.n_heads} heads x {cfg.head_dim})")

    opt_cfg = AdamWConfig(lr=lr, total_steps=max(steps, 100),
                          warmup_steps=min(20, steps // 4 + 1), compress=compress_grads)
    # DaphneSched drives batch assembly
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, mean_len=seq // 2)
    pipe = DataPipeline(corpus, batch, seq,
                        sched=SchedulerConfig(technique="GSS", queue_layout="PERCORE",
                                              victim_strategy="SEQPRI", n_workers=4,
                                              numa_domains=(0, 0, 1, 1)))
    pool_cfg = make_config(sched, n_workers=workers)

    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        state = init_train_state(net, gen, opt_cfg)
    else:
        state = TrainState(params=params, opt=init_opt_state(params, opt_cfg),
                           step=torch.zeros((), dtype=torch.int32, device=dev))

    losses, pool_seconds = [], []

    def step_fn(state, batch_):
        """One train step THROUGH the scheduler."""
        t0 = time.perf_counter()
        toks = torch.from_numpy(batch_["tokens"]).to(dev)
        summed, _ = scheduled_grads(net, state.params, toks, microbatches, pool_cfg)
        sync(dev)    # the gradients are ready: the pool's part of the step
        pool_seconds.append(time.perf_counter() - t0)
        state, metrics = apply_flat(state, summed, microbatches, opt_cfg)
        losses.append(float(metrics["loss"]))
        return state, metrics

    with kernel_launches() as launches:
        t0 = time.perf_counter()
        state, report = run_loop(
            step_fn, state, pipe.prefetch(steps, depth=2), ckpt_dir=ckpt_dir,
            config=FaultConfig(checkpoint_every=max(5, steps // 3)),
            state_restorer=lambda tree: TrainState(**tree), restore_device=dev)
        dt = time.perf_counter() - t0

    tok_s = report.steps_run * batch * seq / dt
    out = dict(params=n_params, losses=losses, steps_run=report.steps_run,
               resumed_from=report.resumed_from, seconds=dt, tokens_per_second=tok_s,
               launches=launches)
    print(f"ran {report.steps_run} steps in {dt:.1f}s ({tok_s:.0f} tok/s, {dev.type}); "
          f"resumed_from={report.resumed_from}")
    if report.step_times:
        step_s = statistics.median(report.step_times)
        wait_s = statistics.median(pool_seconds)
        out.update(step_seconds=step_s, pool_wait_seconds=wait_s,
                   pool_wait_share=wait_s / step_s)
        print(f"step {step_s * 1e3:.1f} ms (median), of which {wait_s * 1e3:.1f} ms "
              f"waiting on the pool's gradient stage ({wait_s / step_s:.1%})")
    if not losses:
        print(f"nothing left to run: {ckpt_dir} holds a finished run")
        return out
    out.update(first_loss=losses[0], last_loss=losses[-1])
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'DECREASED' if losses[-1] < losses[0] else 'flat'})")
    if not losses[-1] < losses[0]:
        raise AssertionError("loss must decrease")
    return out


def main(argv: list[str] | None = None) -> dict:
    """Parse the reference's flags and ``--torch-device``; train."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b", help="architecture family to scale down")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--d-ff", type=int, default=1024)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=4,
                    help="gradient microbatches per step (scheduler rows)")
    ap.add_argument("--sched", default="fac2", help="make_config spec for the gradient stage")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--data", type=int, default=1, help="mesh data axis (ROADMAP A17)")
    ap.add_argument("--model", type=int, default=1, help="mesh model axis (ROADMAP A17)")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--compress-grads", action="store_true")
    add_device_flag(ap)
    a = ap.parse_args(argv)
    if a.batch % a.microbatches:
        ap.error("--batch must be divisible by --microbatches")
    return run(arch=a.arch, d_model=a.d_model, layers=a.layers, heads=a.heads, d_ff=a.d_ff,
               vocab=a.vocab, seq=a.seq, batch=a.batch, steps=a.steps, lr=a.lr,
               microbatches=a.microbatches, sched=a.sched, workers=a.workers, data=a.data,
               model=a.model, ckpt_dir=a.ckpt_dir, compress_grads=a.compress_grads,
               torch_device=a.torch_device)


if __name__ == "__main__":
    main()
