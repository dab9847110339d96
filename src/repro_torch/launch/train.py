"""Training launcher (the port's copy of ``launch/train.py``).

    # on the card, Qwen2-0.5B at full width
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --seq 2048 --global-batch 8 --steps 100 --ckpt-dir ckpts
    # on the CPU, the reduced config
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 3

The reference's arguments and report lines. Each step's batch is packed
by the DaphneSched-scheduled data pipeline (``data/pipeline.py``: GSS
chunks on 4 PERCORE workers with SEQPRI stealing, prefetched on a
background thread), the loss is ``Model.train_loss`` under the config's
remat, and AdamW (``optim/adamw.py``) updates the fp32 master weights;
``runtime/fault.py:run_loop`` retries failed steps, flags stragglers,
checkpoints every ``--checkpoint-every`` steps and resumes from the latest
COMMITTED checkpoint in ``--ckpt-dir``. Each step writes the new weights
and moments over the old (``build_train_step(in_place=True)``, the same
bits as the reference's pure update, unless ``--compress-grads``), and a
run that resumes draws no state of its own: RWKV6-3B's fp32 weights and
moments (36.9 GB) are held once on an 80 GB card. The weights are drawn on
``--device`` (the card unless the caller asks for the CPU) from a
``torch.Generator`` seeded 0. On the card a prompt over 1,024 tokens takes
its attention, forward and backward, through K4.

One device, no mesh: ``--data`` or ``--model`` above 1, ``--multi-pod``,
``--coordinator`` and more than one process raise, naming ROADMAP A17.
The reference's XLA flags (the TPU's latency-hiding scheduler) have no
counterpart here and are left out.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Any

import torch

__all__ = ["TrainRun", "main", "parse_args"]


@dataclass
class TrainRun:
    """What ``main`` ran: the model, the final state, the fault loop's
    report, each step's metrics (floats), the pipeline, and the run's host
    seconds and tokens/s."""

    model: Any
    state: Any
    report: Any
    metrics: list
    pipeline: Any
    seconds: float
    tokens_per_second: float


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--coordinator", default=None,
                    help="multi-process coordinator address (waits for ROADMAP A17)")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--smoke", action="store_true",
                    help="shrink the arch to CPU scale")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (the tests pass cpu)")
    args = ap.parse_args(argv)
    if args.data * args.model > 1 or args.multi_pod or args.coordinator \
            or args.num_processes > 1:
        raise NotImplementedError(
            f"--data {args.data} --model {args.model}"
            f"{' --multi-pod' if args.multi_pod else ''}"
            f"{' --coordinator' if args.coordinator else ''}"
            f" over {args.num_processes} process(es): the port trains on one device; "
            "the mesh and multi-process training wait for ROADMAP A17")
    return args


def main(argv: list[str] | None = None) -> TrainRun:
    """Train ``--arch`` for ``--steps`` steps; print the reference's two
    report lines and return the run."""
    args = parse_args(argv)

    from ..checkpoint import checkpoint as ckpt
    from ..configs import get_config
    from ..core import SchedulerConfig
    from ..data import DataPipeline, SyntheticCorpus
    from ..models import Model, count_params
    from ..optim import AdamWConfig
    from ..runtime import build_train_step, init_train_state
    from ..runtime.fault import FaultConfig, run_loop
    from ..runtime.steps import TrainState

    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    model = Model(cfg)
    print(f"[train] {args.arch}: {count_params(cfg) / 1e6:.1f}M params"
          f"{' (smoke)' if args.smoke else ''}", flush=True)

    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(1, args.steps // 20),
                          compress=args.compress_grads)
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, mean_len=args.seq // 2)
    pipe = DataPipeline(corpus, args.global_batch, args.seq,
                        sched=SchedulerConfig(technique="GSS",
                                              queue_layout="PERCORE",
                                              victim_strategy="SEQPRI",
                                              n_workers=4,
                                              numa_domains=(0, 0, 1, 1)))

    # a run that resumes restores its state from the checkpoint: it draws
    # none, so that one state, not two, is ever held on the device
    resumes = args.ckpt_dir is not None and ckpt.latest_step(args.ckpt_dir) is not None
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state = None if resumes else init_train_state(model, gen, opt_cfg)
    step = build_train_step(model, opt_cfg, n_microbatches=args.microbatches,
                            in_place=not args.compress_grads)

    metrics: list[dict] = []

    def step_fn(state, batch):
        state, m = step(state, {"tokens": torch.from_numpy(batch["tokens"]).to(device)})
        metrics.append({k: float(v) for k, v in m.items()})  # waits for the step
        return state, m

    t0 = time.perf_counter()
    state, report = run_loop(
        step_fn, state, pipe.prefetch(args.steps, depth=2),
        ckpt_dir=args.ckpt_dir,
        config=FaultConfig(checkpoint_every=args.checkpoint_every),
        state_restorer=lambda t: TrainState(**t), restore_device=device)
    dt = time.perf_counter() - t0

    toks = report.steps_run * args.global_batch * args.seq
    print(f"[train] {report.steps_run} steps, {toks / dt:.0f} tok/s, "
          f"retries={report.retries}, stragglers={len(report.stragglers)}, "
          f"resumed_from={report.resumed_from}", flush=True)
    return TrainRun(model=model, state=state, report=report, metrics=metrics,
                    pipeline=pipe, seconds=dt, tokens_per_second=toks / dt)


if __name__ == "__main__":
    main()
