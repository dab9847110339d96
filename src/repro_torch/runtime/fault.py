"""Fault-tolerant step runner: retry, straggler watchdog, checkpoint cadence,
auto-resume (the port's copy of ``runtime/fault.py``).

The failure model is the reference's: (a) transient step failures ->
bounded retry, except an exception whose ``retryable`` is False (a step
that wrote part of its state in place), which is raised at once; (b)
stragglers -> each step's time against the rolling median of the last
``straggler_window`` steps, flagged beyond
``straggler_factor`` times it; (c) process death -> a restart resumes from
the latest COMMITTED checkpoint (``checkpoint/checkpoint.py`` makes the
save atomic). Step times come from this module's ``perf_counter``, so a
test can feed the watchdog fixed times.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from time import perf_counter
from typing import Any, Callable

import numpy as np

from ..checkpoint import checkpoint as ckpt

__all__ = ["FaultConfig", "RunReport", "run_loop"]

log = logging.getLogger("repro_torch.fault")


@dataclass
class FaultConfig:
    max_retries: int = 3
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    straggler_factor: float = 3.0   # step > factor * rolling median -> straggler
    straggler_window: int = 20
    async_checkpoint: bool = True


@dataclass
class RunReport:
    steps_run: int = 0
    retries: int = 0
    stragglers: list[int] = field(default_factory=list)
    resumed_from: int | None = None
    step_times: list[float] = field(default_factory=list)


def run_loop(
    step_fn: Callable[[Any, Any], tuple[Any, dict]],
    state: Any,
    batches,                      # iterable of batches
    ckpt_dir: str | None = None,
    config: FaultConfig = FaultConfig(),
    start_step: int = 0,
    state_restorer: Callable[[Any], Any] | None = None,
    restore_device="cuda",
) -> tuple[Any, RunReport]:
    """Run ``step_fn`` over ``batches`` with retry, straggler and checkpoint
    handling. A checkpoint at or past ``start_step`` in ``ckpt_dir`` is
    restored first (onto ``restore_device``), and the loop counts on from
    the step after it. ``state_restorer`` maps the restored tree back into
    the state type (e.g. ``TrainState(**tree)``)."""
    report = RunReport()

    if ckpt_dir is not None:
        latest = ckpt.latest_step(ckpt_dir)
        if latest is not None and latest >= start_step:
            tree, extra, step = ckpt.restore(ckpt_dir, device=restore_device)
            state = state_restorer(tree) if state_restorer else tree
            start_step = step + 1
            report.resumed_from = step
            log.info("resumed from checkpoint step %d", step)

    step_idx = start_step
    times: list[float] = []
    for batch in batches:
        attempt = 0
        while True:
            t0 = perf_counter()
            try:
                state, metrics = step_fn(state, batch)
                dt = perf_counter() - t0
                break
            except Exception as e:  # transient failure -> bounded retry
                if not getattr(e, "retryable", True):
                    # e.g. an in-place update that wrote part of the state
                    # (optim/adamw.py:PartialUpdateError): a retry would
                    # apply those leaves' update twice
                    if ckpt_dir is not None:
                        ckpt.wait_for_pending()
                    raise
                attempt += 1
                report.retries += 1
                log.warning("step %d failed (%s); retry %d/%d",
                            step_idx, e, attempt, config.max_retries)
                if attempt >= config.max_retries:
                    if ckpt_dir is not None:
                        ckpt.wait_for_pending()
                    raise
        times.append(dt)
        report.step_times.append(dt)
        if len(times) > config.straggler_window:
            times.pop(0)
        med = float(np.median(times))
        if len(times) >= 5 and dt > config.straggler_factor * med:
            report.stragglers.append(step_idx)
            log.warning("straggler at step %d: %.3fs vs median %.3fs",
                        step_idx, dt, med)

        if ckpt_dir is not None and (step_idx + 1) % config.checkpoint_every == 0:
            tree = state.__dict__ if hasattr(state, "__dict__") and not isinstance(state, dict) \
                else state
            if config.async_checkpoint:
                ckpt.save_async(ckpt_dir, step_idx, tree)
            else:
                ckpt.save(ckpt_dir, step_idx, tree)
            ckpt.gc_keep_last(ckpt_dir, config.keep_checkpoints)

        step_idx += 1
        report.steps_run += 1

    if ckpt_dir is not None:
        ckpt.wait_for_pending()
    return state, report
