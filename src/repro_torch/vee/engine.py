"""VEE: converts (data, operator) into row-range tasks for DaphneSched.

Mirrors the DAPHNE runtime's vectorized execution engine (the paper's
"From data to tasks"): data parallelism over matrix rows, task
granularity decided by the work partitioner, execution by the worker
pool, partial results combined by the pipeline.

Combiners:
  'concat'  partials are row blocks of the output (e.g. the CC propagation)
  'sum'     partials are additive reductions (e.g. X^T X, X^T y in linreg)
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from ..core.executor import ExecutionStats, ScheduledExecutor, SchedulerConfig
from ..core.partitioners import chunk_schedule
from ..core.task import tasks_from_schedule

__all__ = ["VEE", "PipelineResult"]


@dataclass
class PipelineResult:
    """One VEE run: the combined value, the pool's stats, the measured
    seconds per task and the chunk table used."""

    value: Any
    stats: ExecutionStats
    per_task_costs: np.ndarray  # measured seconds per task (simulator calib)
    schedule: np.ndarray        # the (start, size) chunk table used


class VEE:
    """Vectorized execution engine bound to a SchedulerConfig."""

    def __init__(self, config: SchedulerConfig):
        self.config = config
        self._executor = ScheduledExecutor(config)

    def run(
        self,
        n_rows: int,
        op: Callable[[int, int], Any],
        combine: str = "concat",
        cost_of_range: Callable[[int, int], float] | None = None,
    ) -> PipelineResult:
        """Chunk rows [0, n_rows) with the configured technique, run ``op``
        on each chunk on the pool and combine the partials in chunk order
        (``concat`` row blocks, or ``sum`` left to right)."""
        cfg = self.config
        schedule = chunk_schedule(cfg.technique, n_rows, cfg.n_workers, seed=cfg.seed)

        timed: dict[int, float] = {}

        def timed_op(start, size):
            t0 = time.perf_counter()
            v = op(start, size)
            timed[start] = time.perf_counter() - t0
            return v

        tasks = tasks_from_schedule(schedule, timed_op, cost_of_range)
        results, stats = self._executor.run(tasks)

        ordered = [results[t.task_id] for t in tasks]
        if combine == "concat":
            value = np.concatenate(ordered, axis=0)
        elif combine == "sum":
            value = ordered[0]
            for v in ordered[1:]:
                value = value + v
        else:
            raise ValueError(f"unknown combine {combine!r}")

        costs = np.array([timed.get(int(s), 0.0) for s, _ in schedule])
        return PipelineResult(value, stats, costs, schedule)

    def measure_row_costs(self, n_rows: int, op, samples: int = 1) -> np.ndarray:
        """Per-row cost vector (for the simulator / offline auto-tuner):
        executes the op row-by-row on a subsample and interpolates."""
        costs = np.zeros(n_rows)
        for i in range(n_rows):
            t0 = time.perf_counter()
            for _ in range(samples):
                op(i, 1)
            costs[i] = (time.perf_counter() - t0) / samples
        return costs
