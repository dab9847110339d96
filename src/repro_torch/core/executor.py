"""Threaded shared-memory executor: DaphneSched's worker management.

Runs RangeTasks on ``n_workers`` Python threads with either a centralized
queue (self-scheduling) or distributed queues (work-stealing with a victim
selection strategy). numpy/PyTorch ops release the GIL, so compute-bound tasks
execute with real parallelism on multicore hosts.

Results are combined by the caller (VEE) — each task returns
``(task_id, value)``; the executor guarantees every task runs exactly once
(tested in tests/test_torch_host.py).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from .online import ChunkObservation
from .partitioners import make_partitioner
from .queues import (CentralizedQueue, DistributedQueues, QUEUE_IMPLS,
                     SlotCentralizedQueue, SlotDistributedQueues)
from .task import RangeTask
from .victim import make_victim_selector

__all__ = ["SchedulerConfig", "ExecutionStats", "ScheduledExecutor"]


@dataclass(frozen=True)
class SchedulerConfig:
    """User-facing scheduling knobs (the paper's two independent axes).

    ``queue_impl`` selects the queue machinery behind the layout: "slot"
    (preallocated slot-array queues on numpy index buffers, DESIGN.md §16)
    or "deque" (the original lock-guarded deques, kept as the differential
    reference). Both produce identical pop/steal sequences; this is a
    pool/runtime property, so executors take it from the pool config even
    for stages that override everything else.
    """

    technique: str = "STATIC"         # work partitioning (11 options)
    queue_layout: str = "CENTRALIZED"  # CENTRALIZED | PERCORE | PERGROUP
    victim_strategy: str = "SEQ"       # SEQ | SEQPRI | RND | RNDPRI
    n_workers: int = 4
    numa_domains: tuple[int, ...] | None = None  # one domain id per worker
    seed: int = 0
    queue_impl: str = "slot"           # slot | deque (DESIGN.md §16)

    def __post_init__(self):
        if self.queue_impl not in QUEUE_IMPLS:
            raise ValueError(
                f"unknown queue_impl {self.queue_impl!r}; options: {QUEUE_IMPLS}")


@dataclass
class ExecutionStats:
    """Per-run counters: wall time, per-worker load, steal/contention stats."""

    wall_time_s: float = 0.0
    per_worker_tasks: list[int] = field(default_factory=list)
    per_worker_busy_s: list[float] = field(default_factory=list)
    steals: int = 0
    failed_steals: int = 0
    contended_pops: int = 0
    # queue-access (lock round-trip) count: CentralizedQueue pops, or
    # pop_local + steal attempts under PERCORE/PERGROUP — the pop-traffic
    # axis on which queue layouts are compared.
    queue_pops: int = 0
    # total measured queue wait (idle-to-next-task gaps summed over
    # workers) — populated identically on the slot and deque impls so the
    # differential tests can compare them.
    queue_wait_s: float = 0.0

    @property
    def load_imbalance(self) -> float:
        """(max - mean) / max of per-worker busy time (0 = perfectly balanced)."""
        if not self.per_worker_busy_s or max(self.per_worker_busy_s) == 0:
            return 0.0
        mx = max(self.per_worker_busy_s)
        mean = sum(self.per_worker_busy_s) / len(self.per_worker_busy_s)
        return (mx - mean) / mx


class ScheduledExecutor:
    """Execute a task list under a SchedulerConfig; collect results + stats.

    ``observer`` hooks the worker record path into the online feedback
    loop (core/online.py): any object with a ``record(ChunkObservation)``
    method — an OnlineScheduler or a bare FeedbackLog — or a callable
    taking a ChunkObservation receives every completed task's measured
    cost as it lands. ``observer_stage`` names the stage in those
    observations (flat batches have no DAG stage of their own).
    """

    def __init__(self, config: SchedulerConfig, observer=None,
                 observer_stage: str = "flat", tracer=None):
        from .telemetry import as_tracer

        self.config = config
        d = config.numa_domains
        self._domains = list(d) if d is not None else [0] * config.n_workers
        self._observe = (observer.record if hasattr(observer, "record")
                         else observer)
        self._observer_stage = observer_stage
        self.tracer = as_tracer(tracer)

    def run(self, tasks: list[RangeTask]) -> tuple[dict[int, object], ExecutionStats]:
        """Run ``tasks`` to completion; returns ({task_id: value}, stats)."""
        cfg = self.config
        results: dict[int, object] = {}
        res_lock = threading.Lock()
        stats = ExecutionStats(
            per_worker_tasks=[0] * cfg.n_workers,
            per_worker_busy_s=[0.0] * cfg.n_workers,
        )

        tracer = self.tracer
        traced = tracer.enabled
        tjob = tracer.job

        def record(worker_id: int, task: RangeTask,
                   wait_s: float = 0.0, stolen: bool = False) -> None:
            """Run one task and fold its result/stats in (worker thread)."""
            t0 = time.perf_counter()
            value = task.run()
            t1 = time.perf_counter()
            dt = t1 - t0
            with res_lock:
                results[task.task_id] = value
                stats.per_worker_tasks[worker_id] += 1
                stats.per_worker_busy_s[worker_id] += dt
                stats.queue_wait_s += wait_s
                if self._observe is not None:
                    self._observe(ChunkObservation(
                        self._observer_stage, task.task_id, task.start,
                        task.size, dt, worker_id, t1 - t_start))
            if traced:
                tracer.record_raw("exec", tjob, self._observer_stage,
                                  task.task_id, worker_id, t0 - t_start,
                                  t1 - t_start, 1 if stolen else 0, wait_s)

        t_start = time.perf_counter()
        slot = cfg.queue_impl == "slot"
        if cfg.queue_layout.upper() == "CENTRALIZED":
            if slot:
                queue = SlotCentralizedQueue(tasks, cfg.technique,
                                             cfg.n_workers, seed=cfg.seed)

                def worker(worker_id: int) -> None:
                    """Drain chunk ranges off the slot-array queue."""
                    t_idle = time.perf_counter()
                    while True:
                        h, e = queue.pop_range(worker_id)
                        if h == e:
                            return
                        wait = time.perf_counter() - t_idle
                        for t in tasks[h:e]:
                            record(worker_id, t, wait)
                            wait = 0.0
                        t_idle = time.perf_counter()
            else:
                part = make_partitioner(cfg.technique, len(tasks),
                                        cfg.n_workers, seed=cfg.seed)
                queue = CentralizedQueue(tasks, part)

                def worker(worker_id: int) -> None:
                    """Drain technique-sized chunks off the shared queue."""
                    t_idle = time.perf_counter()
                    while True:
                        chunk = queue.pop(worker_id)
                        if not chunk:
                            return
                        wait = time.perf_counter() - t_idle
                        for t in chunk:
                            record(worker_id, t, wait)
                            wait = 0.0
                        t_idle = time.perf_counter()

            self._run_threads(worker, cfg.n_workers)
            stats.contended_pops = queue.contended_pops
            stats.queue_pops = queue.pops
        else:
            cls = SlotDistributedQueues if slot else DistributedQueues
            queues = cls(
                tasks, cfg.technique, cfg.n_workers,
                layout=cfg.queue_layout, groups=self._domains, seed=cfg.seed,
            )
            selector = make_victim_selector(
                cfg.victim_strategy, queues.n_queues,
                numa_domains=(self._domains if cfg.queue_layout.upper() == "PERCORE"
                              else list(range(queues.n_queues))),
                seed=cfg.seed,
            )
            if slot:
                table = queues.task_table()

                def worker(worker_id: int) -> None:
                    """Drain the home queue in index space; steal by moving
                    the victim's tail run into the home buffer (one int32
                    copy, no task materialization on the queue op)."""
                    home = queues.owner_of(worker_id)
                    t_idle = time.perf_counter()
                    just_stole = False
                    while True:
                        got = queues.pop_local_idx(worker_id)
                        if len(got):
                            wait = time.perf_counter() - t_idle
                            for i in got:
                                record(worker_id, table[i], wait, just_stole)
                                wait = 0.0
                            t_idle = time.perf_counter()
                            just_stole = False
                            continue
                        moved = 0
                        for victim in selector.candidates(home):
                            moved = queues.steal_to_home(worker_id, victim)
                            if moved:
                                break
                        if not moved:
                            return  # global exhaustion
                        just_stole = True
            else:
                def worker(worker_id: int) -> None:
                    """Drain the home queue chunk-wise, then steal in victim order."""
                    home = queues.owner_of(worker_id)
                    t_idle = time.perf_counter()
                    just_stole = False
                    while True:
                        chunk = queues.pop_local(worker_id)
                        if chunk:
                            wait = time.perf_counter() - t_idle
                            for t in chunk:
                                record(worker_id, t, wait, just_stole)
                                wait = 0.0
                            t_idle = time.perf_counter()
                            just_stole = False
                            continue
                        # out of local work: steal (victim order per strategy)
                        stolen: list[RangeTask] = []
                        for victim in selector.candidates(home):
                            stolen = queues.steal(worker_id, victim)
                            if stolen:
                                break
                        if not stolen:
                            return  # global exhaustion
                        queues.push_local(worker_id, stolen)
                        just_stole = True

            self._run_threads(worker, cfg.n_workers)
            stats.steals = queues.steals
            stats.failed_steals = queues.failed_steals
            stats.queue_pops = (queues.local_pops + queues.steals
                                + queues.failed_steals)

        stats.wall_time_s = time.perf_counter() - t_start
        if len(results) != len(tasks):
            missing = [t.task_id for t in tasks if t.task_id not in results]
            raise RuntimeError(f"executor lost tasks: {missing[:8]}... ({len(missing)} missing)")
        return results, stats

    @staticmethod
    def _run_threads(fn, n: int) -> None:
        threads = [threading.Thread(target=fn, args=(i,), daemon=True) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
