"""Pipeline-DAG runtime: DaphneSched over multi-stage IDA pipelines.

The paper schedules *integrated data analysis pipelines* — multi-stage
DM+HPC+ML workloads. A ``Stage`` is an operator over its own row range with
an optional per-stage SchedulerConfig (technique x layout x victim); a
``PipelineDAG`` is a validated, topologically ordered graph of stages.
``PipelineExecutor`` runs the whole DAG on ONE shared host worker pool with
inter-stage streaming: a completed chunk of a producer makes the
overlapping consumer chunks runnable *before* the producer's stage
barrier, so producer/consumer pairs and independent branches overlap on
the same workers. ``core/device_schedule.py:build_dag_tables`` freezes the
same graph into per-shard super-tables for the walker kernel instead.

Dependency kinds (``StageDep.kind``):

  ``full``         the consumer needs the producer's combined value; its
                   chunks become runnable only when the producer finishes.
  ``elementwise``  consumer rows [s, s+z) need only producer rows [s, s+z);
                   the producer must be row-shaped (combine='concat') with
                   the same row count. This is the streaming edge.

Stage ops have signature ``op(inputs, start, size)`` where ``inputs`` maps
each producer name to its output: the finalized value for ``full`` deps, or
the (partially filled) row buffer for ``elementwise`` deps — only rows
[start, start+size) are guaranteed complete in the latter.

Work assignment honours the per-stage config: CENTRALIZED stages share one
FIFO; PERCORE/PERGROUP stages deal chunks to per-worker / per-domain queues
and idle workers steal from victims in strategy order (paper C.2). Chunk
granularity always follows the stage's partitioning technique. After each
task a worker advances its stage cursor to the next stage in topological
order, which drains ready consumer chunks eagerly (streaming) and
interleaves independent branches.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from .executor import SchedulerConfig
from .online import OnlineChoice
from .partitioners import chunk_schedule
from .victim import make_victim_selector

__all__ = [
    "DEP_FULL", "DEP_ELEMENTWISE", "Stage", "StageDep", "PipelineDAG",
    "PipelineExecutor", "StageResult", "DagResult", "TaskEvent",
    "EventLog", "NullEventLog",
]

DEP_FULL = "full"
DEP_ELEMENTWISE = "elementwise"


@dataclass(frozen=True)
class StageDep:
    """A data dependency on ``producer``; see module docstring for kinds."""

    producer: str
    kind: str = DEP_FULL

    def __post_init__(self):
        if self.kind not in (DEP_FULL, DEP_ELEMENTWISE):
            raise ValueError(f"unknown dep kind {self.kind!r}")


@dataclass(frozen=True)
class Stage:
    """An operator with its own task range, cost model, and scheduler config.

    ``combine`` is 'concat' (partials are row blocks of an (n_rows, ...)
    output) or 'sum' (partials are additive reductions). Only 'concat'
    stages can be elementwise producers.
    """

    name: str
    n_rows: int
    op: Callable[[dict, int, int], Any] = field(compare=False, repr=False)
    combine: str = "concat"
    deps: tuple[StageDep, ...] = ()
    config: SchedulerConfig | None = None
    cost_of_range: Callable[[int, int], float] | None = field(
        compare=False, repr=False, default=None)

    def __post_init__(self):
        if self.combine not in ("concat", "sum"):
            raise ValueError(f"unknown combine {self.combine!r}")
        if self.n_rows < 0:
            raise ValueError("n_rows must be >= 0")


class PipelineDAG:
    """Validated, topologically-ordered stage graph."""

    def __init__(self, stages: list[Stage]):
        names = [s.name for s in stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names in {names}")
        self.stages: dict[str, Stage] = {s.name: s for s in stages}
        for s in stages:
            for d in s.deps:
                if d.producer not in self.stages:
                    raise ValueError(
                        f"stage {s.name!r} depends on unknown stage {d.producer!r}")
                prod = self.stages[d.producer]
                if d.kind == DEP_ELEMENTWISE:
                    if prod.combine != "concat":
                        raise ValueError(
                            f"elementwise dep {s.name!r}->{d.producer!r} needs a "
                            f"'concat' producer, got {prod.combine!r}")
                    if prod.n_rows != s.n_rows:
                        raise ValueError(
                            f"elementwise dep {s.name!r}->{d.producer!r} needs equal "
                            f"row counts ({s.n_rows} vs {prod.n_rows})")
        self.order: list[str] = self._toposort(stages)

    @staticmethod
    def _toposort(stages: list[Stage]) -> list[str]:
        indeg = {s.name: len(s.deps) for s in stages}
        consumers: dict[str, list[str]] = {s.name: [] for s in stages}
        for s in stages:
            for d in s.deps:
                consumers[d.producer].append(s.name)
        ready = deque(s.name for s in stages if indeg[s.name] == 0)
        order = []
        while ready:
            n = ready.popleft()
            order.append(n)
            for c in consumers[n]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
        if len(order) != len(stages):
            cyc = sorted(n for n, d in indeg.items() if d > 0)
            raise ValueError(f"dependency cycle through stages {cyc}")
        return order

    @property
    def stage_names(self) -> list[str]:
        """Stage names in topological order."""
        return list(self.order)


@dataclass(frozen=True)
class TaskEvent:
    """One executed chunk: timeline entry for ordering/overlap analysis.

    ``wait_s`` is the time the worker spent idle/contending between
    finishing its previous chunk and popping this one (the host-side
    queue-wait signal).
    """

    stage: str
    task_id: int
    start: int
    size: int
    worker: int
    t_start: float   # seconds since run() began
    t_end: float
    stolen: bool = False
    wait_s: float = 0.0


class EventLog:
    """Amortized event timeline: tuples on the hot path, events on read.

    The executors' record paths run under the pool lock, where a frozen
    dataclass construction (~1 us) per chunk is pure scheduler overhead;
    appending the field tuple costs ~0.1 us. The log stores those raw
    tuples and materializes ``cls`` instances lazily — the first len()/
    index/iteration after an append builds the event list once and caches
    it, so analysis code (tests, DagResult.stats) sees a normal sequence
    of TaskEvent objects while the worker loop never pays for them.
    ``iter_stat_tuples`` feeds ``stats_from_events`` without
    materializing anything.
    """

    __slots__ = ("_raw", "_mat", "cls", "_si", "_t0i", "_t1i", "_wi")

    def __init__(self, cls=None):
        cls = cls if cls is not None else TaskEvent
        self.cls = cls
        self._raw: list[tuple] = []
        self._mat: list | None = None
        names = [f.name for f in dataclasses.fields(cls)]
        self._si = names.index("stage")
        self._t0i = names.index("t_start")
        self._t1i = names.index("t_end")
        self._wi = names.index("wait_s") if "wait_s" in names else -1

    def append_raw(self, *fields) -> None:
        """Record one event as its positional field tuple (hot path)."""
        self._raw.append(fields)
        self._mat = None

    def append(self, ev) -> None:
        """Record an already-built event (slow path, checkpoint/restore)."""
        self._raw.append(dataclasses.astuple(ev))
        self._mat = None

    def _events(self) -> list:
        if self._mat is None:
            cls = self.cls
            self._mat = [cls(*t) for t in self._raw]
        return self._mat

    def __len__(self) -> int:
        return len(self._raw)

    def __bool__(self) -> bool:
        return bool(self._raw)

    def __iter__(self):
        return iter(self._events())

    def __getitem__(self, i):
        return self._events()[i]

    def iter_stat_tuples(self):
        """Yield (stage, exec_s, wait_s) per event straight off the raw
        tuples — the DagStats aggregation path (no materialization)."""
        si, t0i, t1i, wi = self._si, self._t0i, self._t1i, self._wi
        for t in self._raw:
            yield t[si], t[t1i] - t[t0i], (t[wi] if wi >= 0 else 0.0)


class NullEventLog(EventLog):
    """The opt-out: ``record_events=False`` hot paths append into this.

    Every append is a no-op, so runs that never read their timeline
    (throughput benchmarks, long-lived servers) pay nothing per chunk.
    """

    def append_raw(self, *fields) -> None:
        """No-op."""

    def append(self, ev) -> None:
        """No-op."""


@dataclass
class StageResult:
    """Per-stage outcome: combined value, realized schedule, measured costs."""

    value: Any
    schedule: np.ndarray        # (n_chunks, 2) (start, size) actually used
    per_task_costs: np.ndarray  # measured seconds per chunk
    config: SchedulerConfig
    t_first: float | None = None  # first chunk start (since run() began)
    t_last: float | None = None   # last chunk end


@dataclass
class DagResult:
    """Whole-DAG outcome: stage values/results, event timeline, pool stats.

    ``transfer_events`` and ``preemptions`` are the reference's uniform
    cross-engine surfaces; the port's engines leave them empty. ``stats``
    reads like the simulator's (``res.stats.total_exec_s`` on both).
    """

    values: dict[str, Any]
    stages: dict[str, StageResult]
    events: Any  # EventLog (lazy sequence of TaskEvent) or a plain list
    wall_time_s: float
    steals: int
    per_worker_busy_s: list[float]
    per_worker_tasks: list[int]
    transfer_events: list = field(default_factory=list)
    preemptions: list = field(default_factory=list)

    def span(self, stage: str) -> tuple[float, float]:
        """(first chunk start, last chunk end) of ``stage``, seconds from run start."""
        r = self.stages[stage]
        if r.t_first is None:
            return (0.0, 0.0)
        return (r.t_first, r.t_last)

    @property
    def stats(self):
        """Per-stage chunk accounting (a core.simulator.DagStats) built
        from the event timeline: measured exec seconds and queue waits,
        with ``transfer_events`` folded into the transfer columns."""
        from .simulator import stats_from_events
        st = stats_from_events(self.events)
        for ev in self.transfer_events:
            st.add_transfer(ev.consumer, ev.t_end - ev.t_start)
        return st

    def overlap_s(self, a: str, b: str) -> float:
        """Seconds during which stages ``a`` and ``b`` were both active."""
        a0, a1 = self.span(a)
        b0, b1 = self.span(b)
        return max(0.0, min(a1, b1) - max(a0, b0))


class _StageRun:
    """Mutable execution state of one stage (guarded by the runtime's lock).

    PipelineExecutor and core/preempt.py's PreemptiveRunner pop chunks
    via _try_pop and fold results back via record().
    """

    __slots__ = ("stage", "cfg", "schedule", "tasks", "queues", "home",
                 "selector", "row_done", "remaining", "out", "acc", "value",
                 "done", "costs", "executed", "resizes", "t_first", "t_last",
                 "has_deps")

    def __init__(self, stage: Stage, cfg: SchedulerConfig, domains: list[int]):
        self.stage = stage
        self.cfg = cfg
        self.schedule = chunk_schedule(cfg.technique, stage.n_rows,
                                       cfg.n_workers, seed=cfg.seed)
        self.tasks = [(i, int(s), int(z)) for i, (s, z) in enumerate(self.schedule)]
        layout = cfg.queue_layout.upper()
        if layout == "CENTRALIZED" or not self.tasks:
            self.queues = [deque()]
            self.home = [0] * cfg.n_workers
            self.selector = None
        elif layout == "PERCORE":
            self.queues = [deque() for _ in range(cfg.n_workers)]
            self.home = list(range(cfg.n_workers))
            self.selector = make_victim_selector(
                cfg.victim_strategy, cfg.n_workers, numa_domains=domains,
                seed=cfg.seed)
        elif layout == "PERGROUP":
            nq = max(domains) + 1
            self.queues = [deque() for _ in range(nq)]
            self.home = list(domains)
            self.selector = make_victim_selector(
                cfg.victim_strategy, nq, numa_domains=list(range(nq)),
                seed=cfg.seed)
        else:
            raise ValueError(f"unknown queue layout {cfg.queue_layout!r}")
        self._deal(self.tasks)
        self.row_done = np.zeros(stage.n_rows, dtype=bool)
        self.remaining = len(self.tasks)
        self.out: np.ndarray | None = None   # concat buffer
        self.acc: Any = None                 # sum accumulator
        self.value: Any = None
        self.done = self.remaining == 0
        self.costs = np.zeros(len(self.tasks))
        self.executed = np.zeros(len(self.tasks), dtype=bool)
        self.resizes = 0    # moldable interventions on THIS run (budget key)
        self.t_first: float | None = None
        self.t_last: float | None = None
        self.has_deps = bool(stage.deps)  # dep-less stages skip readiness checks

    def pending_chunks(self) -> list[tuple[int, int]]:
        """(start, size) of chunks dealt to queues but not yet popped."""
        return [(s, z) for q in self.queues for (_i, s, z) in q]

    def _deal(self, tasks) -> None:
        """Append task tuples to the queues per this stage's layout.

        One implementation serves the initial deal and every moldable
        re-deal: PERCORE deals the chunk sequence round-robin (mirroring
        DistributedQueues), PERGROUP pre-partitions the ROW space into
        contiguous per-domain blocks by each chunk's start row (spatial
        locality — decreasing techniques front-load the sequence with
        huge chunks, so position-based dealing would skew the groups).
        """
        nq = len(self.queues)
        if nq == 1:
            self.queues[0].extend(tasks)
        elif self.cfg.queue_layout.upper() == "PERCORE":
            for k, t in enumerate(tasks):
                self.queues[k % nq].append(t)
        else:  # PERGROUP
            for t in tasks:
                owner = min(nq - 1, t[1] * nq // max(1, self.stage.n_rows))
                self.queues[owner].append(t)

    def resize_remaining(self, new_chunks: list[tuple[int, int]]) -> int:
        """Replace every queued (unpopped) chunk with ``new_chunks``.

        The moldable-resizing hook (core/online.py): in-flight and
        completed chunks keep their ids; the queued remainder is dropped
        and re-dealt as fresh tasks covering exactly the same rows.
        Caller holds the runtime lock. Returns the change in outstanding
        task count, which the caller must fold into its own remaining
        totals.
        """
        queued = [t for q in self.queues for t in q]
        if sum(z for _, _, z in queued) != sum(int(z) for _, z in new_chunks):
            raise ValueError(
                f"stage {self.stage.name!r}: resize must cover exactly the "
                f"queued rows")
        for q in self.queues:
            q.clear()
        base = len(self.costs)
        tasks = [(base + k, int(s), int(z))
                 for k, (s, z) in enumerate(new_chunks)]
        self.schedule = np.vstack([
            np.asarray(self.schedule).reshape(-1, 2),
            np.array([[s, z] for _, s, z in tasks]),
        ]).astype(np.int32)
        self.costs = np.concatenate([self.costs, np.zeros(len(tasks))])
        self.executed = np.concatenate(
            [self.executed, np.zeros(len(tasks), dtype=bool)])
        self._deal(tasks)
        self.resizes += 1
        delta = len(tasks) - len(queued)
        self.remaining += delta
        return delta

    def record(self, task, value, dt, rel0, rel1) -> None:
        """Fold one completed chunk into the stage state (caller holds lock)."""
        i, s, z = task
        if self.stage.combine == "concat":
            v = np.asarray(value)
            if v.shape[:1] != (z,):
                raise ValueError(
                    f"stage {self.stage.name!r}: concat op must return "
                    f"(size, ...) rows, got shape {v.shape} for size {z}")
            if self.out is None:
                self.out = np.empty((self.stage.n_rows,) + v.shape[1:], v.dtype)
            self.out[s:s + z] = v
        else:
            self.acc = value if self.acc is None else self.acc + value
        self._account(task, dt, rel0, rel1)

    def _account(self, task, dt, rel0, rel1) -> None:
        """Mark one chunk run: its rows, cost, times and the stage's
        completion; the value is folded by the caller (lock held)."""
        i, s, z = task
        self.row_done[s:s + z] = True
        self.costs[i] = dt
        self.executed[i] = True
        self.t_first = rel0 if self.t_first is None else min(self.t_first, rel0)
        self.t_last = rel1 if self.t_last is None else max(self.t_last, rel1)
        self.remaining -= 1
        if self.remaining == 0:
            self.done = True
            self.value = self.out if self.stage.combine == "concat" else self.acc
            if not self.executed.all():
                # moldable resizes replaced some planned chunks: compact the
                # realized schedule/costs to the chunks that actually ran
                self.schedule = np.asarray(self.schedule).reshape(-1, 2)[self.executed]
                self.costs = self.costs[self.executed]


def _task_ready(sr: _StageRun, runs: dict[str, _StageRun], task) -> bool:
    """Is this chunk's every dependency satisfied (within one job's runs)?"""
    _, s, z = task
    for d in sr.stage.deps:
        p = runs[d.producer]
        if d.kind == DEP_FULL:
            if not p.done:
                return False
        elif not p.row_done[s:s + z].all():
            return False
    return True


def _try_pop(sr: _StageRun, runs: dict[str, _StageRun], wid: int):
    """Pop the next runnable chunk for worker ``wid`` (FIFO head of its
    home queue, else a victim's tail) — or (None, False).

    ``wid`` may exceed the pool the stage was dealt for (device walker
    lanes absorbing host chunks, in the reference's co-execution); such
    lanes adopt queue 0 as their home for both the pop and the victim
    order.
    """
    home = sr.home[wid] if len(sr.home) > wid else 0
    q = sr.queues[home]
    if sr.has_deps:
        if q and _task_ready(sr, runs, q[0]):
            return q.popleft(), False
        if sr.selector is not None:
            for v in sr.selector.candidates(home):
                vq = sr.queues[v]
                if vq and _task_ready(sr, runs, vq[-1]):
                    return vq.pop(), True
        return None, False
    # dep-less stage: every queued chunk is runnable — skip the per-pop
    # readiness walk entirely
    if q:
        return q.popleft(), False
    if sr.selector is not None:
        for v in sr.selector.candidates(home):
            vq = sr.queues[v]
            if vq:
                return vq.pop(), True
    return None, False


def _stage_inputs(sr: _StageRun, runs: dict[str, _StageRun]) -> dict:
    """Producer outputs visible to an op: finalized value (full deps) or the
    partially-filled row buffer (elementwise deps)."""
    return {d.producer: (runs[d.producer].value if d.kind == DEP_FULL
                         else runs[d.producer].out)
            for d in sr.stage.deps}


def _resolve_stage_config(base: SchedulerConfig, stage: Stage, override):
    """Layer per-stage overrides over ``base`` (pool shape always wins)."""
    chosen = override if override is not None else stage.config
    if chosen is None:
        return base
    if isinstance(chosen, tuple):
        t, l, v = chosen
        return dataclasses.replace(
            base, technique=t, queue_layout=l, victim_strategy=v)
    return dataclasses.replace(
        chosen, n_workers=base.n_workers, numa_domains=base.numa_domains)


class PipelineExecutor:
    """Run a PipelineDAG on one shared worker pool with streaming.

    ``config`` supplies the pool shape (n_workers, numa_domains, seed) and
    the default scheduling tuple. ``run(Submission(per_stage=...))``
    overrides the tuple per stage: values may be SchedulerConfig or a
    (technique, layout, victim) combo as produced by the auto-tuners;
    ``Stage.config`` takes precedence over the default but below
    ``per_stage``.

    ``Submission.online`` (a core.online.OnlineScheduler) closes the
    feedback loop: stages without an explicit ``per_stage`` override play the
    stage's bandit suggests for this run, every completed chunk streams
    into the online feedback log, the unpopped remainder of a stage is
    re-chunked mid-run when the scheduler's moldable resizer asks for it,
    and each stage's realized span is credited back to its bandit when the
    run ends — so repeated runs (pipeline iterations, serving rounds)
    converge onto the best observed configuration.
    """

    def __init__(self, dag: PipelineDAG, config: SchedulerConfig,
                 record_events: bool = True, tracer=None):
        from .telemetry import as_tracer
        self.dag = dag
        self.config = config
        self.record_events = record_events
        self.tracer = as_tracer(tracer)
        d = config.numa_domains
        self._domains = list(d) if d is not None else [0] * config.n_workers

    def run(self, sub=None) -> DagResult:
        """Execute every stage to completion on the shared pool.

        ``sub`` (a ``Submission``) carries the per-submission knobs:
        ``sub.dag`` (when set) replaces the constructor DAG for this run,
        ``sub.per_stage`` the per-stage overrides, ``sub.online`` the
        online scheduler.
        """
        if sub is not None:
            from .submit import as_submission

            sub = as_submission(sub)
            if sub.dag is not None and sub.dag is not self.dag:
                return PipelineExecutor(sub.dag, self.config).run(
                    sub.replace(dag=None))
            return self._run(dict(sub.per_stage or {}), sub.online)
        return self._run({}, None)

    def _run(self, overrides: dict, online) -> DagResult:
        """The execution loop with resolved overrides/online scheduler."""
        choices: dict[str, OnlineChoice] = {}
        if online is not None:
            for name in self.dag.order:
                # explicit per_stage / Stage.config pins always win over
                # the bandit
                if name not in overrides and self.dag.stages[name].config is None:
                    ch = online.suggest(name)
                    choices[name] = ch
                    overrides[name] = ch.combo
        runs = {name: _StageRun(
                    self.dag.stages[name],
                    _resolve_stage_config(self.config, self.dag.stages[name],
                                          overrides.get(name)),
                    self._domains)
                for name in self.dag.order}
        order = [runs[n] for n in self.dag.order]
        nstages = len(order)
        n_workers = self.config.n_workers
        cond = threading.Condition()
        remaining_total = sum(sr.remaining for sr in order)
        events = EventLog() if self.record_events else NullEventLog()
        tracer = self.tracer
        traced = tracer.enabled
        tjob = tracer.job
        errors: list[BaseException] = []
        busy = [0.0] * n_workers
        ntasks = [0] * n_workers
        steals = [0]
        t0_run = time.perf_counter()

        def record(sr: _StageRun, task, value, dt, wid, rel0, rel1, stolen,
                   wait_s=0.0):
            """Fold a chunk into its stage and the run-wide stats (lock held)."""
            nonlocal remaining_total
            i, s, z = task
            sr.record(task, value, dt, rel0, rel1)
            remaining_total -= 1
            events.append_raw(sr.stage.name, i, s, z, wid, rel0, rel1,
                              stolen, wait_s)
            if traced:
                tracer.record_raw("exec", tjob, sr.stage.name, i, wid,
                                  rel0, rel1, 1 if stolen else 0, wait_s)
            busy[wid] += dt
            ntasks[wid] += 1
            steals[0] += int(stolen)
            if online is not None:
                online.record_raw(sr.stage.name, z, dt)
                if not sr.done and online.may_resize(sr.stage.name, sr.resizes):
                    plan = online.plan_resize(
                        sr.stage.name, sr.pending_chunks(), n_workers,
                        resizes_done=sr.resizes)
                    if plan:
                        remaining_total += sr.resize_remaining(plan)
                        if traced:
                            tracer.mark("resize", rel1, tjob, sr.stage.name,
                                        detail=f"chunks={len(plan)}")

        def worker(wid: int) -> None:
            """Pool thread: rotate over stages, pop runnable chunks, execute."""
            cursor = wid % nstages
            while True:
                sr = task = None
                stolen = False
                t_idle = time.perf_counter()
                with cond:
                    while True:
                        if errors or remaining_total == 0:
                            return
                        for k in range(nstages):
                            idx = (cursor + k) % nstages
                            cand = order[idx]
                            if cand.remaining == 0:
                                continue
                            got, stolen = _try_pop(cand, runs, wid)
                            if got is not None:
                                sr, task = cand, got
                                # advance past this stage: drains ready
                                # consumers next (streaming) and interleaves
                                # branches.
                                cursor = (idx + 1) % nstages
                                break
                        if task is not None:
                            break
                        cond.wait(timeout=0.05)
                    inputs = _stage_inputs(sr, runs)
                _, s, z = task
                t0 = time.perf_counter()
                try:
                    value = sr.stage.op(inputs, s, z)
                    t1 = time.perf_counter()
                    with cond:
                        record(sr, task, value, t1 - t0, wid,
                               t0 - t0_run, t1 - t0_run, stolen,
                               t0 - t_idle)
                        cond.notify_all()
                except BaseException as e:  # surfaced to the caller below
                    with cond:
                        errors.append(e)
                        cond.notify_all()
                    return

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(n_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        wall = time.perf_counter() - t0_run
        if online is not None:
            for name, ch in choices.items():
                sr = runs[name]
                span = ((sr.t_last - sr.t_first)
                        if sr.t_first is not None else 0.0)
                # per-ROW span: rewards stay comparable when the same
                # scheduler serves differently-sized runs of a stage
                rows = max(1, sr.stage.n_rows)
                online.observe(ch, (span if span > 0 else wall) / rows)

        stage_results = {
            name: StageResult(value=sr.value, schedule=sr.schedule,
                              per_task_costs=sr.costs, config=sr.cfg,
                              t_first=sr.t_first, t_last=sr.t_last)
            for name, sr in runs.items()
        }
        return DagResult(
            values={n: r.value for n, r in stage_results.items()},
            stages=stage_results, events=events, wall_time_s=wall,
            steals=steals[0], per_worker_busy_s=busy, per_worker_tasks=ntasks)
