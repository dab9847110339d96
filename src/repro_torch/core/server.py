"""Multi-tenant pipeline serving runtime.

The port's copy of the reference's ``core/server.py``: the job level above
the pipeline-DAG runtime, so many IDA pipelines from many tenants share
ONE worker pool:

  ``Job``            a PipelineDAG plus serving metadata: priority, tenant,
                     fair-share weight, arrival offset, optional deadline,
                     per-stage scheduling overrides, and (for virtual-time
                     replay) per-stage cost vectors.
  ``PipelineServer`` admits many Jobs onto ONE shared worker pool. Each
                     job's stages keep their own queues/techniques (intra-job
                     scheduling stays pure DaphneSched); an inter-job
                     *arbiter* decides which job a free worker serves next.
  ``Arbiter``        the pluggable inter-job policy. Three built-ins:

    fifo       head-of-line FCFS — only the oldest unfinished job is served
               (the one-pipeline-at-a-time regime; idles workers at that
               job's stage barriers and straggler tails).
    priority   strict priority (higher ``Job.priority`` first), backfilling
               lower priorities only when no higher-priority chunk is
               runnable, with an optional starvation guard: a job unserved
               for ``starve_after_s`` jumps the priority order for one chunk.
    fair       weighted-fair sharing by tenant: the next chunk goes to the
               backlogged tenant with the least service/weight (start-time
               fair queueing on the chunk timeline), FIFO within a tenant.
               Tenants resume from the current minimum after idling (no
               banked credit).

``core/preempt.py:PreemptiveArbiter`` (``"preemptive"``) wraps any of them
with deadline-pressure eviction. ``core/simulator.py:simulate_server``
replays the same arbiters in virtual time for policy search,
``core/autotune.py:select_offline_server`` tunes per-job stage configs
under contention, and ``core/admission.py:FrontDoor`` puts admission and
batching in front of this pool.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from .dag import (
    DEP_FULL,
    EventLog,
    NullEventLog,
    PipelineDAG,
    _resolve_stage_config,
    _stage_inputs,
    _StageRun,
    _try_pop,
)
from .executor import SchedulerConfig
from .hetero import (at_frontier, pop_device_run, pop_device_task, run_spans,
                     run_tasks, split_device_tasks, steal_device_tail)

__all__ = [
    "Job", "JobState", "JobResult", "ServerResult", "ServerTaskEvent",
    "Arbiter", "FifoArbiter", "PriorityArbiter", "FairShareArbiter",
    "ARBITERS", "make_arbiter", "PipelineServer", "job_stage_costs",
]


@dataclass(frozen=True)
class Job:
    """One admitted pipeline: a PipelineDAG plus serving metadata.

    ``priority`` orders jobs under the strict-priority arbiter (larger =
    more urgent). ``tenant``/``weight`` drive weighted-fair sharing (jobs of
    one tenant should carry the tenant's weight). ``arrival_s`` is the
    job's arrival offset from serve start (real seconds for PipelineServer,
    virtual seconds for simulate_server). ``per_stage`` overrides stage
    scheduling as in PipelineExecutor. ``stage_costs`` (stage -> per-row
    cost vector) feeds virtual-time replay; stages without an entry fall
    back to ``Stage.cost_of_range``, else unit costs.
    """

    name: str
    dag: PipelineDAG = field(compare=False)
    priority: int = 0
    tenant: str = "default"
    weight: float = 1.0
    arrival_s: float = 0.0
    deadline_s: float | None = None
    per_stage: dict[str, SchedulerConfig | tuple[str, str, str]] | None = \
        field(compare=False, default=None)
    stage_costs: dict[str, np.ndarray] | None = field(compare=False, default=None)

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"job {self.name!r}: weight must be > 0")


def job_stage_costs(job: Job) -> dict[str, np.ndarray]:
    """Per-row cost vectors for every stage of ``job`` (simulation inputs)."""
    out: dict[str, np.ndarray] = {}
    for name in job.dag.stage_names:
        st = job.dag.stages[name]
        given = (job.stage_costs or {}).get(name)
        if given is not None:
            costs = np.asarray(given, dtype=float)
            if len(costs) != st.n_rows:
                raise ValueError(
                    f"job {job.name!r} stage {name!r}: {len(costs)} costs "
                    f"for {st.n_rows} rows")
        elif st.cost_of_range is not None:
            costs = np.array([st.cost_of_range(i, 1) for i in range(st.n_rows)],
                             dtype=float)
        else:
            costs = np.ones(st.n_rows)
        out[name] = costs
    return out


@dataclass
class JobState:
    """Arbiter-visible accounting for one admitted job.

    Shared by the threaded server and the virtual-time simulator: arbiters
    order these and are charged through them, so a policy behaves
    identically under both clocks.
    """

    job: Job
    seq: int                       # submission order (FIFO tie-break)
    arrival: float
    service: float = 0.0           # accumulated busy seconds
    last_service: float | None = None
    boosted: bool = False          # starvation guard fired at the last order
    done: bool = False
    finish: float | None = None
    preempted: bool = False        # parked by a preemptive arbiter


class Arbiter:
    """Inter-job scheduling policy: ranks admitted jobs for the next pop.

    ``order`` returns the admitted unfinished jobs most-preferred first; a
    worker tries jobs in that order and takes the first runnable chunk
    (returning a prefix restricts backfilling — FIFO returns only the
    head). ``charge`` observes ``dt`` seconds of service done for a job at
    time ``now``; both clocks are seconds since serve start.
    """

    name = "base"

    def order(self, jobs: list[JobState], now: float) -> list[JobState]:
        """Rank ``jobs`` (admitted, unfinished) most-preferred first."""
        raise NotImplementedError

    def charge(self, js: JobState, dt: float, now: float) -> None:
        """Account ``dt`` seconds of service delivered to ``js``."""
        js.service += dt
        js.last_service = now


class FifoArbiter(Arbiter):
    """Head-of-line FCFS: only the oldest unfinished job is ever served.

    The one-pipeline-at-a-time baseline: workers idle whenever the head
    job's runnable chunks run out (stage barriers, straggler tails) even if
    later jobs have work — exactly the capacity loss the concurrent
    arbiters exist to recover.
    """

    name = "fifo"

    def order(self, jobs: list[JobState], now: float) -> list[JobState]:
        """Return just the head job (earliest arrival, then submit order)."""
        if not jobs:
            return []
        return [min(jobs, key=lambda j: (j.arrival, j.seq))]


class PriorityArbiter(Arbiter):
    """Strict priority with an optional starvation guard.

    Higher ``Job.priority`` is served first; equal priorities run FCFS.
    Lower-priority chunks run only when no higher-priority chunk is
    runnable (backfilling at barriers). With ``starve_after_s`` set, a job
    unserved for that long jumps the order for one chunk (its events carry
    ``boosted=True``), bounding starvation under a saturating
    high-priority stream.
    """

    name = "priority"

    def __init__(self, starve_after_s: float | None = None):
        self.starve_after_s = starve_after_s

    def order(self, jobs: list[JobState], now: float) -> list[JobState]:
        """Rank by (starving, -priority, arrival, seq)."""
        for js in jobs:
            waited = now - (js.last_service if js.last_service is not None
                            else js.arrival)
            js.boosted = (self.starve_after_s is not None
                          and waited > self.starve_after_s)
        return sorted(jobs, key=lambda js: (not js.boosted, -js.job.priority,
                                            js.arrival, js.seq))


class FairShareArbiter(Arbiter):
    """Weighted-fair sharing by tenant (start-time fair queueing).

    Every tenant accumulates normalized service ``v = service / weight``;
    the next chunk goes to the backlogged tenant with the smallest ``v``,
    FIFO within the tenant. While two tenants stay backlogged their
    normalized-service gap is bounded by the largest chunk cost times
    ``(1/w_i + 1/w_j)`` per concurrent worker (property-tested in
    the reference's tests/test_server.py). A tenant (re)joining after idle
    time resumes from the current backlogged minimum, so idling banks no
    credit.
    """

    name = "fair"

    def __init__(self):
        self._v: dict[str, float] = {}
        self._active: set[str] = set()

    def order(self, jobs: list[JobState], now: float) -> list[JobState]:
        """Rank by (tenant normalized service, arrival, seq)."""
        present = {js.job.tenant for js in jobs}
        carried = [self._v[t] for t in (present & self._active) if t in self._v]
        floor = min(carried, default=0.0)
        for t in present:
            if t in self._active and t in self._v:
                continue  # continuously backlogged: keep its v
            self._v[t] = max(self._v.get(t, 0.0), floor)
        self._active = present
        return sorted(jobs, key=lambda js: (self._v[js.job.tenant],
                                            js.arrival, js.seq))

    def charge(self, js: JobState, dt: float, now: float) -> None:
        """Charge the job and advance its tenant's normalized service."""
        super().charge(js, dt, now)
        self._v[js.job.tenant] = self._v.get(js.job.tenant, 0.0) + dt / js.job.weight


ARBITERS = {"fifo": FifoArbiter, "priority": PriorityArbiter,
            "fair": FairShareArbiter}


def make_arbiter(spec: str | Arbiter, **kwargs) -> Arbiter:
    """Instantiate an arbiter from a name in ARBITERS (or pass one through).

    Arbiters carry accounting state — build a fresh one per serve/simulate
    call (passing a name does this for you).
    """
    if isinstance(spec, Arbiter):
        return spec
    if spec.lower() not in ARBITERS:
        from . import preempt  # noqa: F401  registers "preemptive"

        del preempt
    try:
        return ARBITERS[spec.lower()](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown arbiter {spec!r}; options: {sorted(ARBITERS)}") from None


@dataclass(frozen=True)
class ServerTaskEvent:
    """One executed chunk on the serving timeline (job-level TaskEvent).

    ``wait_s`` is the lane's idle/contention time between finishing its
    previous chunk and starting this one — the host-queue-wait signal
    ``stats_from_events`` aggregates.
    """

    job: str
    tenant: str
    stage: str
    task_id: int
    start: int
    size: int
    worker: int
    t_start: float   # seconds since serve() began
    t_end: float
    stolen: bool = False
    boosted: bool = False  # starvation guard lifted this job past priority
    wait_s: float = 0.0


@dataclass
class JobResult:
    """Per-job outcome: stage values plus latency/deadline accounting."""

    name: str
    values: dict[str, Any]
    arrival_s: float
    finish_s: float
    latency_s: float
    service_s: float
    n_tasks: int
    deadline_met: bool | None = None  # None when the job had no deadline


@dataclass
class ServerResult:
    """Outcome of one PipelineServer.serve drain."""

    jobs: dict[str, JobResult]
    events: list[ServerTaskEvent]
    wall_time_s: float
    makespan_s: float              # last finish minus first arrival
    per_worker_busy_s: list[float]
    per_worker_tasks: list[int]
    steals: int
    tenant_service_s: dict[str, float]
    preemptions: list = field(default_factory=list)  # PreemptionEvents
    transfer_events: list = field(default_factory=list)  # TransferEvents

    def latencies(self) -> dict[str, float]:
        """Job name -> latency (finish minus arrival) in seconds."""
        return {n: r.latency_s for n, r in self.jobs.items()}

    def latency_percentile(self, q: float) -> float:
        """Percentile ``q`` (0-100) over per-job latencies."""
        return float(np.percentile(list(self.latencies().values()), q))

    @property
    def stats(self):
        """Per-stage chunk accounting (core.simulator.DagStats) across
        every job, transfers folded in — the same surface DagResult and
        the simulators expose."""
        from .simulator import stats_from_events
        st = stats_from_events(self.events)
        for ev in self.transfer_events:
            st.add_transfer(ev.consumer, ev.t_end - ev.t_start)
        return st


class PipelineServer:
    """Serve many pipeline Jobs concurrently on one shared worker pool.

    ``config`` supplies the pool shape (n_workers, numa_domains, seed) and
    the default per-stage scheduling tuple; each job's ``per_stage`` (or
    its stages' own configs) override it exactly as in PipelineExecutor.
    ``arbiter`` is a name in ARBITERS or an Arbiter instance;
    ``arbiter_kwargs`` are forwarded when a name is given.

    ``serve(jobs)`` blocks until every job drains and returns a
    ServerResult. Job ``arrival_s`` offsets are honoured in real time:
    workers never touch a job before it arrives.

    ``online`` (a core.online.OnlineScheduler) closes the feedback loop
    across jobs: each job's stage runs are built *lazily*, in topological
    order, the first time the stage could have a runnable chunk — and the
    build re-consults the stage's bandit right then, so chunk times
    observed from earlier jobs (and earlier stages of this job) retune the
    configs later stages play. Explicit ``Job.per_stage`` / ``Stage.config``
    entries stay authoritative; completed chunks stream into the online
    feedback log and stage remainders resize mid-run exactly as in
    PipelineExecutor.

    ``Submission.placement`` (a core.placement.Placement) routes that
    job's stages across the substrates under contention: a stage's
    device rows are carved into shard deques drained by ``n_device``
    walker lanes shared by ALL jobs (arbiter order decides whose device
    work runs next, exactly as for host chunks), while host workers keep
    the stage's host rows. Idle host workers absorb device tails and
    drained device lanes absorb host chunks (core/hetero.py), so a
    placement tuned for an idle machine cannot strand capacity when the
    pool is contended. Jobs without an entry run host-only. A job whose
    submission carries its DAG's ``lowering`` has its device rows walked
    on the walker, a run of a shard's head slots a launch
    (``core.hetero.pop_device_run``); otherwise a lane runs the host op.

    Sum stages fold their chunk partials in ascending row order
    (``core/preempt.py:PreemptableStageRun``), where the reference folds
    them in completion order: a job's values then depend only on its chunk
    boundaries, not on which lane ran which chunk, so a job is bitwise its
    solo ``HeteroExecutor`` run (and, with technique ``SS`` on a tile-unit
    DAG, the host-only one-worker run) however the pool is contended.
    """

    def __init__(self, config: SchedulerConfig,
                 arbiter: str | Arbiter = "fair",
                 arbiter_kwargs: dict | None = None,
                 online=None,
                 n_device: int = 1,
                 record_events: bool = True,
                 tracer=None,
                 metrics=None):
        from .telemetry import as_tracer
        self.config = config
        d = config.numa_domains
        self._domains = list(d) if d is not None else [0] * config.n_workers
        self._arbiter_spec = arbiter
        self._arbiter_kwargs = dict(arbiter_kwargs or {})
        self._online = online
        self._n_device = max(1, n_device)
        self.record_events = record_events
        self.tracer = as_tracer(tracer)
        self.metrics = metrics
        self._queued: list = []

    def submit(self, sub) -> None:
        """Queue one Submission for the next drain."""
        from .submit import as_submission

        self._queued.append(as_submission(sub, surface="PipelineServer.submit"))

    def serve(self, jobs=None) -> ServerResult:
        """Run the pool until every admitted job completes.

        ``jobs`` is a list of Submissions; omitted, the drain takes
        everything queued via ``submit``. Per-submission ``placement``
        routes that job across substrates; a per-submission ``online``
        scheduler is honoured when the pool was built without one (all
        submissions carrying one must share it).
        """
        from .preempt import PreemptableStageRun
        from .submit import as_submission

        if jobs is None:
            subs = self._queued
            self._queued = []
        else:
            subs = [as_submission(j, surface="PipelineServer.serve")
                    for j in jobs]
        placement = {}
        lowerings = {}
        online = self._online
        for s in subs:
            if s.placement is not None:
                placement[s.name] = s.placement
            if s.lowering is not None:
                lowerings[s.name] = s.lowering
            if s.online is not None:
                if online is not None and online is not s.online:
                    raise ValueError(
                        f"submission {s.name!r} carries an online scheduler "
                        "that conflicts with the pool's")
                online = s.online
        jobs = [s.to_job() for s in subs]
        names = [j.name for j in jobs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate job names in {names}")
        arbiter = make_arbiter(self._arbiter_spec, **self._arbiter_kwargs)
        states = [JobState(job=j, seq=i, arrival=float(j.arrival_s))
                  for i, j in enumerate(jobs)]
        runs: dict[str, dict[str, _StageRun]] = {}
        stage_order: dict[str, list[_StageRun]] = {}
        job_left: dict[str, int] = {}
        job_unbuilt: dict[str, int] = {}
        per_job = {j.name: dict(j.per_stage or {}) for j in jobs}
        choices: dict[tuple[str, str], object] = {}

        n_workers = self.config.n_workers
        n_device = self._n_device if placement else 0
        n_lanes = n_workers + n_device
        cond = threading.Condition()
        total_left = [0]    # outstanding tasks in BUILT stage runs
        unbuilt = [0]       # stage runs not built yet (lazy/online mode)
        events = (EventLog(ServerTaskEvent) if self.record_events
                  else NullEventLog(ServerTaskEvent))
        tracer = self.tracer
        errors: list[BaseException] = []
        busy = [0.0] * n_lanes
        ntasks = [0] * n_lanes
        job_tasks = {j.name: 0 for j in jobs}
        job_end = {j.name: 0.0 for j in jobs}
        steals = [0]
        cursors: dict[tuple[int, int], int] = {}
        device_qs: dict[tuple[str, str], list] = {}  # (job, stage) -> shards

        def build_stage(job: Job, name: str) -> _StageRun:
            """Materialize one stage run (lock held in lazy mode).

            In online mode this is where the arbiter-driven drain
            re-consults the selector: the bandit picks the stage's combo
            with all feedback observed so far, unless the job or stage
            pins an explicit config.
            """
            stage = job.dag.stages[name]
            override = per_job[job.name].get(name)
            if online is not None and override is None and stage.config is None:
                ch = online.suggest(name)
                choices[(job.name, name)] = ch
                override = ch.combo
            sr = PreemptableStageRun(
                stage, _resolve_stage_config(self.config, stage, override),
                self._domains)
            pl = placement.get(job.name)
            if pl is not None:
                k = pl.device_rows(name, stage.n_rows)
                shards, _ = split_device_tasks(sr, k, max(1, n_device))
                if k > 0:
                    device_qs[(job.name, name)] = shards
            runs[job.name][name] = sr
            stage_order[job.name].append(sr)
            job_unbuilt[job.name] -= 1
            unbuilt[0] -= 1
            job_left[job.name] += sr.remaining
            total_left[0] += sr.remaining
            return sr

        def buildable(js: JobState, idx: int) -> bool:
            """May stage #idx (topo order) of this job be built yet?

            Build when the stage could plausibly have a runnable head
            chunk: full-dep producers finished, elementwise producers have
            produced at least one chunk. Building in topological order
            guarantees every producer run already exists.
            """
            stage = js.job.dag.stages[js.job.dag.order[idx]]
            jruns = runs[js.job.name]
            for d in stage.deps:
                p = jruns[d.producer]
                if d.kind == DEP_FULL:
                    if not p.done:
                        return False
                elif p.stage.n_rows > 0 and p.t_first is None and not p.done:
                    return False
            return True

        lazy = online is not None
        for j in jobs:
            runs[j.name] = {}
            stage_order[j.name] = []
            job_left[j.name] = 0
            job_unbuilt[j.name] = len(j.dag.order)
            unbuilt[0] += len(j.dag.order)
            if not lazy:
                for name in j.dag.order:
                    build_stage(j, name)
        t0_run = time.perf_counter()

        def finish_job(js: JobState, finish: float) -> None:
            """Mark a drained job done; credit its bandit choices (lock held)."""
            js.done = True
            js.finish = finish
            if online is not None:
                for sr in stage_order[js.job.name]:
                    ch = choices.pop((js.job.name, sr.stage.name), None)
                    if ch is not None:
                        span = ((sr.t_last - sr.t_first)
                                if sr.t_first is not None else 0.0)
                        # per-ROW span: a 10x-larger job must not make its
                        # arm look 10x worse than one played on a small job
                        rows = max(1, sr.stage.n_rows)
                        online.observe(ch, (span if span > 0
                                            else max(finish - js.arrival,
                                                     0.0)) / rows)

        # jobs with no work at all complete the moment they arrive
        for js in states:
            if job_left[js.job.name] == 0 and job_unbuilt[js.job.name] == 0:
                js.done, js.finish = True, js.arrival

        def pick(wid: int, t: float):
            """Choose (state, stage-run, tasks, stolen, boosted) per the
            arbiter (``tasks``: one task, or a walker lane's run); ``boosted`` is snapshotted here because other workers
            re-run order() (which rewrites JobState.boosted) while this
            chunk executes outside the lock.

            Device walker lanes (``wid >= n_workers``) drain the admitted
            jobs' device shard deques first (same arbiter order), then
            absorb host chunks; host workers pop host queues first, then
            absorb device tails (core/hetero.py) — cross-substrate
            rebalancing under contention.
            """
            is_dev = wid >= n_workers
            admitted = [js for js in states
                        if js.arrival <= t and not js.done]
            ordered = arbiter.order(admitted, t)
            if is_dev:
                for js in ordered:
                    jname = js.job.name
                    for sr in stage_order[jname]:
                        shards = device_qs.get((jname, sr.stage.name))
                        if not shards:
                            continue
                        if jname in lowerings:
                            got = pop_device_run(shards, wid - n_workers, sr,
                                                 runs[jname])
                        else:
                            got = pop_device_task(shards, wid - n_workers,
                                                  sr, runs[jname])
                            got = [got] if got is not None else []
                        if got:
                            return js, sr, got, False, js.boosted
            for js in ordered:
                jname = js.job.name
                jruns = stage_order[jname]
                if lazy:
                    # extend this job's built prefix while its next stage
                    # is reachable — each build re-consults the selector
                    while (job_unbuilt[jname] > 0
                           and buildable(js, len(jruns))):
                        build_stage(js.job, js.job.dag.order[len(jruns)])
                    if job_unbuilt[jname] == 0 and job_left[jname] == 0 \
                            and not js.done:
                        # every stage built and drained (e.g. all-empty
                        # stages): complete the job here — no record path
                        # will ever fire for it
                        finish_job(js, max(job_end[jname], js.arrival))
                        continue
                ns = len(jruns)
                if ns == 0:
                    continue
                cur = cursors.get((wid, js.seq), wid % ns)
                for k in range(ns):
                    idx = (cur + k) % ns
                    sr = jruns[idx]
                    if sr.remaining == 0:
                        continue
                    got, stolen = _try_pop(sr, runs[jname], wid)
                    if got is not None:
                        cursors[(wid, js.seq)] = (idx + 1) % ns
                        return js, sr, [got], stolen, js.boosted
            if not is_dev and device_qs:
                for js in ordered:
                    jname = js.job.name
                    for sr in stage_order[jname]:
                        shards = device_qs.get((jname, sr.stage.name))
                        if not shards:
                            continue
                        got, delta = steal_device_tail(shards, sr,
                                                       runs[jname])
                        if got is not None:
                            job_left[jname] += delta
                            total_left[0] += delta
                            return js, sr, [got], True, js.boosted
            return None

        def worker(wid: int) -> None:
            """Pool thread: serve arbiter-ordered jobs until the pool drains.

            One error boundary wraps the whole loop: an exception anywhere
            (arbiter order, lazy builds, device-shard bookkeeping, stage
            ops) lands in ``errors`` and is re-raised by serve() — a lane
            dying silently must not let the drain report success.
            """
            try:
                while True:
                    choice = None
                    t_idle = time.perf_counter()
                    with cond:
                        while True:
                            if errors or (total_left[0] == 0
                                          and unbuilt[0] == 0):
                                return
                            t = time.perf_counter() - t0_run
                            choice = pick(wid, t)
                            if choice is not None:
                                break
                            pending = [js.arrival - t for js in states
                                       if js.arrival > t]
                            cond.wait(timeout=min([0.05] + [max(w, 1e-4)
                                                            for w in pending]))
                        js, sr, tasks, stolen, boosted = choice
                        inputs = _stage_inputs(sr, runs[js.job.name])
                        low = (lowerings.get(js.job.name)
                               if wid >= n_workers else None)
                        at_front = low is not None and at_frontier(sr, tasks)
                        seed = sr.prefix() if at_front else None
                    t0 = time.perf_counter()
                    values = run_tasks(low, sr, tasks, inputs, seed)
                    t1 = time.perf_counter()
                    with cond:
                        spans = run_spans(tasks, t0 - t0_run, t1 - t0_run)
                        if at_front:
                            sr.record_prefix(tasks, values[0], spans)
                        for k, task in enumerate(tasks):
                            dt, r0, r1 = spans[k]
                            self._record(js, sr, task,
                                         values[min(k, len(values) - 1)],
                                         r0, r1, wid, stolen, boosted,
                                         arbiter, events, busy, ntasks,
                                         job_tasks, job_end, steals,
                                         t0 - t_idle if k == 0 else 0.0,
                                         low is not None, tracer,
                                         fold=not at_front)
                            job_left[js.job.name] -= 1
                            total_left[0] -= 1
                            if online is not None:
                                online.record_raw(sr.stage.name, task[2], dt)
                        if online is not None and not sr.done \
                                and online.may_resize(sr.stage.name,
                                                      sr.resizes):
                            plan = online.plan_resize(
                                sr.stage.name, sr.pending_chunks(),
                                n_workers, resizes_done=sr.resizes)
                            if plan:
                                delta = sr.resize_remaining(plan)
                                job_left[js.job.name] += delta
                                total_left[0] += delta
                                if tracer.enabled:
                                    tracer.mark(
                                        "resize", t1 - t0_run,
                                        js.job.name, sr.stage.name,
                                        detail=f"chunks={len(plan)}")
                        if (job_left[js.job.name] == 0
                                and job_unbuilt[js.job.name] == 0):
                            finish_job(js, job_end[js.job.name])
                        cond.notify_all()
            except BaseException as e:  # surfaced to the caller below
                with cond:
                    errors.append(e)
                    cond.notify_all()

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(n_lanes)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        wall = time.perf_counter() - t0_run

        results: dict[str, JobResult] = {}
        tenant_service: dict[str, float] = {}
        for js in states:
            jname = js.job.name
            values = {n: sr.value for n, sr in runs[jname].items()}
            finish = js.finish if js.finish is not None else wall
            latency = finish - js.arrival
            met = (None if js.job.deadline_s is None
                   else latency <= js.job.deadline_s)
            results[jname] = JobResult(
                name=jname, values=values, arrival_s=js.arrival,
                finish_s=finish, latency_s=latency, service_s=js.service,
                n_tasks=job_tasks[jname], deadline_met=met)
            tenant_service[js.job.tenant] = (
                tenant_service.get(js.job.tenant, 0.0) + js.service)
        arrivals = [js.arrival for js in states]
        finishes = [r.finish_s for r in results.values()]
        result = ServerResult(
            jobs=results, events=events, wall_time_s=wall,
            makespan_s=(max(finishes) - min(arrivals)) if states else 0.0,
            per_worker_busy_s=busy, per_worker_tasks=ntasks,
            steals=steals[0], tenant_service_s=tenant_service,
            preemptions=list(getattr(arbiter, "preemption_log", [])))
        if tracer.enabled:
            for p in result.preemptions:
                tracer.mark(p.kind, p.t, p.job, detail=p.reason)
        if self.metrics is not None:
            from .telemetry import (collect_bandit_metrics,
                                    collect_server_metrics)
            collect_server_metrics(self.metrics, result)
            if online is not None:
                collect_bandit_metrics(self.metrics, online)
        return result

    @staticmethod
    def _record(js, sr, task, value, rel0, rel1, wid, stolen, boosted,
                arbiter, events, busy, ntasks, job_tasks, job_end, steals,
                wait_s=0.0, walked=False, tracer=None, fold=True):
        """Fold one chunk into stage/job/arbiter accounting (lock held);
        ``walked``: it ran on the walker; ``fold=False``: the stage has it
        already (a prefix run)."""
        i, s, z = task
        dt = rel1 - rel0
        if fold:
            sr.record(task, value, dt, rel0, rel1)
        arbiter.charge(js, dt, rel1)
        events.append_raw(js.job.name, js.job.tenant, sr.stage.name, i, s, z,
                          wid, rel0, rel1, stolen, boosted, wait_s)
        if tracer is not None and tracer.enabled:
            tracer.record_raw("exec", js.job.name, sr.stage.name, i, wid,
                              rel0, rel1,
                              (1 if stolen else 0) | (2 if walked else 0),
                              wait_s)
        busy[wid] += dt
        ntasks[wid] += 1
        job_tasks[js.job.name] += 1
        job_end[js.job.name] = max(job_end[js.job.name], rel1)
        steals[0] += int(stolen)
