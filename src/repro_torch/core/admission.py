"""Serving front door: open-loop admission, batching, autoscaling (the
port's copy of ``core/admission.py``).

The ``PipelineServer`` arbitrates jobs already sitting in the pool — a
*closed-loop* model. Production serving is open-loop: an arrival process
the pool does not control. This module is the layer in front of the pool:

  ``TokenBucket``           per-tenant rate limiting (capacity + refill).
  ``AdmissionController``   deadline/SLO-aware admission: sheds work that
                            is already expired, violates its tenant's
                            token bucket, or — by a fluid estimate from
                            live backlog and (optionally) the
                            ``FeedbackLog`` per-row rates — cannot meet
                            its deadline anyway.
  ``BatchPolicy`` / ``coalesce_submissions`` / ``merge_dags``
                            same-shape coalescing: submissions whose
                            DAGs share a signature merge into ONE
                            PipelineDAG of per-member stage copies
                            (``stage#member``), so the device path
                            freezes one super-table and pays one walker
                            launch for the whole batch
                            (``vee/apps.py:merge_device_lowerings``) —
                            bit-equal to unbatched execution because
                            every member keeps its own op over its own
                            rows.
  ``AutoscalePolicy``       pool sizing from queue-depth and
                            deadline-slack signals.
  ``replay_open_loop``      ``simulate_server`` extended into an
                            open-loop trace replayer: timestamped
                            arrivals, admission/batching/autoscaling
                            decisions made with LIVE engine state,
                            reporting p50/p99/p99.9 latency, shed rate,
                            and deadline hit-rate.
  ``heavy_tailed_trace``    the seeded open-loop workload generator:
                            Pareto interarrivals and service weights
                            over a small set of recurring pipeline
                            shapes (so batching has something to
                            coalesce); numpy draws, the reference's
                            exactly.
  ``FrontDoor``             the same admission/batching plan applied to
                            the REAL ``PipelineServer`` pool, with
                            per-member results split back out of each
                            batch. A placed submission never batches and
                            goes to the pool as it is: with its
                            ``lowering``, the pool's walker lane walks
                            its device rows on the walker kernel.

Decisions are deterministic given the trace (the virtual clock drives
everything): ``replay_open_loop`` and ``heavy_tailed_trace`` give the
reference's numbers to the bit.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field

import numpy as np

from .dag import PipelineDAG, Stage, StageDep
from .online import ChunkObservation
from .partitioners import chunk_schedule
from .server import (
    Job,
    JobResult,
    JobState,
    PipelineServer,
    job_stage_costs,
    make_arbiter,
)
from .simulator import SimOverheads, _combo_of, _pop_chunk, _SimStage
from .submit import Submission, as_submission
from .telemetry import as_tracer, collect_openloop_metrics

__all__ = [
    "TokenBucket", "AdmissionDecision", "AdmissionController",
    "batch_signature", "merge_dags", "coalesce_submissions", "BatchPolicy",
    "AutoscalePolicy", "MemberOutcome", "OpenLoopResult", "replay_open_loop",
    "heavy_tailed_trace", "FrontDoor", "FrontDoorResult", "BATCH_SEP",
]

BATCH_SEP = "#"


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

@dataclass
class TokenBucket:
    """A token bucket on the virtual clock: ``capacity`` burst, ``rate``/s.

    ``take(t)`` refills by elapsed time and consumes one token if
    available. ``capacity == 0`` is a valid configuration meaning "admit
    nothing for this tenant" (the zero-capacity edge case is tested
    explicitly).
    """

    rate: float
    capacity: float
    level: float | None = None
    t_last: float = 0.0

    def __post_init__(self):
        if self.rate < 0 or self.capacity < 0:
            raise ValueError("token bucket rate/capacity must be >= 0")
        if self.level is None:
            self.level = float(self.capacity)

    def take(self, t: float, n: float = 1.0) -> bool:
        """Consume ``n`` tokens at time ``t`` if the refilled level allows."""
        if t > self.t_last:
            self.level = min(self.capacity, self.level + (t - self.t_last) * self.rate)
            self.t_last = t
        if self.level >= n:
            self.level -= n
            return True
        return False


@dataclass(frozen=True)
class AdmissionDecision:
    """Outcome of one admission check: admitted, or shed with a reason."""

    admitted: bool
    reason: str = "admitted"   # admitted | expired | throttled | no_slack


class AdmissionController:
    """Deadline/SLO-aware admission with per-tenant token buckets.

    ``decide`` sheds, in order: jobs whose deadline is already
    unreachable at arrival (``expired`` — a zero or negative relative
    deadline), jobs whose fluid completion estimate misses the deadline
    (``no_slack``: predicted finish ``t + (backlog_s + service_s) /
    active`` past ``arrival + deadline * safety``), and finally jobs
    whose tenant bucket has no token (``throttled`` — checked last so a
    shed never burns quota). ``feedback`` (a ``FeedbackLog``, shared
    with the engine that executes admitted work) refines the service
    estimate: once a stage has ``min_observations`` recorded chunks its
    observed per-row rate replaces the submission's declared costs.
    """

    def __init__(self, buckets: dict[str, TokenBucket] | None = None,
                 safety: float = 1.0, feedback=None,
                 min_observations: int = 8):
        self.buckets = dict(buckets or {})
        self.safety = float(safety)
        self.feedback = feedback
        self.min_observations = int(min_observations)

    def estimate_service_s(self, job: Job,
                           costs: dict[str, np.ndarray] | None = None) -> float:
        """Total estimated service seconds for ``job`` (feedback-refined)."""
        if costs is None:
            costs = job_stage_costs(job)
        total = 0.0
        for name, vec in costs.items():
            rate = None
            if self.feedback is not None:
                fb = self.feedback.stage(name.split(BATCH_SEP, 1)[0])
                if fb is not None and fb.n >= self.min_observations \
                        and fb.rate_mean > 0:
                    rate = fb.rate_mean
            total += rate * len(vec) if rate is not None else float(vec.sum())
        return total

    def decide(self, job: Job, t: float, backlog_s: float,
               active_workers: int,
               costs: dict[str, np.ndarray] | None = None) -> AdmissionDecision:
        """Admit or shed ``job`` arriving at time ``t`` given live load."""
        if job.deadline_s is not None:
            deadline_abs = job.arrival_s + job.deadline_s
            if t >= deadline_abs:
                return AdmissionDecision(False, "expired")
            est = self.estimate_service_s(job, costs)
            pred = t + (backlog_s + est) / max(1, active_workers)
            if pred > job.arrival_s + job.deadline_s * self.safety:
                return AdmissionDecision(False, "no_slack")
        bucket = self.buckets.get(job.tenant)
        if bucket is not None and not bucket.take(t):
            return AdmissionDecision(False, "throttled")
        return AdmissionDecision(True)


# ---------------------------------------------------------------------------
# same-shape batch coalescing
# ---------------------------------------------------------------------------

def batch_signature(sub: Submission) -> tuple:
    """Hashable shape key: submissions with equal signatures may coalesce.

    Two submissions coalesce when they share a tenant and their DAGs are
    structurally identical — same stage names, row counts, combine
    modes, and dependency edges. Ops may differ (each member keeps its
    own closure), which is what makes the merged run bit-equal to the
    unbatched runs.
    """
    dag = sub.dag
    shape = tuple(
        (n, dag.stages[n].n_rows, dag.stages[n].combine,
         tuple((d.producer, d.kind) for d in dag.stages[n].deps))
        for n in dag.stage_names)
    return (sub.tenant, shape)


def _strip_member(name: str) -> str:
    """Drop the ``#member`` suffix a merged stage name carries."""
    return name.rsplit(BATCH_SEP, 1)[0]


def _wrap_op(op):
    """Wrap a member op so it sees its original producer names."""
    def wrapped(inputs, s, z):
        """Forward to the member op with member suffixes stripped."""
        return op({_strip_member(k): v for k, v in inputs.items()}, s, z)
    return wrapped


def merge_dags(dags: list[PipelineDAG]) -> PipelineDAG:
    """Merge DAGs into one: member ``j``'s stage ``s`` becomes ``s#j``.

    Members stay disjoint subgraphs — no cross-member edge, every stage
    keeps its own op (wrapped to strip the member suffix from its inputs
    dict) and cost model — so executing the merged DAG is bit-equal to
    executing the members separately, on the host pool and on the
    device walker alike. One merged DAG freezes into ONE super-table:
    the whole batch pays a single fused launch.
    """
    stages: list[Stage] = []
    for j, dag in enumerate(dags):
        for n in dag.stage_names:
            st = dag.stages[n]
            if BATCH_SEP in st.name:
                raise ValueError(
                    f"stage name {st.name!r} contains the reserved batch "
                    f"separator {BATCH_SEP!r}")
            stages.append(Stage(
                name=f"{st.name}{BATCH_SEP}{j}", n_rows=st.n_rows,
                op=_wrap_op(st.op), combine=st.combine,
                deps=tuple(StageDep(f"{d.producer}{BATCH_SEP}{j}", d.kind)
                           for d in st.deps),
                config=st.config, cost_of_range=st.cost_of_range))
    return PipelineDAG(stages)


def coalesce_submissions(subs: list[Submission],
                         name: str | None = None) -> Submission:
    """Coalesce same-shape submissions into one merged Submission.

    The merged submission carries the merged DAG (``merge_dags``), the
    union of per-stage overrides and cost vectors under member-suffixed
    names, the max priority, and the TIGHTEST member deadline (each
    member's absolute deadline re-expressed relative to the merged
    arrival, the latest member arrival). All members must share a tenant
    and carry no placement/online of their own. A single submission
    passes through unchanged.
    """
    if not subs:
        raise ValueError("cannot coalesce an empty batch")
    if len(subs) == 1:
        return subs[0]
    tenants = {s.tenant for s in subs}
    if len(tenants) != 1:
        raise ValueError(f"cannot coalesce across tenants {sorted(tenants)}")
    if any(s.placement is not None or s.online is not None for s in subs):
        raise ValueError("cannot coalesce submissions carrying placement "
                         "or online overrides")
    arrival = max(s.arrival_s for s in subs)
    deadline = None
    for s in subs:
        if s.deadline_s is not None:
            rel = (s.arrival_s + s.deadline_s) - arrival
            deadline = rel if deadline is None else min(deadline, rel)
    per_stage: dict = {}
    costs: dict = {}
    for j, s in enumerate(subs):
        for n, c in (s.per_stage or {}).items():
            per_stage[f"{n}{BATCH_SEP}{j}"] = c
        for n, c in (s.stage_costs or {}).items():
            costs[f"{n}{BATCH_SEP}{j}"] = c
    return Submission(
        dag=merge_dags([s.dag for s in subs]),
        name=name or f"batch({subs[0].name}x{len(subs)})",
        tenant=subs[0].tenant,
        priority=max(s.priority for s in subs),
        weight=max(s.weight for s in subs),
        arrival_s=arrival,
        deadline_s=None if deadline is None else max(deadline, 0.0),
        per_stage=per_stage or None,
        stage_costs=costs or None)


@dataclass
class BatchPolicy:
    """Coalescing policy: hold same-shape arrivals up to a window/size.

    An admitted submission whose ``batch_signature`` matches an open
    batch joins it; the batch flushes when it reaches ``max_batch``
    members or ``window_s`` after its first member arrived, whichever
    comes first. Submissions carrying a placement or online override
    never batch.
    """

    window_s: float = 2e-3
    max_batch: int = 8

    def batchable(self, sub: Submission) -> bool:
        """May this submission join a coalescing window at all?"""
        return (self.max_batch > 1 and sub.placement is None
                and sub.online is None)


# ---------------------------------------------------------------------------
# pool autoscaling
# ---------------------------------------------------------------------------

@dataclass
class AutoscalePolicy:
    """Pool sizing from queue-depth and deadline-slack signals.

    Every ``interval_s`` the engine asks for a target in
    [min_workers, max_workers]: queue depth (unfinished admitted jobs)
    divided by ``depth_per_worker`` sets the base target, and a minimum
    deadline slack below ``slack_low_s`` bumps it by ``step`` above the
    current size (scaling ahead of an SLO miss rather than after it).
    """

    min_workers: int
    max_workers: int
    interval_s: float = 5e-3
    depth_per_worker: float = 2.0
    slack_low_s: float = 0.0
    step: int = 2

    def __post_init__(self):
        if not 0 < self.min_workers <= self.max_workers:
            raise ValueError("need 0 < min_workers <= max_workers")
        if self.interval_s <= 0:
            raise ValueError("interval_s must be > 0")

    def decide(self, active: int, queue_depth: int,
               min_slack_s: float | None) -> int:
        """Target pool size given the current signals."""
        target = math.ceil(queue_depth / max(self.depth_per_worker, 1e-9))
        if min_slack_s is not None and min_slack_s < self.slack_low_s:
            target = max(target, active + self.step)
        return min(self.max_workers, max(self.min_workers, target))


# ---------------------------------------------------------------------------
# the open-loop trace replayer (simulate_server + live front door)
# ---------------------------------------------------------------------------

@dataclass
class MemberOutcome:
    """Per-submission outcome of one open-loop replay."""

    name: str
    tenant: str
    arrival_s: float
    admitted: bool
    reason: str                    # admitted | expired | throttled | no_slack
    batch: str | None = None       # merged engine-job name when coalesced
    finish_s: float | None = None
    latency_s: float | None = None
    deadline_met: bool | None = None


@dataclass
class OpenLoopResult:
    """Aggregate outcome of one ``replay_open_loop`` trace replay."""

    members: dict[str, MemberOutcome]
    n_jobs: int
    n_admitted: int
    n_shed: int
    shed_reasons: dict[str, int]
    n_batches: int                 # merged engine jobs with >= 2 members
    n_coalesced: int               # members that rode in a merged batch
    n_chunks: int
    makespan_s: float
    queue_wait_s: float
    pool_timeline: list[tuple[float, int]]
    worker_busy_s: list[float]
    preemptions: list = field(default_factory=list)  # PreemptionEvents

    @property
    def shed_rate(self) -> float:
        """Fraction of trace jobs shed at the front door."""
        return self.n_shed / self.n_jobs if self.n_jobs else 0.0

    def latencies(self) -> dict[str, float]:
        """Completed member name -> latency (virtual seconds)."""
        return {m.name: m.latency_s for m in self.members.values()
                if m.latency_s is not None}

    def latency_percentile(self, q: float) -> float:
        """Percentile ``q`` (0-100) over completed-member latencies."""
        vals = list(self.latencies().values())
        return float(np.percentile(vals, q)) if vals else 0.0

    def deadline_hit_rate(self) -> float:
        """Met / all deadline-carrying jobs; a shed deadline job is a miss."""
        total = met = 0
        for m in self.members.values():
            if m.deadline_met is not None:
                total += 1
                met += int(m.deadline_met)
        return met / total if total else 1.0

    def avg_pool(self) -> float:
        """Time-weighted mean active pool size over the replay."""
        tl = self.pool_timeline
        if len(tl) < 2:
            return float(tl[0][1]) if tl else 0.0
        area = 0.0
        for (t0, n0), (t1, _) in zip(tl, tl[1:]):
            area += n0 * (t1 - t0)
        span = tl[-1][0] - tl[0][0]
        return area / span if span > 0 else float(tl[-1][1])


def replay_open_loop(
    trace,
    n_workers: int = 20,
    arbiter="fair",
    arbiter_kwargs: dict | None = None,
    admission: AdmissionController | None = None,
    batching: BatchPolicy | None = None,
    autoscale: AutoscalePolicy | None = None,
    overheads: SimOverheads = SimOverheads(),
    seed: int = 0,
    feedback=None,
    tracer=None,
    metrics=None,
) -> OpenLoopResult:
    """Replay a timestamped open-loop trace through the serving runtime.

    ``simulate_server`` extended with the front door: arrivals enter at
    their trace timestamps; ``admission`` (optional) sheds at arrival
    using LIVE backlog (outstanding admitted virtual work over the
    active pool); ``batching`` (optional) holds admitted same-shape
    submissions and flushes them as ONE merged engine job;
    ``autoscale`` (optional) resizes the active pool every interval from
    queue-depth/slack signals — retired lanes finish their in-flight
    chunk and park, revived lanes rejoin at the tick. Chunk execution,
    dependency gating, and arbiter accounting are exactly
    ``simulate_server``'s (same ``_SimStage`` / ``_pop_chunk`` model).

    ``feedback`` (a FeedbackLog) receives every executed chunk under
    its base stage name; pass the same log to ``admission`` and its
    service estimates track observed rates — the closed loop between
    the feedback log and the front door.

    ``trace`` is a list of Submissions (or legacy Jobs) sorted or not;
    arrival order is taken from ``arrival_s``. Returns an
    ``OpenLoopResult`` with per-member outcomes and p50/p99/p99.9-ready
    latencies. Deterministic for a fixed trace and seed.

    ``tracer`` (a core.telemetry.Tracer) records admission decisions,
    batch flushes, chunk exec spans, and preemptions on one correlated
    virtual timeline; ``metrics`` (a MetricsRegistry) receives the
    drain-time counter snapshot via ``collect_openloop_metrics``.
    """
    tracer = as_tracer(tracer)
    traced = tracer.enabled
    subs = sorted((as_submission(s) for s in trace), key=lambda s: s.arrival_s)
    names = [s.name for s in subs]
    if len(set(names)) != len(names):
        raise ValueError("duplicate submission names in trace")
    arb = make_arbiter(arbiter, **(arbiter_kwargs or {}))
    ov = overheads

    max_lanes = autoscale.max_workers if autoscale is not None else n_workers
    active = autoscale.min_workers if autoscale is not None else n_workers

    members: dict[str, MemberOutcome] = {}
    shed_reasons: dict[str, int] = {}

    # engine state (the simulate_server core, grown dynamically)
    states: list[JobState] = []
    stages: dict[str, list[_SimStage]] = {}
    by_name: dict[str, dict[str, _SimStage]] = {}
    job_left: dict[str, int] = {}
    job_cost_left: dict[str, float] = {}
    job_members: dict[str, list[Submission]] = {}
    job_end: dict[str, float] = {}
    deadline_abs: dict[str, float] = {}
    engine_remaining = [0]
    outstanding = [0.0]            # admitted-but-unexecuted virtual seconds
    seq = [0]
    n_chunks = [0]

    def finish_members(jname: str, tf: float) -> None:
        """Fold an engine job's finish time into its member outcomes."""
        for m in job_members[jname]:
            mo = members[m.name]
            mo.finish_s = tf
            mo.latency_s = tf - m.arrival_s
            if m.deadline_s is not None:
                mo.deadline_met = mo.latency_s <= m.deadline_s
        job_end[jname] = tf

    def add_engine_job(sub: Submission, t: float,
                       mem: list[Submission]) -> None:
        """Materialize an admitted (possibly merged) job at time ``t``."""
        job = sub.to_job()
        costs = job_stage_costs(job)
        jl = []
        for n in job.dag.stage_names:
            stage = job.dag.stages[n]
            combo = _combo_of((job.per_stage or {}).get(n) or stage.config
                              or ("STATIC", "CENTRALIZED", "SEQ"))
            tech, layout, _ = combo
            schedule = chunk_schedule(tech, stage.n_rows, max_lanes, seed=seed)
            jl.append(_SimStage(n, [(d.producer, d.kind) for d in stage.deps],
                                schedule, costs[n], layout.upper()))
        js = JobState(job=job, seq=seq[0], arrival=t)
        seq[0] += 1
        states.append(js)
        stages[job.name] = jl
        by_name[job.name] = {st.name: st for st in jl}
        left = sum(len(st.chunks) for st in jl)
        job_left[job.name] = left
        job_cost_left[job.name] = float(sum(c.sum() for c in costs.values()))
        job_members[job.name] = mem
        job_end[job.name] = t
        if job.deadline_s is not None:
            deadline_abs[job.name] = js.arrival + job.deadline_s
        engine_remaining[0] += left
        for st in jl:
            if not st.chunks:
                st.start = st.finish = 0.0
        if left == 0:
            js.done, js.finish = True, t
            finish_members(job.name, t)

    def head_ready(jname: str, st: _SimStage) -> float:
        """Virtual time this stage's FIFO-head chunk becomes runnable."""
        s, z = st.chunks[st.ptr]
        rt = 0.0
        for prod, kind in st.deps:
            p = by_name[jname][prod]
            if kind == "full":
                rt = max(rt, p.finish)
            else:
                seg = p.row_time[s:s + z]
                rt = max(rt, float(seg.max()) if len(seg) else 0.0)
        return rt

    # control events: (time, tiebreak, kind, payload); kinds sort so that at
    # equal times arrivals admit before a batch flush or scale tick runs
    ARRIVE, FLUSH, TICK = 0, 1, 2
    ctrl: list[tuple[float, int, int, object]] = []
    ctrl_seq = [0]

    def push_ctrl(t: float, kind: int, payload) -> None:
        """Queue one control event."""
        heapq.heappush(ctrl, (t, kind * 1_000_000 + ctrl_seq[0], kind, payload))
        ctrl_seq[0] += 1

    for s in subs:
        push_ctrl(s.arrival_s, ARRIVE, s)
    arrivals_left = [len(subs)]
    open_batches: dict[tuple, list[Submission]] = {}
    flushed = [0]
    n_batches = [0]
    n_coalesced = [0]

    pool_timeline: list[tuple[float, int]] = [(subs[0].arrival_s if subs
                                               else 0.0, active)]
    if autoscale is not None and subs:
        push_ctrl(subs[0].arrival_s + autoscale.interval_s, TICK, None)

    heap: list[tuple[float, int]] = [(pool_timeline[0][0], w)
                                     for w in range(max_lanes)]
    heapq.heapify(heap)
    idle: list[int] = []           # lanes with nothing runnable right now
    cold: list[int] = []           # lanes retired by a scale-down
    busy = [0.0] * max_lanes
    queue_wait = [0.0]
    last_completion = [pool_timeline[0][0]]

    def wake(t: float) -> None:
        """Re-arm parked lanes after an event that may add runnable work."""
        for w in idle:
            heapq.heappush(heap, (t, w))
        idle.clear()
        for w in list(cold):
            if w < active:
                cold.remove(w)
                heapq.heappush(heap, (t, w))

    def flush_batch(key: tuple, t: float) -> None:
        """Launch one open batch as a single (possibly merged) engine job."""
        mem = open_batches.pop(key, None)
        if not mem:
            return
        if len(mem) == 1:
            add_engine_job(mem[0].replace(arrival_s=t), t, mem)
        else:
            merged = coalesce_submissions(
                mem, name=f"batch{n_batches[0]}({mem[0].name}x{len(mem)})")
            n_batches[0] += 1
            n_coalesced[0] += len(mem)
            for m in mem:
                members[m.name].batch = merged.name
            if traced:
                tracer.mark("batch", t, merged.name,
                            detail=f"members={len(mem)}")
            add_engine_job(merged.replace(arrival_s=t), t, mem)
        wake(t)

    def handle_arrival(sub: Submission, t: float) -> None:
        """Admit/shed one arrival; batch or launch it when admitted."""
        mo = MemberOutcome(sub.name, sub.tenant, sub.arrival_s,
                           admitted=True, reason="admitted")
        members[sub.name] = mo
        arrivals_left[0] -= 1
        if admission is not None:
            dec = admission.decide(sub.to_job(), t, outstanding[0], active)
            if not dec.admitted:
                mo.admitted = False
                mo.reason = dec.reason
                if sub.deadline_s is not None:
                    mo.deadline_met = False   # shed deadline job = SLO miss
                shed_reasons[dec.reason] = shed_reasons.get(dec.reason, 0) + 1
                if traced:
                    tracer.mark("shed", t, sub.name, detail=dec.reason)
                return
        if traced:
            tracer.mark("admit", t, sub.name)
        outstanding[0] += float(
            sum(c.sum() for c in job_stage_costs(sub.to_job()).values()))
        if batching is not None and batching.batchable(sub):
            key = batch_signature(sub)
            batch = open_batches.setdefault(key, [])
            batch.append(sub)
            if len(batch) >= batching.max_batch:
                flush_batch(key, t)
            elif len(batch) == 1:
                push_ctrl(t + batching.window_s, FLUSH, key)
            return
        add_engine_job(sub, t, [sub])
        wake(t)

    def handle_tick(t: float) -> None:
        """Apply one autoscale decision and schedule the next tick."""
        nonlocal active
        depth = sum(1 for js in states if not js.done)
        min_slack = None
        for js in states:
            if js.done or js.job.name not in deadline_abs:
                continue
            est = job_cost_left[js.job.name] / max(1, active)
            slack = deadline_abs[js.job.name] - (t + est)
            min_slack = slack if min_slack is None else min(min_slack, slack)
        target = autoscale.decide(active, depth, min_slack)
        if target != active:
            active = target
            pool_timeline.append((t, active))
            wake(t)
        if arrivals_left[0] or open_batches or engine_remaining[0] > 0:
            push_ctrl(t + autoscale.interval_s, TICK, None)

    while arrivals_left[0] or open_batches or engine_remaining[0] > 0:
        take_ctrl = bool(ctrl) and (not heap or ctrl[0][0] <= heap[0][0])
        if take_ctrl:
            t, _, kind, payload = heapq.heappop(ctrl)
            if kind == ARRIVE:
                handle_arrival(payload, t)
            elif kind == FLUSH:
                flushed[0] += 1
                flush_batch(payload, t)
            else:
                handle_tick(t)
            continue
        if not heap:
            if engine_remaining[0] > 0:
                raise RuntimeError("replay_open_loop: no runnable chunk but "
                                   "work remains (unsatisfiable dependency)")
            break
        t, w = heapq.heappop(heap)
        if w >= active:
            cold.append(w)
            continue
        admitted = [js for js in states if js.arrival <= t and not js.done]
        taken = None
        for js in arb.order(admitted, t):
            jl = stages[js.job.name]
            ns = len(jl)
            for k in range(ns):
                idx = (w + k) % ns
                st = jl[idx]
                if st.ptr >= len(st.chunks):
                    continue
                if head_ready(js.job.name, st) <= t:
                    taken = (js, st)
                    break
            if taken is not None:
                break
        if taken is None:
            wakes = [ctrl[0][0]] if ctrl else []
            for js in admitted:
                for st in stages[js.job.name]:
                    if st.ptr < len(st.chunks):
                        hr = head_ready(js.job.name, st)
                        if math.isfinite(hr) and hr > t:
                            wakes.append(hr)
            if wakes:
                heapq.heappush(heap, (min(wakes), w))
            else:
                idle.append(w)
            continue
        js, st = taken
        jname = js.job.name
        base_cost = st.chunk_cost[st.ptr]
        tid, s0, z0, cost, t_acc, t_end, wait = _pop_chunk(st, w, t, ov)
        queue_wait[0] += wait
        arb.charge(js, cost, t_end)
        busy[w] += cost
        n_chunks[0] += 1
        if traced:
            tracer.record_raw("exec", jname, st.name, tid, w, t_acc, t_end,
                              0, wait)
        outstanding[0] = max(0.0, outstanding[0] - base_cost)
        job_cost_left[jname] = max(0.0, job_cost_left[jname] - base_cost)
        job_left[jname] -= 1
        engine_remaining[0] -= 1
        last_completion[0] = max(last_completion[0], t_end)
        if feedback is not None:
            feedback.record(ChunkObservation(
                _strip_member(st.name), tid, s0, z0, cost, w, t_end))
        if job_left[jname] == 0:
            js.done = True
            js.finish = t_end
            finish_members(jname, t_end)
        heapq.heappush(heap, (t_end, w))
        if idle:
            for pw in idle:
                heapq.heappush(heap, (t, pw))
            idle.clear()

    n_shed = sum(shed_reasons.values())
    first_arrival = subs[0].arrival_s if subs else 0.0
    pool_timeline.append((last_completion[0], active))
    preemptions = list(getattr(arb, "preemption_log", []))
    if traced:
        for p in preemptions:
            tracer.mark(p.kind, p.t, p.job, detail=p.reason)
    result = OpenLoopResult(
        members=members, n_jobs=len(subs),
        n_admitted=len(subs) - n_shed, n_shed=n_shed,
        shed_reasons=shed_reasons, n_batches=n_batches[0],
        n_coalesced=n_coalesced[0], n_chunks=n_chunks[0],
        makespan_s=max(0.0, last_completion[0] - first_arrival),
        queue_wait_s=queue_wait[0], pool_timeline=pool_timeline,
        worker_busy_s=busy,
        preemptions=preemptions)
    if metrics is not None:
        collect_openloop_metrics(metrics, result)
    return result


# ---------------------------------------------------------------------------
# seeded open-loop workload generator
# ---------------------------------------------------------------------------

def _noop(inputs, s, z):
    """Cost-only trace op: virtual replay never calls it with real data."""
    return z


_TRACE_CLASSES = (
    # (tag, tenant, weight, rows, stages, base per-row rate, deadline mult)
    ("web", "web", 4.0, 64, 2, 2e-6, 60.0),
    ("etl", "etl", 1.0, 256, 1, 4e-6, None),
    ("ml", "ml", 2.0, 128, 2, 3e-6, 400.0),
)


def heavy_tailed_trace(
    n_jobs: int,
    seed: int = 0,
    load: float = 1.4,
    n_workers: int = 20,
    alpha_arrival: float = 1.6,
    alpha_service: float = 2.2,
) -> list[Submission]:
    """A seeded heavy-tailed open-loop trace of Submissions.

    Interarrivals and per-job service scale are Pareto-distributed (the
    classic open-loop stress: bursts on a heavy tail), drawn over a
    small set of recurring pipeline shapes — interactive two-stage jobs
    with tight deadlines, deadline-free batch reductions, and mid-size
    training jobs with loose deadlines — so same-shape batching has
    material to coalesce. ``load`` is the offered-load factor relative
    to ``n_workers`` capacity (>1 = overload, the regime admission
    control exists for). Deterministic for a fixed seed.
    """
    rng = np.random.default_rng(seed)
    classes = _TRACE_CLASSES
    mean_service = np.mean([
        c[3] * c[4] * c[5] * (alpha_service / (alpha_service - 1.0))
        for c in classes])
    mean_gap = mean_service / (max(1, n_workers) * max(load, 1e-6))
    gap_scale = mean_gap * (alpha_arrival - 1.0) / alpha_arrival

    subs: list[Submission] = []
    t = 0.0
    for i in range(n_jobs):
        t += gap_scale * (1.0 + rng.pareto(alpha_arrival))
        tag, tenant, weight, rows, n_stages, rate, dl_mult = \
            classes[int(rng.integers(len(classes)))]
        scale = 1.0 + rng.pareto(alpha_service)
        per_row = rate * scale
        if n_stages == 1:
            stages = [Stage("reduce", rows, _noop, combine="sum")]
            costs = {"reduce": np.full(rows, per_row)}
        else:
            stages = [
                Stage("prep", rows, _noop, combine="concat"),
                Stage("score", rows, _noop, combine="concat",
                      deps=(StageDep("prep", "elementwise"),)),
            ]
            costs = {"prep": np.full(rows, per_row),
                     "score": np.full(rows, per_row * 0.5)}
        deadline = None
        if dl_mult is not None:
            deadline = rows * per_row * dl_mult / max(1, n_workers)
        subs.append(Submission(
            dag=PipelineDAG(stages), name=f"{tag}-{i}", tenant=tenant,
            weight=weight, arrival_s=t, deadline_s=deadline,
            stage_costs=costs))
    return subs


# ---------------------------------------------------------------------------
# the real-pool front door (PipelineServer behind admission + batching)
# ---------------------------------------------------------------------------

@dataclass
class FrontDoorResult:
    """Outcome of one FrontDoor drain: per-member results plus sheds."""

    jobs: dict[str, JobResult]
    shed: dict[str, str]           # member name -> reason
    server_result: object          # the underlying ServerResult
    n_batches: int

    def latency_percentile(self, q: float) -> float:
        """Percentile ``q`` (0-100) over completed member latencies."""
        vals = [r.latency_s for r in self.jobs.values()]
        return float(np.percentile(vals, q)) if vals else 0.0


class FrontDoor:
    """Admission + batching in front of a real ``PipelineServer`` pool.

    ``submit()`` queues Submissions; ``serve()`` plans the front door in
    trace time — the same ``AdmissionController`` semantics as
    ``replay_open_loop``, with a fluid backlog estimate (committed
    estimated work minus pool drain) standing in for live engine state —
    coalesces admitted same-shape submissions per the ``BatchPolicy``
    window, runs the surviving jobs on the shared pool, and splits each
    batch's result back into per-member ``JobResult`` records (member
    stage values recovered from their ``stage#member`` names).
    """

    def __init__(self, config, arbiter="fair",
                 arbiter_kwargs: dict | None = None,
                 admission: AdmissionController | None = None,
                 batching: BatchPolicy | None = None,
                 online=None, tracer=None, metrics=None):
        self.config = config
        self.admission = admission
        self.batching = batching
        self.tracer = as_tracer(tracer)
        self.metrics = metrics
        self._server = PipelineServer(config, arbiter=arbiter,
                                      arbiter_kwargs=arbiter_kwargs,
                                      online=online, tracer=self.tracer,
                                      metrics=metrics)
        self._queued: list[Submission] = []

    def submit(self, sub) -> None:
        """Queue one Submission (or legacy Job) for the next ``serve``."""
        self._queued.append(as_submission(sub, surface="FrontDoor.submit"))

    def serve(self, subs=None) -> FrontDoorResult:
        """Drain queued (or given) submissions through the front door."""
        items = self._queued if subs is None else [
            as_submission(s, surface="FrontDoor.serve") for s in subs]
        self._queued = []
        subs = sorted(items, key=lambda s: s.arrival_s)
        shed: dict[str, str] = {}
        launches: list[tuple[Submission, list[Submission]]] = []
        open_batches: dict[tuple, list[Submission]] = {}
        committed = 0.0
        t0 = subs[0].arrival_s if subs else 0.0
        n_workers = max(1, self.config.n_workers)
        n_batches = 0

        tracer = self.tracer
        traced = tracer.enabled

        def flush(key, t):
            """Close one batch window into a launch entry."""
            nonlocal n_batches
            mem = open_batches.pop(key, None)
            if not mem:
                return
            if len(mem) == 1:
                launches.append((mem[0].replace(arrival_s=t), mem))
                return
            n_batches += 1
            merged = coalesce_submissions(
                mem, name=f"batch{n_batches}({mem[0].name}x{len(mem)})")
            if traced:
                tracer.mark("batch", t, merged.name,
                            detail=f"members={len(mem)}")
            launches.append((merged.replace(arrival_s=t), mem))

        for sub in subs:
            t = sub.arrival_s
            # flush any batch whose window closed before this arrival
            for key in list(open_batches):
                first = open_batches[key][0].arrival_s
                if self.batching and t >= first + self.batching.window_s:
                    flush(key, first + self.batching.window_s)
            if self.admission is not None:
                backlog = max(0.0, committed - n_workers * (t - t0))
                dec = self.admission.decide(sub.to_job(), t, backlog,
                                            n_workers)
                if not dec.admitted:
                    shed[sub.name] = dec.reason
                    if traced:
                        tracer.mark("shed", t, sub.name, detail=dec.reason)
                    continue
            if traced:
                tracer.mark("admit", t, sub.name)
            committed += self.admission.estimate_service_s(sub.to_job()) \
                if self.admission is not None else 0.0
            if self.batching is not None and self.batching.batchable(sub):
                key = batch_signature(sub)
                batch = open_batches.setdefault(key, [])
                batch.append(sub)
                if len(batch) >= self.batching.max_batch:
                    flush(key, t)
            else:
                launches.append((sub, [sub]))
        for key in list(open_batches):
            mem = open_batches[key]
            t = (mem[0].arrival_s + self.batching.window_s
                 if self.batching else mem[0].arrival_s)
            flush(key, t)

        result = self._server.serve([s for s, _ in launches])
        jobs: dict[str, JobResult] = {}
        for launch, mem in launches:
            r = result.jobs[launch.name]
            if len(mem) == 1 and mem[0].name == launch.name:
                jobs[launch.name] = r
                continue
            for j, m in enumerate(mem):
                values = {_strip_member(n): v for n, v in r.values.items()
                          if n.endswith(f"{BATCH_SEP}{j}")}
                latency = r.finish_s - m.arrival_s
                met = (None if m.deadline_s is None
                       else latency <= m.deadline_s)
                jobs[m.name] = JobResult(
                    name=m.name, values=values, arrival_s=m.arrival_s,
                    finish_s=r.finish_s, latency_s=latency,
                    service_s=r.service_s / len(mem), n_tasks=r.n_tasks,
                    deadline_met=met)
        return FrontDoorResult(jobs=jobs, shed=shed, server_result=result,
                               n_batches=n_batches)
