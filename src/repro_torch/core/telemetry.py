"""Scheduler telemetry: the correlated span log, metrics, critical paths.

The port's copy of the reference's ``core/telemetry.py``. Every layer of
the runtime — host queue waits, chunk execution, work stealing,
host<->device transfers, the walker's slots, preemption, checkpoints,
moldable resizes — emits into ONE stream keyed by the shared ``(job,
stage, chunk)`` identity, so a makespan can be explained, not only
measured.

``Tracer``
    The span log. The hot path is ``record_raw(...)`` — one flat-tuple
    append under the caller's existing lock, no object construction;
    ``spans()`` materializes lazily and synthesizes the ``stage``/``job``
    parent spans from their children, so nesting invariants hold by
    construction; ``to_chrome_trace()`` exports the timeline as
    Chrome-trace / Perfetto JSON (workers and device lanes as threads of
    a "pool" process, per-job rows as threads of a "jobs" process).
    ``NullTracer`` is the opt-out: engines guard emission with
    ``tracer.enabled`` so an untraced run pays a single attribute read
    per chunk.

``MetricsRegistry``
    Counters / gauges / histograms (queue depth, steals, preemptions,
    bandit arm pulls, cache hit rates), folded in at drain time from the
    counters the engines already keep — never on the per-chunk path.
    Snapshots dump as JSON or Prometheus text (``launch/serve.py
    --metrics-out``).

``analyze_critical_path``
    Walks the span timeline backward from the last-finishing work span,
    telescoping the makespan into per-stage exec / queue-wait / transfer
    / scheduler-overhead attribution that sums to the makespan exactly by
    construction, and reconciles (``reconcile``) against the independent
    ``DagStats`` accounting.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

__all__ = [
    "Span", "Tracer", "NullTracer", "NULL_TRACER", "as_tracer",
    "WORK_KINDS", "F_STOLEN", "F_DEVICE",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "collect_queue_metrics", "collect_cache_metrics",
    "collect_bandit_metrics", "collect_server_metrics",
    "collect_openloop_metrics",
    "CriticalPathReport", "analyze_critical_path",
    "validate_chrome_trace",
]

# span kinds carrying real duration; everything else is an instant marker
# (t0 == t1)
WORK_KINDS = ("exec", "transfer")
# flag bits on exec spans
F_STOLEN = 1
F_DEVICE = 2


@dataclass(frozen=True)
class Span:
    """One materialized telemetry span.

    ``kind`` is the layer ("exec", "transfer", "stage", "job", or an
    instant marker like "preempt"/"resize"); identity is the shared
    ``(job, stage, chunk)`` triple; ``lane`` is the worker / device lane
    that ran it (-1 for scheduler-side events); ``flag`` is a bitmask
    (``F_STOLEN``, ``F_DEVICE``); ``wait_s`` is the queue wait that
    preceded an exec span.
    """

    kind: str
    job: str
    stage: str
    chunk: int
    lane: int
    t0: float
    t1: float
    flag: int = 0
    wait_s: float = 0.0
    detail: str = ""

    @property
    def dur(self) -> float:
        """Span duration in seconds (0 for instant marks)."""
        return self.t1 - self.t0

    @property
    def stolen(self) -> bool:
        """True when the chunk ran on a lane it was stolen onto."""
        return bool(self.flag & F_STOLEN)

    @property
    def device(self) -> bool:
        """True when the span ran on the device walker, not the host pool."""
        return bool(self.flag & F_DEVICE)


class Tracer:
    """Correlated span log with an amortized flat-tuple hot path.

    ``record_raw`` is the ONLY method engines call per chunk; everything
    else (parent synthesis, Chrome export, critical-path analysis) runs
    at read time. ``enabled`` is True so call sites can
    guard with a single attribute read.
    """

    __slots__ = ("_raw", "_spans", "job", "enabled")

    def __init__(self, job: str = "job"):
        self._raw: list[tuple] = []
        self._spans: list[Span] | None = None
        self.job = job
        self.enabled = True

    def record_raw(self, kind: str, job: str, stage: str, chunk: int,
                   lane: int, t0: float, t1: float, flag: int = 0,
                   wait_s: float = 0.0, detail: str = "") -> None:
        """One flat-tuple append; call under the engine's existing lock."""
        self._raw.append((kind, job, stage, chunk, lane, t0, t1, flag,
                          wait_s, detail))
        self._spans = None

    def mark(self, kind: str, t: float, job: str = "", stage: str = "",
             chunk: int = -1, detail: str = "") -> None:
        """Instant event (preempt, resize, migrate, ...)."""
        self.record_raw(kind, job or self.job, stage, chunk, -1, t, t,
                        0, 0.0, detail)

    def extend_raw(self, rows) -> None:
        """Bulk-append pre-built raw rows."""
        self._raw.extend(rows)
        self._spans = None

    def __len__(self) -> int:
        return len(self._raw)

    def spans(self) -> list[Span]:
        """All spans, with ``stage``/``job`` parents synthesized.

        Parents are derived from their children (stage = hull of the
        (job, stage) work spans; job = hull of everything the job
        emitted), so every exec span lies inside its stage span and every
        span inside its job span by construction.
        """
        if self._spans is not None:
            return self._spans
        base = [Span(*row) for row in self._raw]
        stages: dict[tuple[str, str], list[float]] = {}
        jobs: dict[str, list[float]] = {}
        for s in base:
            if s.kind in WORK_KINDS and s.stage:
                lo_hi = stages.setdefault((s.job, s.stage), [s.t0, s.t1])
                lo_hi[0] = min(lo_hi[0], s.t0 - s.wait_s)
                lo_hi[1] = max(lo_hi[1], s.t1)
            j = jobs.setdefault(s.job, [s.t0, s.t1])
            j[0] = min(j[0], s.t0 - s.wait_s)
            j[1] = max(j[1], s.t1)
        synth = [Span("stage", j, st, -1, -1, lo, hi)
                 for (j, st), (lo, hi) in stages.items()]
        synth += [Span("job", j, "", -1, -1, lo, hi)
                  for j, (lo, hi) in jobs.items()]
        self._spans = base + synth
        return self._spans

    # -- export ------------------------------------------------------------
    def to_chrome_trace(self) -> dict:
        """Chrome-trace / Perfetto JSON object (``json.dump`` and open in
        https://ui.perfetto.dev or chrome://tracing).

        pid 1 "pool": one thread per worker / device lane, carrying exec
        spans (cat "exec", "steal", or "device_walk"), the queue-wait
        slice preceding each exec (cat "queue"), and transfers. pid 2
        "jobs": one thread per job with the synthesized job/stage spans
        and every instant marker (admission, preempt, resize, ...).
        """
        ev: list[dict] = []
        us = 1e6
        ev.append({"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
                   "args": {"name": "pool"}})
        ev.append({"ph": "M", "pid": 2, "tid": 0, "name": "process_name",
                   "args": {"name": "jobs"}})
        job_tid: dict[str, int] = {}
        lanes: set[int] = set()

        def jtid(job: str) -> int:
            t = job_tid.get(job)
            if t is None:
                t = job_tid[job] = len(job_tid) + 1
                ev.append({"ph": "M", "pid": 2, "tid": t,
                           "name": "thread_name", "args": {"name": job}})
            return t

        for s in self.spans():
            args = {"job": s.job, "stage": s.stage, "chunk": s.chunk}
            if s.detail:
                args["detail"] = s.detail
            if s.kind in WORK_KINDS:
                lanes.add(s.lane)
                cat = s.kind
                if s.kind == "exec":
                    cat = ("device_walk" if s.device
                           else "steal" if s.stolen else "exec")
                name = f"{s.stage}[{s.chunk}]" if s.chunk >= 0 else s.stage
                if s.wait_s > 0.0:
                    ev.append({"name": f"wait {name}", "cat": "queue",
                               "ph": "X", "ts": (s.t0 - s.wait_s) * us,
                               "dur": s.wait_s * us, "pid": 1,
                               "tid": s.lane, "args": args})
                ev.append({"name": name, "cat": cat, "ph": "X",
                           "ts": s.t0 * us, "dur": s.dur * us,
                           "pid": 1, "tid": s.lane, "args": args})
            elif s.kind in ("stage", "job"):
                ev.append({"name": s.stage or s.job, "cat": s.kind,
                           "ph": "X", "ts": s.t0 * us, "dur": s.dur * us,
                           "pid": 2, "tid": jtid(s.job), "args": args})
            else:  # instant markers
                ev.append({"name": s.kind, "cat": s.kind, "ph": "i",
                           "ts": s.t0 * us, "s": "t", "pid": 2,
                           "tid": jtid(s.job), "args": args})
        for ln in sorted(lanes):
            ev.append({"ph": "M", "pid": 1, "tid": ln, "name": "thread_name",
                       "args": {"name": f"lane {ln}"}})
        return {"traceEvents": ev, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path) -> None:
        """Dump ``to_chrome_trace()`` as JSON at ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=1)


class NullTracer(Tracer):
    """Opt-out tracer: every recording surface is a no-op.

    ``enabled`` is False so hot loops skip even the argument packing;
    an accidental unguarded ``record_raw`` still costs nothing.
    """

    __slots__ = ()

    def __init__(self, job: str = "job"):
        super().__init__(job)
        self.enabled = False

    def record_raw(self, *a, **k) -> None:
        """No-op."""

    def mark(self, *a, **k) -> None:
        """No-op."""

    def extend_raw(self, rows) -> None:
        """No-op."""


NULL_TRACER = NullTracer()


def as_tracer(tracer: Tracer | None) -> Tracer:
    """``tracer`` or the shared NullTracer — what engine ctors call."""
    return tracer if tracer is not None else NULL_TRACER


# --------------------------------------------------------------------------
# Metrics
# --------------------------------------------------------------------------

def _fmt_labels(labels: dict | None) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


@dataclass
class Counter:
    """Monotonic counter."""

    name: str
    help: str = ""
    labels: dict | None = None
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        """Add ``n`` to the running total."""
        self.value += n


@dataclass
class Gauge:
    """Last-write-wins instantaneous value."""

    name: str
    help: str = ""
    labels: dict | None = None
    value: float = 0.0

    def set(self, v: float) -> None:
        """Overwrite the gauge with ``v``."""
        self.value = float(v)


@dataclass
class Histogram:
    """Value distribution; summarized at snapshot time (count/sum/min/
    max/p50/p99), not bucketed at observe time."""

    name: str
    help: str = ""
    labels: dict | None = None
    values: list[float] = field(default_factory=list)

    def observe(self, v: float) -> None:
        """Record one observation."""
        self.values.append(float(v))

    def summary(self) -> dict:
        """count/sum/min/max/p50/p99 over everything observed so far."""
        if not self.values:
            return {"count": 0, "sum": 0.0}
        vs = sorted(self.values)
        n = len(vs)
        return {"count": n, "sum": sum(vs), "min": vs[0], "max": vs[-1],
                "p50": vs[min(n - 1, int(0.50 * n))],
                "p99": vs[min(n - 1, int(0.99 * n))]}


class MetricsRegistry:
    """Named metric family registry, memoized on (kind, name, labels)."""

    def __init__(self):
        self._metrics: dict[tuple, Counter | Gauge | Histogram] = {}

    def _get(self, cls, name: str, help: str, labels: dict | None):
        key = (cls.__name__, name,
               tuple(sorted((labels or {}).items())))
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = cls(name, help, labels)
        return m

    def counter(self, name: str, help: str = "",
                labels: dict | None = None) -> Counter:
        """The memoized Counter for ``(name, labels)``."""
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: dict | None = None) -> Gauge:
        """The memoized Gauge for ``(name, labels)``."""
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: dict | None = None) -> Histogram:
        """The memoized Histogram for ``(name, labels)``."""
        return self._get(Histogram, name, help, labels)

    # -- export ------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-ready snapshot: one entry per metric, labels flattened
        into the key."""
        out: dict[str, dict] = {"counters": {}, "gauges": {},
                                "histograms": {}}
        for m in self._metrics.values():
            key = m.name + _fmt_labels(m.labels)
            if isinstance(m, Counter):
                out["counters"][key] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][key] = m.value
            else:
                out["histograms"][key] = m.summary()
        return out

    def to_json(self, indent: int = 2) -> str:
        """The ``snapshot()`` dict as sorted, indented JSON text."""
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition (one family per metric name)."""
        import re
        lines: list[str] = []
        seen_type: set[str] = set()

        def sanitize(n: str) -> str:
            return re.sub(r"[^a-zA-Z0-9_:]", "_", n)

        for m in self._metrics.values():
            name = sanitize(m.name)
            kind = {"Counter": "counter", "Gauge": "gauge",
                    "Histogram": "summary"}[type(m).__name__]
            if name not in seen_type:
                seen_type.add(name)
                if m.help:
                    lines.append(f"# HELP {name} {m.help}")
                lines.append(f"# TYPE {name} {kind}")
            lab = _fmt_labels(m.labels)
            if isinstance(m, (Counter, Gauge)):
                lines.append(f"{name}{lab} {m.value}")
            else:
                s = m.summary()
                lines.append(f"{name}_count{lab} {s['count']}")
                lines.append(f"{name}_sum{lab} {s['sum']}")
                for q in ("p50", "p99"):
                    if q in s:
                        qlab = dict(m.labels or {},
                                    quantile="0.5" if q == "p50" else "0.99")
                        lines.append(f"{name}{_fmt_labels(qlab)} {s[q]}")
        return "\n".join(lines) + "\n"


# -- drain-time collectors (never on the per-chunk path) -------------------

def collect_queue_metrics(reg: MetricsRegistry, counters: dict,
                          labels: dict | None = None) -> None:
    """Fold a queue's ``counters()`` dict (queues.py) into the registry."""
    for k, v in counters.items():
        if k == "depth":
            reg.gauge("sched_queue_depth", "queued tasks", labels).set(v)
        else:
            reg.counter(f"sched_queue_{k}", "", labels).inc(v)


def collect_cache_metrics(reg: MetricsRegistry) -> None:
    """Hit rates of the lowering memo (``build_dag_tables_cached``) and of
    the walker's device-resident table cache."""
    from ..kernels.dag_walk import device_table_cache_stats
    from .device_schedule import dag_table_cache_stats
    pairs = [("lowering_cache", dag_table_cache_stats()),
             ("device_table_cache", device_table_cache_stats())]
    for name, st in pairs:
        h, m = st.get("hits", 0), st.get("misses", 0)
        reg.counter(f"sched_{name}_hits").inc(h)
        reg.counter(f"sched_{name}_misses").inc(m)
        reg.gauge(f"sched_{name}_hit_rate").set(h / max(1, h + m))


def collect_bandit_metrics(reg: MetricsRegistry, scheduler) -> None:
    """Per-stage bandit arm pulls from an ``OnlineScheduler``."""
    for stage, sel in getattr(scheduler, "selectors", {}).items():
        arms = getattr(sel, "arms", [])
        counts = getattr(sel, "counts", None)
        if counts is None:
            continue
        for arm, n in zip(arms, counts):
            reg.counter("sched_bandit_pulls", "bandit arm pulls",
                        {"stage": stage, "arm": "/".join(arm)}).inc(n)
    for stage, n in getattr(scheduler, "resizes", {}).items():
        reg.counter("sched_resizes", "moldable resizes",
                    {"stage": stage}).inc(n)


def collect_server_metrics(reg: MetricsRegistry, result) -> None:
    """Fold a ``ServerResult``/``ServerSimResult`` into the registry."""
    reg.counter("sched_steals", "work steals").inc(
        getattr(result, "steals", 0))
    lat = reg.histogram("sched_job_latency_seconds", "job latency")
    n_chunks = 0
    for ev in getattr(result, "events", []) or []:
        n_chunks += 1
    reg.counter("sched_chunks", "chunks executed").inc(n_chunks)
    jobs = getattr(result, "jobs", None) or {}
    for job in (jobs.values() if isinstance(jobs, dict) else jobs):
        l = getattr(job, "latency_s", None)
        if l is not None:
            lat.observe(l)
    for tenant, s in (getattr(result, "tenant_service_s", {}) or {}).items():
        reg.counter("sched_tenant_service_seconds", "",
                    {"tenant": tenant}).inc(s)
    pre = getattr(result, "preemptions", []) or []
    for p in pre:
        reg.counter("sched_preemptions", "preemption events",
                    {"kind": p.kind}).inc()


def collect_openloop_metrics(reg: MetricsRegistry, result) -> None:
    """Fold an ``OpenLoopResult`` (admission front door) into the
    registry: admitted/shed with reasons, batching, backlog."""
    reg.counter("sched_jobs_admitted").inc(result.n_admitted)
    reg.counter("sched_jobs_shed").inc(result.n_shed)
    for reason, n in (result.shed_reasons or {}).items():
        reg.counter("sched_shed", "shed jobs", {"reason": reason}).inc(n)
    reg.counter("sched_batches").inc(result.n_batches)
    reg.counter("sched_batch_members_coalesced").inc(result.n_coalesced)
    reg.counter("sched_chunks").inc(result.n_chunks)
    reg.gauge("sched_pool_size").set(
        result.pool_timeline[-1][1] if result.pool_timeline else 0)
    lat = reg.histogram("sched_job_latency_seconds", "job latency")
    for m in result.members.values():
        if m.admitted and m.latency_s is not None:
            lat.observe(m.latency_s)
    for p in result.preemptions or []:
        reg.counter("sched_preemptions", "preemption events",
                    {"kind": p.kind}).inc()


# --------------------------------------------------------------------------
# Critical-path analysis
# --------------------------------------------------------------------------

@dataclass
class CriticalPathReport:
    """Makespan attribution from the backward critical-path walk.

    ``exec_s``/``queue_wait_s``/``transfer_s``/``sched_overhead_s`` are
    per-stage dicts; their grand total telescopes to ``makespan``
    exactly (the walk covers ``[0, makespan]`` with no gaps). ``path``
    is the chain of work spans, last-finishing first.
    """

    makespan: float
    exec_s: dict = field(default_factory=dict)
    queue_wait_s: dict = field(default_factory=dict)
    transfer_s: dict = field(default_factory=dict)
    sched_overhead_s: dict = field(default_factory=dict)
    path: list = field(default_factory=list)

    @property
    def breakdown(self) -> dict:
        """Makespan attribution summed across lanes, one float per bucket."""
        return {"exec": sum(self.exec_s.values()),
                "queue_wait": sum(self.queue_wait_s.values()),
                "transfer": sum(self.transfer_s.values()),
                "sched_overhead": sum(self.sched_overhead_s.values())}

    @property
    def total(self) -> float:
        """Sum of all buckets — telescopes to the analyzed makespan."""
        return sum(self.breakdown.values())

    def describe(self) -> str:
        """One-line ``bucket=...us`` rendering of the breakdown."""
        b = self.breakdown
        return " ".join(f"{k}={v * 1e6:.1f}us" for k, v in b.items())

    def reconcile(self, stats, makespan: float | None = None,
                  rel_tol: float = 1e-6, abs_tol: float = 1e-9) -> None:
        """Assert this attribution agrees with the independent
        ``DagStats`` accounting: the walk's total must equal the
        measured makespan, and no stage can sit on the critical path
        longer than ``DagStats`` says it ran at all.
        Raises ``ValueError`` on disagreement.
        """
        ms = self.makespan if makespan is None else makespan
        tol = abs_tol + rel_tol * max(ms, 1e-12)
        if abs(self.total - ms) > tol:
            raise ValueError(
                f"critical-path total {self.total:.9f}s != makespan "
                f"{ms:.9f}s (tol {tol:.2e})")
        for stage, t in self.exec_s.items():
            cap = stats.exec_s.get(stage, 0.0)
            if t > cap + tol:
                raise ValueError(
                    f"stage {stage}: critical-path exec {t:.9f}s exceeds "
                    f"DagStats total exec {cap:.9f}s")
        for stage, t in self.transfer_s.items():
            cap = stats.transfer_s.get(stage, 0.0)
            if t > cap + tol:
                raise ValueError(
                    f"stage {stage}: critical-path transfer {t:.9f}s "
                    f"exceeds DagStats total transfer {cap:.9f}s")


def analyze_critical_path(tracer: Tracer, makespan: float | None = None,
                          t_origin: float = 0.0) -> CriticalPathReport:
    """Attribute the makespan by walking the span timeline backward.

    Start at the last-finishing work span; repeatedly hop to the
    latest-ending work span that is still running (or already done) at
    the current span's start. Each hop attributes the clipped span body
    to its stage's exec (or transfer) bucket and the uncovered gap to
    queue-wait (up to the span's recorded ``wait_s``) with the
    remainder as scheduler overhead. The leading gap from ``t_origin``
    and the trailing gap to ``makespan`` (thread join / finalize) land
    in scheduler overhead too, so the buckets telescope to the makespan
    exactly.
    """
    work = sorted((s for s in tracer.spans() if s.kind in WORK_KINDS),
                  key=lambda s: s.t1)
    if not work:
        ms = makespan or 0.0
        rep = CriticalPathReport(makespan=ms)
        if ms > 0:
            rep.sched_overhead_s["_idle"] = ms
        return rep
    last = work[-1]
    ms = last.t1 - t_origin if makespan is None else makespan
    rep = CriticalPathReport(makespan=ms)
    # trailing gap: between the last span's end and the measured makespan
    tail = ms - (last.t1 - t_origin)
    if tail > 0:
        rep.sched_overhead_s["_drain"] = tail

    def add(d: dict, k: str, v: float) -> None:
        if v > 0:
            d[k] = d.get(k, 0.0) + v

    cursor = last.t1
    i = len(work) - 1
    cur = last
    while True:
        rep.path.append(cur)
        body = cursor - cur.t0  # clipped: a later hop may overlap us
        bucket = rep.transfer_s if cur.kind == "transfer" else rep.exec_s
        add(bucket, cur.stage or "_", min(body, cur.dur))
        cursor = min(cursor, cur.t0)
        # latest-ending span that had started by (or ends before) cursor
        nxt = None
        while i >= 0 and work[i].t1 > cursor:
            cand = work[i]
            if cand is not cur and cand.t0 < cursor:
                nxt = cand  # overlaps the cursor: no gap to attribute
                break
            i -= 1
        if nxt is None:
            # all remaining spans end at/before cursor; take the latest
            while i >= 0 and (work[i] is cur or work[i].t1 > cursor):
                i -= 1
            if i < 0:
                gap = cursor - t_origin
                wait = min(gap, cur.wait_s)
                add(rep.queue_wait_s, cur.stage or "_", wait)
                add(rep.sched_overhead_s, cur.stage or "_", gap - wait)
                break
            nxt = work[i]
            gap = cursor - nxt.t1
            wait = min(gap, cur.wait_s)
            add(rep.queue_wait_s, cur.stage or "_", wait)
            add(rep.sched_overhead_s, cur.stage or "_", gap - wait)
            cursor = nxt.t1
        cur = nxt
    return rep


# --------------------------------------------------------------------------
# Chrome-trace schema validation (shared by tests and --trace-out)
# --------------------------------------------------------------------------

def validate_chrome_trace(obj: dict) -> list[str]:
    """Return schema problems ([] == valid Chrome/Perfetto JSON).

    Checks the JSON-object trace format: a ``traceEvents`` list whose
    members carry ``ph``/``pid``/``tid``/``name``, with ``ts`` on every
    non-metadata event, non-negative ``dur`` on complete ("X") events,
    and JSON-serializable throughout.
    """
    problems: list[str] = []
    evs = obj.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    for k, ev in enumerate(evs):
        if not isinstance(ev, dict):
            problems.append(f"event {k}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "B", "E", "i", "I", "M", "C", "b", "e", "s",
                      "t", "f"):
            problems.append(f"event {k}: bad ph {ph!r}")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                problems.append(f"event {k}: missing int {key}")
        if not isinstance(ev.get("name"), str):
            problems.append(f"event {k}: missing name")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                problems.append(f"event {k}: missing ts")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {k}: bad dur {dur!r}")
    try:
        json.dumps(obj)
    except (TypeError, ValueError) as e:
        problems.append(f"not JSON-serializable: {e}")
    return problems
