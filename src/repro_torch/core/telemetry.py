"""Scheduler telemetry: the correlated span log.

The port's copy of the span log of the reference's ``core/telemetry.py``.
Every engine emits into ONE stream keyed by the shared ``(job, stage,
chunk)`` identity. The hot path is ``record_raw(...)`` — one flat-tuple
append under the caller's existing lock, no object construction; ``spans()``
materializes lazily and synthesizes the ``stage``/``job`` parent spans from
their children, so nesting invariants hold by construction. ``NullTracer``
is the opt-out: engines guard emission with ``tracer.enabled`` so an
untraced run pays a single attribute read per chunk.

The reference's metrics registry, Chrome-trace export, critical-path
analysis and device-walk spans are not part of the port yet.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["Span", "Tracer", "NullTracer", "NULL_TRACER", "as_tracer",
           "WORK_KINDS", "F_STOLEN", "F_DEVICE"]

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

    ``record_raw`` is the ONLY method engines call per chunk; parent
    synthesis runs at read time. ``enabled`` is True so call sites can
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
