"""Work-partitioning techniques of DaphneSched.

The paper's first axis: eleven self-scheduling (DLS) techniques that compute
the size of the next chunk of tasks a worker obtains. Each partitioner
implements the paper's Fig. 4 interface:

    Initialize/Update : ``Partitioner(n_tasks, n_workers, ...)`` and
                        ``update(runtime_info)`` for adaptive techniques.
    Get Task          : ``next_chunk(worker_id) -> int`` (0 when exhausted).

Chunk formulas follow the published definitions; practical constants for
MFSC / FISS / VISS / PSS are documented in DESIGN.md §4. All partitioners are
deterministic given their seed and satisfy the invariants (property-tested):

    * every chunk >= 1 while work remains
    * sum of all chunks == n_tasks
    * monotonicity class (fixed / decreasing / increasing) per technique

``chunk_schedule`` materializes the full schedule as ``(start, size)`` pairs —
this is what the device path (core/device_schedule.py) consumes, because
the GPU walker drains a schedule frozen on the host before the launch.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

__all__ = [
    "Partitioner",
    "make_partitioner",
    "chunk_sizes",
    "chunk_schedule",
    "first_chunk",
    "first_chunk_fn",
    "PARTITIONERS",
]


class Partitioner:
    """Base class: centralized chunk calculator (paper Fig. 4).

    Thread-safe: ``next_chunk`` may be called concurrently by workers pulling
    from a centralized queue. Subclasses implement ``_chunk(remaining)``.
    """

    #: monotonicity class, one of "fixed", "decreasing", "increasing",
    #: "mixed" — used by property tests and by the auto-tuner.
    monotonicity = "mixed"

    def __init__(self, n_tasks: int, n_workers: int, seed: int = 0):
        if n_tasks < 0:
            raise ValueError(f"n_tasks must be >= 0, got {n_tasks}")
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.n_tasks = int(n_tasks)
        self.n_workers = int(n_workers)
        self.seed = seed
        self._remaining = int(n_tasks)
        self._scheduled = 0
        self._calls = 0
        self._lock = threading.Lock()
        self._rng = np.random.default_rng(seed)

    # -- paper interface -----------------------------------------------------
    def update(self, **runtime_info) -> None:
        """Runtime-information hook (paper: 'Initialize/Update').

        Adaptive techniques (PLS, PSS and the auto-tuner) override this; the
        default is a no-op so every technique shares one interface.
        """

    def next_chunk(self, worker_id: int = 0) -> int:
        """Number of tasks the calling worker should self-schedule next."""
        with self._lock:
            if self._remaining <= 0:
                return 0
            c = max(1, min(self._remaining, int(self._chunk(self._remaining))))
            self._remaining -= c
            self._scheduled += c
            self._calls += 1
            return c

    # -- implementation hook -------------------------------------------------
    def _chunk(self, remaining: int) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    # -- conveniences ---------------------------------------------------------
    @property
    def remaining(self) -> int:
        """Tasks not yet handed out."""
        with self._lock:
            return self._remaining

    def reset(self) -> None:
        """Restore the initial state (reproduces the exact chunk sequence)."""
        with self._lock:
            self._remaining = self.n_tasks
            self._scheduled = 0
            self._calls = 0
            self._rng = np.random.default_rng(self.seed)
            self._reset_state()

    def _reset_state(self) -> None:
        pass


class Static(Partitioner):
    """STATIC: one chunk of ceil(N/P) per worker (DAPHNE's default)."""

    monotonicity = "fixed"

    def _chunk(self, remaining: int) -> int:
        return math.ceil(self.n_tasks / self.n_workers)


class SelfScheduling(Partitioner):
    """SS: chunk = 1 (finest granularity, maximal queue traffic)."""

    monotonicity = "fixed"

    def _chunk(self, remaining: int) -> int:
        return 1


class MFSC(Partitioner):
    """mFSC: profiling-free fixed-size-chunk approximation (LB4OMP-style).

    FSC's optimal chunk needs the overhead/iteration-time ratio; mFSC removes
    the profiling requirement. We use

        chunk = ceil( N / (P * ceil(log2(2N/P))) )

    i.e. a fixed moderate granularity producing ~log2(2N/P) chunks per worker
    (documented in DESIGN.md §4).
    """

    monotonicity = "fixed"

    def __init__(self, n_tasks: int, n_workers: int, seed: int = 0):
        super().__init__(n_tasks, n_workers, seed)
        if n_tasks == 0:
            self._fixed = 1
        else:
            denom = max(1.0, math.ceil(math.log2(max(2.0, 2.0 * n_tasks / n_workers))))
            self._fixed = max(1, math.ceil(n_tasks / (n_workers * denom)))

    def _chunk(self, remaining: int) -> int:
        return self._fixed


class GSS(Partitioner):
    """Guided self-scheduling [Polychronopoulos & Kuck 1987]: ceil(R/P)."""

    monotonicity = "decreasing"

    def _chunk(self, remaining: int) -> int:
        return math.ceil(remaining / self.n_workers)


class TSS(Partitioner):
    """Trapezoid self-scheduling [Tzen & Ni 1993].

    Linearly decreasing chunks from f = ceil(N/2P) to l = 1 over
    C = ceil(2N/(f+l)) chunks, decrement d = (f-l)/(C-1).
    """

    monotonicity = "decreasing"

    def __init__(self, n_tasks: int, n_workers: int, seed: int = 0):
        super().__init__(n_tasks, n_workers, seed)
        self._f = max(1, math.ceil(n_tasks / (2 * n_workers)))
        self._l = 1
        self._C = max(1, math.ceil(2 * n_tasks / (self._f + self._l))) if n_tasks else 1
        self._d = (self._f - self._l) / max(1, self._C - 1)
        self._i = 0

    def _reset_state(self) -> None:
        self._i = 0

    def _chunk(self, remaining: int) -> int:
        c = self._f - self._i * self._d
        self._i += 1
        return max(self._l, int(round(c)))


class FAC2(Partitioner):
    """FAC2: practical factoring [Flynn Hummel et al. 1992].

    Each *batch* of P chunks has size ceil(R_batch/(2P)): half the remaining
    work split evenly, no profiling needed.
    """

    monotonicity = "decreasing"

    def __init__(self, n_tasks: int, n_workers: int, seed: int = 0):
        super().__init__(n_tasks, n_workers, seed)
        self._batch_left = 0
        self._batch_chunk = 0

    def _reset_state(self) -> None:
        self._batch_left = 0
        self._batch_chunk = 0

    def _chunk(self, remaining: int) -> int:
        if self._batch_left == 0:
            self._batch_chunk = max(1, math.ceil(remaining / (2 * self.n_workers)))
            self._batch_left = self.n_workers
        self._batch_left -= 1
        return self._batch_chunk


class TFSS(Partitioner):
    """Trapezoid factoring self-scheduling [Chronopoulos et al. 2001].

    Batches of P equal chunks whose size is the mean of the next P TSS
    chunks — trapezoid decrease across batches, factoring within a batch.
    """

    monotonicity = "decreasing"

    def __init__(self, n_tasks: int, n_workers: int, seed: int = 0):
        super().__init__(n_tasks, n_workers, seed)
        self._tss = TSS(n_tasks, n_workers, seed)
        self._batch_left = 0
        self._batch_chunk = 0

    def _reset_state(self) -> None:
        self._tss.reset()
        self._batch_left = 0
        self._batch_chunk = 0

    def _chunk(self, remaining: int) -> int:
        if self._batch_left == 0:
            # mean of next P TSS chunk sizes (without consuming real work)
            sizes = []
            for _ in range(self.n_workers):
                s = self._tss._f - self._tss._i * self._tss._d
                self._tss._i += 1
                sizes.append(max(1, int(round(s))))
            self._batch_chunk = max(1, int(round(sum(sizes) / len(sizes))))
            self._batch_left = self.n_workers
        self._batch_left -= 1
        return self._batch_chunk


class FISS(Partitioner):
    """Fixed-increase self-scheduling [Philip & Das 1997].

    B stages (default 4): chunk_0 = ceil(N/((2+B)P)), then fixed bump
    2N(1-B/(2+B))/(P*B*(B-1)) per stage.
    """

    monotonicity = "increasing"

    def __init__(self, n_tasks: int, n_workers: int, seed: int = 0, stages: int = 4):
        super().__init__(n_tasks, n_workers, seed)
        B = max(2, stages)
        self._B = B
        self._c0 = max(1, math.ceil(n_tasks / ((2 + B) * n_workers)))
        self._bump = max(
            0.0, 2.0 * n_tasks * (1.0 - B / (2.0 + B)) / (n_workers * B * (B - 1))
        )
        self._stage_calls = 0

    def _reset_state(self) -> None:
        self._stage_calls = 0

    def _chunk(self, remaining: int) -> int:
        stage = self._stage_calls // self.n_workers
        self._stage_calls += 1
        return max(1, int(round(self._c0 + stage * self._bump)))


class VISS(Partitioner):
    """Variable-increase self-scheduling [Philip & Das 1997].

    Geometric increase: chunk_{i+1} = chunk_i + chunk_0 / 2^i, i.e. the
    increments halve each stage (saturating growth).
    """

    monotonicity = "increasing"

    def __init__(self, n_tasks: int, n_workers: int, seed: int = 0):
        super().__init__(n_tasks, n_workers, seed)
        self._c0 = max(1, math.ceil(n_tasks / (4 * n_workers)))
        self._stage_calls = 0

    def _reset_state(self) -> None:
        self._stage_calls = 0

    def _chunk(self, remaining: int) -> int:
        stage = self._stage_calls // self.n_workers
        self._stage_calls += 1
        c = self._c0 * (2.0 - 0.5 ** max(0, stage - 1)) if stage > 0 else self._c0
        return max(1, int(round(c)))


class PLS(Partitioner):
    """Performance loop-based self-scheduling [Shih et al. 2007].

    A static fraction SWR (default 0.5) is scheduled as P equal chunks; the
    dynamic remainder follows GSS. ``update(speed=...)`` adjusts the dynamic
    divisor with the measured relative worker speed.
    """

    monotonicity = "mixed"

    def __init__(self, n_tasks: int, n_workers: int, seed: int = 0, swr: float = 0.5):
        super().__init__(n_tasks, n_workers, seed)
        self._static_total = int(n_tasks * swr)
        self._static_chunk = max(1, math.ceil(self._static_total / n_workers)) if self._static_total else 0
        self._speed = 1.0

    def update(self, **runtime_info) -> None:
        """Feed the measured relative worker ``speed`` (clipped to [0.25, 4])."""
        s = runtime_info.get("speed")
        if s:
            self._speed = float(np.clip(s, 0.25, 4.0))

    def _chunk(self, remaining: int) -> int:
        done = self.n_tasks - remaining
        if done < self._static_total:
            return min(self._static_chunk, self._static_total - done)
        return max(1, math.ceil(remaining / (self.n_workers * self._speed)))


class PSS(Partitioner):
    """Probabilistic self-scheduling [Girkar et al. 2006].

    chunk = ceil(R / (1.5 * P_active)) scaled by u ~ U[0.8, 1.2] (seeded);
    ``update(active_workers=...)`` feeds the expected number of workers that
    will compete for the remaining work.
    """

    monotonicity = "mixed"

    def __init__(self, n_tasks: int, n_workers: int, seed: int = 0):
        super().__init__(n_tasks, n_workers, seed)
        self._active = n_workers

    def update(self, **runtime_info) -> None:
        """Feed the expected number of ``active_workers`` competing for work."""
        a = runtime_info.get("active_workers")
        if a:
            self._active = max(1, int(a))

    def _chunk(self, remaining: int) -> int:
        u = float(self._rng.uniform(0.8, 1.2))
        return max(1, math.ceil(remaining / (1.5 * self._active) * u))


PARTITIONERS: dict[str, type[Partitioner]] = {
    "STATIC": Static,
    "SS": SelfScheduling,
    "MFSC": MFSC,
    "GSS": GSS,
    "TSS": TSS,
    "FAC2": FAC2,
    "TFSS": TFSS,
    "FISS": FISS,
    "VISS": VISS,
    "PLS": PLS,
    "PSS": PSS,
}


def make_partitioner(name: str, n_tasks: int, n_workers: int, seed: int = 0, **kw) -> Partitioner:
    """Build a partitioner by name from PARTITIONERS (DESIGN.md §2/§4)."""
    try:
        cls = PARTITIONERS[name.upper()]
    except KeyError:
        raise ValueError(
            f"unknown partitioner {name!r}; available: {sorted(PARTITIONERS)}"
        ) from None
    return cls(n_tasks, n_workers, seed=seed, **kw)


def chunk_sizes(name: str, n_tasks: int, n_workers: int, seed: int = 0, **kw) -> list[int]:
    """Materialize the full chunk-size sequence of a technique."""
    p = make_partitioner(name, n_tasks, n_workers, seed=seed, **kw)
    out = []
    while True:
        c = p.next_chunk()
        if c == 0:
            return out
        out.append(c)


_PSS_U0: dict[int, float] = {}  # first U[0.8,1.2] draw per seed


def first_chunk(name: str, n_tasks: int, n_workers: int, seed: int = 0) -> int:
    """Size of the FIRST chunk a fresh partitioner would hand out.

    Closed-form evaluation of ``make_partitioner(name, n_tasks, n_workers,
    seed).next_chunk()`` without constructing the partitioner (object +
    RNG construction cost ~3 us — too slow for the slot-array steal path,
    which recomputes the technique chunk against the victim's remaining
    work on every theft, DESIGN.md §16). Property-tested bit-equal to the
    real partitioners across techniques/sizes/seeds in
    tests/test_slot_queues.py.
    """
    r = int(n_tasks)
    P = int(n_workers)
    if r <= 0:
        return 0
    name = name.upper()
    if name == "SS":
        return 1
    if name in ("STATIC", "GSS"):
        c = math.ceil(r / P)
    elif name == "MFSC":
        denom = max(1.0, math.ceil(math.log2(max(2.0, 2.0 * r / P))))
        c = max(1, math.ceil(r / (P * denom)))
    elif name in ("TSS", "FAC2"):
        c = max(1, math.ceil(r / (2 * P)))
    elif name == "TFSS":
        f = max(1, math.ceil(r / (2 * P)))
        C = max(1, math.ceil(2 * r / (f + 1)))
        d = (f - 1) / max(1, C - 1)
        sizes = [max(1, int(round(f - i * d))) for i in range(P)]
        c = max(1, int(round(sum(sizes) / len(sizes))))
    elif name == "FISS":
        c = max(1, math.ceil(r / ((2 + 4) * P)))
    elif name == "VISS":
        c = max(1, math.ceil(r / (4 * P)))
    elif name == "PLS":
        static_total = int(r * 0.5)
        if static_total:
            c = min(max(1, math.ceil(static_total / P)), static_total)
        else:
            c = max(1, math.ceil(r / P))
    elif name == "PSS":
        u = _PSS_U0.get(seed)
        if u is None:
            u = _PSS_U0[seed] = float(
                np.random.default_rng(seed).uniform(0.8, 1.2))
        c = max(1, math.ceil(r / (1.5 * P) * u))
    else:
        # unknown technique (e.g. future registrations): fall back to the
        # real object so behaviour stays correct, just slower
        return make_partitioner(name, r, P, seed=seed).next_chunk()
    return max(1, min(r, int(c)))


def first_chunk_fn(name: str, n_workers: int, seed: int = 0):
    """Specialized ``r -> first_chunk(name, r, n_workers, seed)`` closure.

    Binds the technique dispatch and (P, seed) constants once so the
    per-call work is pure arithmetic — the slot-array steal path calls
    this on every theft with a fresh remaining count, where even the
    name.upper() + branch chain of :func:`first_chunk` is measurable
    (~0.5 us against a ~4 us steal budget, DESIGN.md §16).
    """
    P = int(n_workers)
    ceil = math.ceil
    name = name.upper()
    if name == "SS":
        return lambda r: 1 if r > 0 else 0
    if name in ("STATIC", "GSS"):
        return lambda r: min(r, ceil(r / P)) if r > 0 else 0
    if name in ("TSS", "FAC2"):
        P2 = 2 * P
        return lambda r: min(r, max(1, ceil(r / P2))) if r > 0 else 0
    if name == "FISS":
        P6 = 6 * P
        return lambda r: min(r, max(1, ceil(r / P6))) if r > 0 else 0
    if name == "VISS":
        P4 = 4 * P
        return lambda r: min(r, max(1, ceil(r / P4))) if r > 0 else 0
    if name == "MFSC":
        log2 = math.log2

        def _mfsc(r):
            if r <= 0:
                return 0
            denom = max(1.0, ceil(log2(max(2.0, 2.0 * r / P))))
            return min(r, max(1, ceil(r / (P * denom))))

        return _mfsc
    if name == "PSS":
        u = _PSS_U0.get(seed)
        if u is None:
            u = _PSS_U0[seed] = float(
                np.random.default_rng(seed).uniform(0.8, 1.2))
        P15 = 1.5 * P
        return lambda r: min(r, max(1, ceil(r / P15 * u))) if r > 0 else 0
    # TFSS, PLS, and unknown techniques: the generic path is already
    # correct and these are not steal-heavy in practice
    return lambda r: first_chunk(name, r, P, seed=seed)


def chunk_schedule(
    name: str, n_tasks: int, n_workers: int, seed: int = 0, **kw
) -> np.ndarray:
    """Full schedule as an ``(n_chunks, 2) int32`` array of (start, size).

    This is the host-side product consumed by the device path
    (device_schedule.py / the cc_propagate kernel): the queue is frozen
    into a task table before the launch.
    """
    sizes = chunk_sizes(name, n_tasks, n_workers, seed=seed, **kw)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]) if sizes else np.zeros(0)
    return np.stack([starts, sizes], axis=1).astype(np.int32)
