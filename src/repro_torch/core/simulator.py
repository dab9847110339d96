"""Discrete-event simulator for DaphneSched on P workers (numpy only).

Replays measured or modelled per-task costs through a discrete-event model
of the scheduler with calibrated overheads, so scheduling options can be
searched in milliseconds instead of run:

  h_access    time a queue access holds the queue (lock hold time)
  h_local     access time on a worker's own queue (no shared lock)
  h_probe     cost to probe a victim queue
  numa_mult   multiplier on probe/steal cost across NUMA domains
  locality_penalty  multiplicative task-cost penalty when a worker executes a
                    task NOT contiguous with its previously executed range
  h_launch    the walker's launch overhead (frozen super-table replay)

The queue is a serially-reusable resource: accesses queue up (models lock
contention — the paper's "SS explodes" effect emerges naturally).

``simulate`` models one flat batch (technique x layout x victim),
``simulate_dag`` a pipeline DAG on the shared host pool or, with
``frozen``, the walker draining a super-table in one launch;
``frozen_dag_makespans`` compares that fused launch with one launch per
stage, and ``simulate_server`` many tenants' jobs on one shared pool
under the server's arbiters. Results are pure functions of the costs and
the seed: the same inputs give the same virtual times to the bit.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field

import numpy as np

from .device_schedule import DeviceDagTables, build_dag_tables_cached
from .online import ChunkObservation
from .partitioners import chunk_schedule, first_chunk_fn, make_partitioner
from .victim import make_victim_selector

__all__ = ["SimOverheads", "SimResult", "simulate", "DagSimResult",
           "simulate_dag", "frozen_dag_makespans", "ServerSimResult",
           "simulate_server", "DagStats", "stats_from_events"]


@dataclass
class DagStats:
    """Per-stage chunk accounting shared by the host and simulated paths.

    One entry per stage: executed seconds (``exec_s``, locality penalties
    included), seconds spent waiting on queue locks (``queue_wait_s``),
    seconds spent moving rows across the host<->device boundary
    (``transfer_s`` — virtual time in the simulators; 0.0 on the real
    host pool, where a cross-substrate consumption is counted in
    ``transfers`` but the copy is not separately timed), and the chunk /
    transfer counts. The reconciliation invariants these totals satisfy
    against the makespan are asserted in ``tests/test_torch_sim.py``.
    """

    exec_s: dict[str, float] = field(default_factory=dict)
    queue_wait_s: dict[str, float] = field(default_factory=dict)
    transfer_s: dict[str, float] = field(default_factory=dict)
    chunks: dict[str, int] = field(default_factory=dict)
    transfers: dict[str, int] = field(default_factory=dict)

    def add_chunk(self, stage: str, exec_s: float, wait_s: float = 0.0) -> None:
        """Fold one executed chunk into the per-stage totals."""
        self.exec_s[stage] = self.exec_s.get(stage, 0.0) + exec_s
        self.queue_wait_s[stage] = self.queue_wait_s.get(stage, 0.0) + wait_s
        self.chunks[stage] = self.chunks.get(stage, 0) + 1

    def add_transfer(self, stage: str, seconds: float) -> None:
        """Fold one cross-substrate transfer (charged to the consumer)."""
        self.transfer_s[stage] = self.transfer_s.get(stage, 0.0) + seconds
        self.transfers[stage] = self.transfers.get(stage, 0) + 1

    @property
    def total_exec_s(self) -> float:
        """Summed executed seconds over all stages."""
        return sum(self.exec_s.values())

    @property
    def total_queue_wait_s(self) -> float:
        """Summed queue-wait seconds over all stages."""
        return sum(self.queue_wait_s.values())

    @property
    def total_transfer_s(self) -> float:
        """Summed transfer seconds over all stages."""
        return sum(self.transfer_s.values())

    @property
    def total_chunks(self) -> int:
        """Total chunk count over all stages."""
        return sum(self.chunks.values())


def stats_from_events(events) -> DagStats:
    """Build DagStats from a TaskEvent timeline (the host executors' path).

    Exec time is each event's span, queue wait its measured ``wait_s``;
    transfer counts are left to the caller (the hetero executor folds its
    cross-substrate consumption counts in afterwards).
    """
    stats = DagStats()
    raw = getattr(events, "iter_stat_tuples", None)
    if raw is not None:
        # EventLog fast path: aggregate off the raw tuples without
        # materializing per-event dataclasses
        for stage, exec_s, wait_s in raw():
            stats.add_chunk(stage, exec_s, wait_s)
        return stats
    for ev in events:
        stats.add_chunk(ev.stage, ev.t_end - ev.t_start,
                        getattr(ev, "wait_s", 0.0))
    return stats


@dataclass(frozen=True)
class SimOverheads:
    """Calibrated queue/locality overheads of the discrete-event model."""

    h_access: float = 5e-6     # centralized / shared queue access (lock hold)
    h_local: float = 1e-6      # own-queue access
    h_probe: float = 2e-6      # victim probe
    numa_mult: float = 3.0     # cross-NUMA probe/steal multiplier
    locality_penalty: float = 0.3  # +30% task cost on non-contiguous access
    h_launch: float = 5e-5     # device kernel-launch overhead (frozen replay)


@dataclass
class SimResult:
    """Virtual-time outcome of one flat-batch simulation."""

    makespan: float
    per_worker_busy: list[float]
    per_worker_finish: list[float]
    steals: int = 0
    queue_wait: float = 0.0    # total time spent waiting on queue locks

    @property
    def load_imbalance(self) -> float:
        """(max - mean) / max of per-worker finish times (0 = balanced)."""
        mx = max(self.per_worker_finish)
        mean = sum(self.per_worker_finish) / len(self.per_worker_finish)
        return (mx - mean) / mx if mx else 0.0


class _SimQueue:
    """A lock-protected queue in virtual time, on a slot-array buffer.

    Task indices live in a preallocated int32 buffer with head/tail
    cursors (the slot-array layout of core/queues.py): ``pop_head(c)`` /
    ``pop_tail(c)`` are O(1) cursor bumps returning ascending index slices
    — ``pop_tail`` IS the steal primitive (a tail slice is already in
    original ascending order, no per-item pop+reverse).
    """

    __slots__ = ("idx", "head", "tail", "busy_until")

    def __init__(self, n: int = 0):
        self.idx = np.empty(n, dtype=np.int32)
        self.head = 0
        self.tail = 0
        self.busy_until = 0.0

    def fill(self, lo: int, hi: int) -> None:
        """Append the contiguous index run [lo, hi) at the tail."""
        c = hi - lo
        if c <= 0:
            return
        if self.tail + c > len(self.idx):
            grown = np.empty(max(16, 2 * (self.tail + c)), dtype=np.int32)
            grown[:self.tail] = self.idx[:self.tail]
            self.idx = grown
        self.idx[self.tail:self.tail + c] = np.arange(lo, hi, dtype=np.int32)
        self.tail += c

    def __len__(self) -> int:
        return self.tail - self.head

    def pop_head(self, c: int) -> np.ndarray:
        """Take ``c`` indices off the head (a worker's local FIFO pop)."""
        h = self.head
        self.head = h + c
        return self.idx[h:h + c]

    def pop_tail(self, c: int) -> np.ndarray:
        """Cut ``c`` indices off the tail — the steal run, ascending."""
        s = self.tail - c
        self.tail = s
        return self.idx[s:s + c]

    def access(self, t: float, hold: float) -> float:
        """Serialize an access starting at time t; return completion time."""
        start = max(t, self.busy_until)
        self.busy_until = start + hold
        return start + hold


def _exec_cost(costs, idx, last_end, ov):
    """Task cost with locality penalty if not contiguous with last range."""
    c = float(costs[idx])
    if last_end is not None and idx != last_end:
        c *= 1.0 + ov.locality_penalty
    return c


def simulate(
    task_costs: np.ndarray,
    technique: str = "STATIC",
    queue_layout: str = "CENTRALIZED",
    victim_strategy: str = "SEQ",
    n_workers: int = 20,
    numa_domains: list[int] | None = None,
    overheads: SimOverheads = SimOverheads(),
    seed: int = 0,
) -> SimResult:
    """Simulate one execution; returns makespan and per-worker stats."""
    n = len(task_costs)
    ov = overheads
    domains = numa_domains if numa_domains is not None else [0] * n_workers
    layout = queue_layout.upper()
    busy = [0.0] * n_workers
    finish = [0.0] * n_workers
    last_end: list[int | None] = [None] * n_workers
    queue_wait = 0.0
    steals = 0

    if layout == "CENTRALIZED":
        part = make_partitioner(technique, n, n_workers, seed=seed)
        q = _SimQueue()
        next_task = 0
        # workers request chunks in virtual-time order
        heap = [(0.0, w) for w in range(n_workers)]
        heapq.heapify(heap)
        while heap:
            t, w = heapq.heappop(heap)
            if next_task >= n:
                finish[w] = max(finish[w], t)
                continue
            t_acc = q.access(t, ov.h_access)
            queue_wait += (t_acc - ov.h_access) - t if t_acc - ov.h_access > t else 0.0
            c = part.next_chunk(w)
            c = min(c, n - next_task)
            if c <= 0:
                finish[w] = max(finish[w], t_acc)
                continue
            dt = 0.0
            for i in range(next_task, next_task + c):
                cost = _exec_cost(task_costs, i, last_end[w], ov)
                dt += cost
                last_end[w] = i + 1
            next_task += c
            busy[w] += dt
            finish[w] = t_acc + dt
            heapq.heappush(heap, (t_acc + dt, w))
        return SimResult(max(finish), busy, finish, steals=0, queue_wait=queue_wait)

    # ---- distributed queues (PERCORE / PERGROUP) ------------------------------
    if layout == "PERCORE":
        n_queues = n_workers
        home = list(range(n_workers))
        sel_domains = domains
    elif layout == "PERGROUP":
        n_queues = max(domains) + 1
        home = domains
        sel_domains = list(range(n_queues))
    else:
        raise ValueError(f"unknown layout {queue_layout}")

    queues = [_SimQueue() for _ in range(n_queues)]
    if layout == "PERGROUP":
        # pre-partition into contiguous blocks per group (locality), chunked
        # within each block: granularity shrinks by 1/#groups (paper Fig 8b).
        block = -(-n // n_queues)
        for qi in range(n_queues):
            queues[qi].fill(qi * block, min(n, (qi + 1) * block))
    else:
        # global chunk sequence dealt round-robin (no pre-partitioning)
        part = make_partitioner(technique, n, n_workers, seed=seed)
        i, qi = 0, 0
        while i < n:
            c = part.next_chunk()
            if c == 0:
                break
            queues[qi % n_queues].fill(i, min(n, i + c))
            i += c
            qi += 1

    selector = make_victim_selector(victim_strategy, n_queues, sel_domains, seed=seed)
    # per-queue pop partitioners: popping from one's own queue also follows
    # the technique (self-scheduling within the queue)
    pop_parts = [
        make_partitioner(technique, max(1, len(q)), n_workers, seed=seed + 17 * qi)
        for qi, q in enumerate(queues)
    ]
    # steal amounts are a fresh partitioner's first chunk against the
    # victim's remaining count — a pure function of (technique, r, P,
    # seed), evaluated closed-form (bit-equal, see partitioners.first_chunk)
    steal_chunk = first_chunk_fn(technique, n_workers, seed=seed)

    heap = [(0.0, w) for w in range(n_workers)]
    heapq.heapify(heap)
    remaining = n
    done_workers = 0
    while heap and remaining > 0:
        t, w = heapq.heappop(heap)
        hq = home[w]
        q = queues[hq]
        got = None
        if len(q):
            t = q.access(t, ov.h_local if layout == "PERCORE" else ov.h_access)
            c = max(1, min(len(q), pop_parts[hq].next_chunk(w)))
            got = q.pop_head(c)
        else:
            # steal: probe victims in strategy order; amount follows technique
            thief_dom = domains[w] if layout == "PERCORE" else home[w]
            for victim in selector.candidates(hq):
                vdom = sel_domains[victim]
                mult = 1.0 if vdom == thief_dom else ov.numa_mult
                t += ov.h_probe * mult
                vq = queues[victim]
                r = len(vq)
                if r:
                    t = vq.access(t, ov.h_access * mult)
                    c = max(1, min(r, steal_chunk(r)))
                    got = vq.pop_tail(c)  # tail run, already ascending
                    steals += 1
                    break
        if got is None:
            finish[w] = max(finish[w], t)
            done_workers += 1
            continue
        dt = 0.0
        for i in got:
            cost = _exec_cost(task_costs, i, last_end[w], ov)
            dt += cost
            last_end[w] = i + 1
        remaining -= len(got)
        busy[w] += dt
        finish[w] = t + dt
        heapq.heappush(heap, (t + dt, w))

    # drain workers still in the heap
    while heap:
        t, w = heapq.heappop(heap)
        finish[w] = max(finish[w], t)
    return SimResult(max(finish), busy, finish, steals=steals, queue_wait=queue_wait)


# ---------------------------------------------------------------------------
# pipeline-DAG makespan simulation (per-stage auto-tuning search target)
# ---------------------------------------------------------------------------

@dataclass
class DagSimResult:
    """Virtual-time outcome of one simulate_dag replay."""

    makespan: float
    per_worker_busy: list[float]
    stage_start: dict[str, float]
    stage_finish: dict[str, float]
    queue_wait: float = 0.0
    stats: DagStats | None = None

    def overlap_s(self, a: str, b: str) -> float:
        """Virtual seconds during which stages ``a`` and ``b`` were both active."""
        return max(0.0, min(self.stage_finish[a], self.stage_finish[b])
                   - max(self.stage_start[a], self.stage_start[b]))


class _SimStage:
    """Virtual-time state of one DAG stage."""

    __slots__ = ("name", "deps", "chunks", "chunk_cost", "ptr", "row_time",
                 "layout", "queue", "start", "finish", "max_end", "last_end",
                 "resizes")

    def __init__(self, name, deps, schedule, costs, layout):
        self.name = name
        self.deps = deps                      # list of (producer, kind)
        self.chunks = [(int(s), int(z)) for s, z in schedule]
        self.chunk_cost = [float(costs[s:s + z].sum()) for s, z in self.chunks]
        self.ptr = 0                          # FIFO head (mirrors the executor)
        self.row_time = np.full(len(costs), np.inf)  # completion time per row
        self.layout = layout
        self.queue = _SimQueue()
        self.start = math.inf
        self.finish = math.inf
        self.max_end = 0.0                    # latest chunk completion so far
        self.last_end: dict[int, int] = {}    # per-worker locality tracking
        self.resizes = 0                      # moldable interventions (budget)


def _combo_of(cfg) -> tuple[str, str, str]:
    if isinstance(cfg, tuple):
        return cfg
    return (cfg.technique, cfg.queue_layout, cfg.victim_strategy)


def _pop_chunk(st: _SimStage, w: int, t: float, ov: SimOverheads):
    """Advance ``st``'s FIFO head for worker ``w`` at virtual time ``t``:
    serialize the queue access, apply the locality penalty, and fill the
    row/stage completion state. Returns
    (task_id, start, size, cost, t_acc, t_end, queue_wait). Stage finish
    is the max chunk end, not the last pop's end — an earlier-popped chunk
    can outlive the final pop.
    """
    s, z = st.chunks[st.ptr]
    cost = st.chunk_cost[st.ptr]
    tid = st.ptr
    st.ptr += 1
    hold = ov.h_access if st.layout == "CENTRALIZED" else ov.h_local
    t_acc = st.queue.access(t, hold)
    wait = max(0.0, (t_acc - hold) - t)
    if st.last_end.get(w) is not None and st.last_end[w] != s:
        cost *= 1.0 + ov.locality_penalty
    st.last_end[w] = s + z
    t_end = t_acc + cost
    st.row_time[s:s + z] = t_end
    st.start = min(st.start, t)
    st.max_end = max(st.max_end, t_end)
    if st.ptr == len(st.chunks):
        st.finish = st.max_end
    return tid, s, z, cost, t_acc, t_end, wait


def _resolve_row_costs(dag, stage_costs) -> dict[str, np.ndarray]:
    """Per-row cost vector per stage: given, else cost_of_range, else unit."""
    out = {}
    for n in dag.stage_names:
        st = dag.stages[n]
        given = (stage_costs or {}).get(n)
        if given is not None:
            costs = np.asarray(given, dtype=float)
        elif st.cost_of_range is not None:
            costs = np.array([st.cost_of_range(i, 1) for i in range(st.n_rows)],
                             dtype=float)
        else:
            costs = np.ones(st.n_rows)
        if len(costs) != st.n_rows:
            raise ValueError(f"stage {n!r}: {len(costs)} costs for {st.n_rows} rows")
        out[n] = costs
    return out


def _simulate_frozen(ddt: DeviceDagTables, costs: dict[str, np.ndarray],
                     ov: SimOverheads, tracer=None) -> DagSimResult:
    """Replay per-shard super-tables: the device walker in virtual time.

    Each shard drains its frozen slot sequence with no queue (h_local per
    slot models the table-step overhead, h_launch the single fused
    launch); the makespan is the slowest shard. Slot order already
    encodes the DAG's edges (build_dag_tables), so no gating is needed.
    """
    from .telemetry import F_DEVICE, as_tracer

    tracer = as_tracer(tracer)
    traced = tracer.enabled
    tjob = tracer.job
    names = list(ddt.stage_names)
    start = {n: math.inf for n in names}
    finish = {n: 0.0 for n in names}
    busy = [0.0] * ddt.n_shards
    shard_end = [0.0] * ddt.n_shards
    stats = DagStats()
    for sh in range(ddt.n_shards):
        t = ov.h_launch
        for slot, (sid, s0, z) in enumerate(ddt.slots(sh)):
            name = names[sid]
            c = float(costs[name][s0:s0 + z].sum())
            start[name] = min(start[name], t)
            t0 = t
            t += ov.h_local + c
            finish[name] = max(finish[name], t)
            busy[sh] += c
            stats.add_chunk(name, c)
            if traced:
                tracer.record_raw("exec", tjob, name, slot, sh, t0, t,
                                  F_DEVICE, 0.0, f"rows={s0}:{s0 + z}")
        shard_end[sh] = t
    return DagSimResult(
        makespan=max(shard_end, default=0.0), per_worker_busy=busy,
        stage_start={n: (0.0 if math.isinf(start[n]) else start[n])
                     for n in names},
        stage_finish=dict(finish), queue_wait=0.0, stats=stats)


def frozen_dag_makespans(
    ddt: DeviceDagTables,
    costs: dict[str, np.ndarray],
    overheads: SimOverheads = SimOverheads(),
) -> tuple[float, float]:
    """(fused, per-stage-launch) virtual makespans of one super-table.

    Fused: one launch drains every shard's whole table; makespan is
    h_launch + the slowest shard. Sequential: one launch PER STAGE with a
    barrier between launches (the stagewise walk) — each stage pays
    its own h_launch and waits for its slowest shard. Since
    max-of-sums <= sum-of-maxes and the fused path pays h_launch once,
    fused <= sequential always (the ``device_dag_linreg`` CI gate).
    """
    names = list(ddt.stage_names)
    ov = overheads
    shard_total = np.zeros(ddt.n_shards)
    stage_shard = np.zeros((len(names), ddt.n_shards))
    for sh in range(ddt.n_shards):
        for sid, s0, z in ddt.slots(sh):
            c = ov.h_local + float(costs[names[sid]][s0:s0 + z].sum())
            shard_total[sh] += c
            stage_shard[sid, sh] += c
    fused = ov.h_launch + float(shard_total.max(initial=0.0))
    sequential = sum(ov.h_launch + float(stage_shard[k].max(initial=0.0))
                     for k in range(len(names)))
    return fused, sequential


def simulate_dag(
    dag,
    stage_costs: dict[str, np.ndarray] | None = None,
    per_stage: dict[str, tuple] | tuple | None = None,
    n_workers: int = 20,
    overheads: SimOverheads = SimOverheads(),
    seed: int = 0,
    frozen: DeviceDagTables | bool | None = None,
    tile: int = 1,
    n_shards: int | None = None,
    online=None,
    tracer=None,
) -> DagSimResult:
    """Simulate a PipelineDAG run on ``n_workers`` shared workers.

    Mirrors PipelineExecutor's policy: per-stage chunk granularity from the
    stage's technique, FIFO head gating on dependencies (full = producer
    finished, elementwise = producer rows' completion times), and a rotating
    stage cursor per worker (streaming + branch interleaving). Queue-access
    overheads are serialized per stage: h_access for CENTRALIZED layouts,
    h_local for distributed ones; the locality penalty applies when a worker
    executes a chunk not contiguous with its previous range in that stage.

    ``per_stage`` maps stage name -> (technique, layout, victim) combo or
    SchedulerConfig; a single combo applies to every stage; None means each
    stage's own/dag default is STATIC/CENTRALIZED/SEQ.

    ``stage_costs`` entries are per-row cost vectors. A stage without an
    entry falls back to its own ``Stage.cost_of_range`` (evaluated per row),
    else to uniform unit costs.

    ``frozen`` switches to the DEVICE path: pass a
    DeviceDagTables to replay it, or True to freeze the DAG here with
    ``build_dag_tables`` (techniques from ``per_stage`` — combos or
    bare technique strings — over ``n_shards`` shards, row tiles of
    ``tile``) and predict the fused-launch makespan of the walker
    instead of the host pool's.

    ``online`` (a core.online.OnlineScheduler) replays the runtime
    feedback loop in virtual time: every popped chunk is recorded as a
    ChunkObservation (virtual cost/clock), and the moldable resizer may
    re-chunk a stage's unpopped remainder mid-replay exactly as the real
    pool would — so selector/resizer convergence is testable
    deterministically. Not supported on the frozen device path (device
    tables are immutable by construction).

    ``tracer`` (a core.telemetry.Tracer) records one virtual-time exec
    span per chunk — same identity scheme as the real pool.
    """
    names = dag.stage_names
    if stage_costs is None:
        stage_costs = {}
    if per_stage is None:
        per_stage = {}
    if isinstance(per_stage, tuple):
        per_stage = {n: per_stage for n in names}

    if frozen is not None and frozen is not False:
        if online is not None:
            raise ValueError("online replay is host-pool only: frozen device "
                             "tables cannot be resized mid-run")
        row_costs = _resolve_row_costs(dag, stage_costs)
        if isinstance(frozen, DeviceDagTables):
            ddt = frozen
        else:
            techniques = {}
            for n in names:
                cfg = per_stage.get(n, "STATIC")
                techniques[n] = cfg if isinstance(cfg, str) else _combo_of(cfg)[0]
            ddt = build_dag_tables_cached(dag, tile, techniques,
                                          n_shards=n_shards or 1, seed=seed)
        return _simulate_frozen(ddt, row_costs, overheads, tracer=tracer)

    from .telemetry import as_tracer

    tracer = as_tracer(tracer)
    traced = tracer.enabled
    tjob = tracer.job
    row_costs = _resolve_row_costs(dag, stage_costs)
    stages: dict[str, _SimStage] = {}
    for n in names:
        st = dag.stages[n]
        combo = _combo_of(per_stage.get(n, ("STATIC", "CENTRALIZED", "SEQ")))
        tech, layout, _ = combo
        costs = row_costs[n]
        schedule = chunk_schedule(tech, st.n_rows, n_workers, seed=seed)
        stages[n] = _SimStage(n, [(d.producer, d.kind) for d in st.deps],
                              schedule, costs, layout.upper())
    order = [stages[n] for n in names]
    nstages = len(order)
    ov = overheads

    def head_ready_time(st: _SimStage) -> float:
        """Virtual time at which the FIFO-head chunk becomes runnable."""
        s, z = st.chunks[st.ptr]
        rt = 0.0
        for prod, kind in st.deps:
            p = stages[prod]
            if kind == "full":
                rt = max(rt, p.finish)
            else:
                seg = p.row_time[s:s + z]
                rt = max(rt, float(seg.max()) if len(seg) else 0.0)
        return rt

    heap: list[tuple[float, int]] = [(0.0, w) for w in range(n_workers)]
    heapq.heapify(heap)
    pending: list[int] = []
    cursor = [w % nstages for w in range(n_workers)]
    busy = [0.0] * n_workers
    queue_wait = 0.0
    stats = DagStats()
    last_completion = 0.0
    remaining = sum(len(st.chunks) for st in order)
    for st in order:
        if not st.chunks:
            st.start = st.finish = 0.0

    while remaining > 0:
        if not heap:
            raise RuntimeError("simulate_dag: no runnable chunk but work remains "
                               "(unsatisfiable dependency)")
        t, w = heapq.heappop(heap)
        taken = None
        for k in range(nstages):
            idx = (cursor[w] + k) % nstages
            st = order[idx]
            if st.ptr >= len(st.chunks):
                continue
            if head_ready_time(st) <= t:
                taken = (idx, st)
                break
        if taken is None:
            pending.append(w)
            continue
        idx, st = taken
        cursor[w] = (idx + 1) % nstages
        tid, s0, z0, cost, t_acc, t_end, wait = _pop_chunk(st, w, t, ov)
        queue_wait += wait
        stats.add_chunk(st.name, cost, wait)
        busy[w] += cost
        last_completion = max(last_completion, t_end)
        remaining -= 1
        if traced:
            tracer.record_raw("exec", tjob, st.name, tid, w, t_acc, t_end,
                              0, wait)
        heapq.heappush(heap, (t_end, w))
        if online is not None:
            online.record(ChunkObservation(st.name, tid, s0, z0, cost, w, t_end))
            if st.ptr < len(st.chunks) and online.may_resize(st.name,
                                                             st.resizes):
                plan = online.plan_resize(
                    st.name, st.chunks[st.ptr:], n_workers,
                    resizes_done=st.resizes)
                if plan:
                    rc = row_costs[st.name]
                    old = len(st.chunks) - st.ptr
                    st.chunks = st.chunks[:st.ptr] + [
                        (int(ps), int(pz)) for ps, pz in plan]
                    st.chunk_cost = st.chunk_cost[:st.ptr] + [
                        float(rc[ps:ps + pz].sum()) for ps, pz in plan]
                    st.resizes += 1
                    remaining += len(plan) - old
                    if traced:
                        tracer.mark("resize", t_end, tjob, st.name,
                                    detail=f"chunks={len(plan)}")
        # a take advances a FIFO head (and row fills become visible as the
        # clock reaches their t_end): re-scan parked workers now
        if pending:
            for pw in pending:
                heapq.heappush(heap, (t, pw))
            pending.clear()

    return DagSimResult(
        makespan=last_completion, per_worker_busy=busy,
        stage_start={n: (0.0 if math.isinf(stages[n].start) else stages[n].start)
                     for n in names},
        stage_finish={n: (0.0 if math.isinf(stages[n].finish) else stages[n].finish)
                      for n in names},
        queue_wait=queue_wait, stats=stats)


# ---------------------------------------------------------------------------
# multi-tenant serving simulation (inter-job arbiter policy search)
# ---------------------------------------------------------------------------

@dataclass
class ServerSimResult:
    """Virtual-time outcome of one simulate_server replay."""

    makespan: float                      # last job finish minus first arrival
    job_finish: dict[str, float]
    job_latency: dict[str, float]        # finish minus arrival, per job
    tenant_service: dict[str, float]
    per_worker_busy: list[float]
    events: list
    queue_wait: float = 0.0
    preemptions: list = field(default_factory=list)  # PreemptionEvents

    def latencies(self) -> dict[str, float]:
        """Job name -> latency in virtual seconds."""
        return dict(self.job_latency)

    def latency_percentile(self, q: float) -> float:
        """Percentile ``q`` (0-100) over per-job latencies."""
        return float(np.percentile(list(self.job_latency.values()), q))


def simulate_server(
    jobs,
    n_workers: int = 20,
    arbiter="fair",
    arbiter_kwargs: dict | None = None,
    overheads: SimOverheads = SimOverheads(),
    seed: int = 0,
    tracer=None,
) -> ServerSimResult:
    """Replay mixed Job arrivals through the serving runtime in virtual time.

    Mirrors core/server.py's PipelineServer policy exactly — the same
    Arbiter classes rank JobState records, intra-job scheduling follows
    each stage's (technique, layout) with FIFO-head dependency gating and
    rotating stage cursors (as in simulate_dag) — but against per-row cost
    vectors (``Job.stage_costs``, else ``Stage.cost_of_range``, else unit)
    instead of wall clocks, so arbiter policies and per-job configs can be
    searched in milliseconds. ``jobs`` are Submissions or
    core.server.Job records (both fine — this is the internal virtual-time
    surface the auto-tuners drive with Jobs directly); ``arbiter`` is a
    name in core.server.ARBITERS or an Arbiter instance (instances carry
    accounting state — pass a name to get a fresh one).

    The ``"preemptive"`` arbiter replays here too: park/resume
    decisions happen at the same chunk boundaries the threaded server
    sees (every ``order`` call), so preemption policies are tunable
    offline; the virtual-time ``PreemptionEvent`` log lands in
    ``ServerSimResult.preemptions``.
    """
    from .server import JobState, ServerTaskEvent, job_stage_costs, make_arbiter
    from .submit import Submission
    from .telemetry import as_tracer

    tracer = as_tracer(tracer)
    traced = tracer.enabled
    jobs = [j.to_job() if isinstance(j, Submission) else j for j in jobs]
    names = [j.name for j in jobs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate job names in {names}")
    arb = make_arbiter(arbiter, **(arbiter_kwargs or {}))
    states = [JobState(job=j, seq=i, arrival=float(j.arrival_s))
              for i, j in enumerate(jobs)]
    ov = overheads

    stages: dict[str, list[_SimStage]] = {}     # job -> topo-ordered stages
    by_name: dict[str, dict[str, _SimStage]] = {}
    job_left: dict[str, int] = {}
    for j in jobs:
        costs = job_stage_costs(j)
        per = dict(j.per_stage or {})
        jl = []
        for n in j.dag.stage_names:
            stage = j.dag.stages[n]
            combo = _combo_of(per.get(n) or stage.config
                              or ("STATIC", "CENTRALIZED", "SEQ"))
            tech, layout, _ = combo
            schedule = chunk_schedule(tech, stage.n_rows, n_workers, seed=seed)
            jl.append(_SimStage(n, [(d.producer, d.kind) for d in stage.deps],
                                schedule, costs[n], layout.upper()))
        stages[j.name] = jl
        by_name[j.name] = {st.name: st for st in jl}
        job_left[j.name] = sum(len(st.chunks) for st in jl)
        for st in jl:
            if not st.chunks:
                st.start = st.finish = 0.0

    job_end = {j.name: 0.0 for j in jobs}
    for js in states:
        if job_left[js.job.name] == 0:
            js.done, js.finish = True, js.arrival
            job_end[js.job.name] = js.arrival

    def head_ready(jname: str, st: _SimStage) -> float:
        """Virtual time at which this stage's FIFO-head chunk is runnable."""
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

    heap: list[tuple[float, int]] = [(0.0, w) for w in range(n_workers)]
    heapq.heapify(heap)
    pending: list[int] = []
    cursors: dict[tuple[int, int], int] = {}
    busy = [0.0] * n_workers
    events: list = []
    queue_wait = 0.0
    remaining = sum(job_left.values())

    while remaining > 0:
        if not heap:
            raise RuntimeError("simulate_server: no runnable chunk but work "
                               "remains (unsatisfiable dependency)")
        t, w = heapq.heappop(heap)
        admitted = [js for js in states if js.arrival <= t and not js.done]
        taken = None
        for js in arb.order(admitted, t):
            jl = stages[js.job.name]
            ns = len(jl)
            cur = cursors.get((w, js.seq), w % ns)
            for k in range(ns):
                idx = (cur + k) % ns
                st = jl[idx]
                if st.ptr >= len(st.chunks):
                    continue
                if head_ready(js.job.name, st) <= t:
                    taken = (js, idx, st)
                    break
            if taken is not None:
                break
        if taken is None:
            # wake at the next event that can change runnability: an
            # arrival, or an in-flight chunk completion gating some head
            wakes = [js.arrival for js in states if js.arrival > t]
            for js in states:
                if js.done or js.arrival > t:
                    continue
                for st in stages[js.job.name]:
                    if st.ptr < len(st.chunks):
                        hr = head_ready(js.job.name, st)
                        if math.isfinite(hr) and hr > t:
                            wakes.append(hr)
            if wakes:
                heapq.heappush(heap, (min(wakes), w))
            else:
                pending.append(w)
            continue
        js, idx, st = taken
        jname = js.job.name
        cursors[(w, js.seq)] = (idx + 1) % len(stages[jname])
        tid, s, z, cost, t_acc, t_end, wait = _pop_chunk(st, w, t, ov)
        queue_wait += wait
        arb.charge(js, cost, t_end)
        events.append(ServerTaskEvent(
            jname, js.job.tenant, st.name, tid, s, z, w, t_acc, t_end,
            False, js.boosted, wait))
        if traced:
            tracer.record_raw("exec", jname, st.name, tid, w, t_acc, t_end,
                              0, wait)
        busy[w] += cost
        job_left[jname] -= 1
        remaining -= 1
        job_end[jname] = max(job_end[jname], t_end)
        if job_left[jname] == 0:
            js.done = True
            js.finish = job_end[jname]
        heapq.heappush(heap, (t_end, w))
        if pending:
            for pw in pending:
                heapq.heappush(heap, (t, pw))
            pending.clear()

    tenant_service: dict[str, float] = {}
    for js in states:
        tenant_service[js.job.tenant] = (
            tenant_service.get(js.job.tenant, 0.0) + js.service)
    finishes = {js.job.name: float(js.finish) for js in states}
    arrivals = [js.arrival for js in states]
    preemptions = list(getattr(arb, "preemption_log", []))
    if traced:
        for p in preemptions:
            tracer.mark(p.kind, p.t, p.job, detail=p.reason)
    return ServerSimResult(
        makespan=(max(finishes.values()) - min(arrivals)) if states else 0.0,
        job_finish=finishes,
        job_latency={n: finishes[n] - a for n, a in
                     zip([js.job.name for js in states], arrivals)},
        tenant_service=tenant_service, per_worker_busy=busy,
        events=events, queue_wait=queue_wait,
        preemptions=preemptions)
