"""Heterogeneous placement: which substrate runs each pipeline stage.

The port's copy of the reference's ``core/placement.py``. Two execution
substrates — the host ``PipelineExecutor`` (dynamic queues, stealing,
streaming) and the device path (frozen super-tables drained by the walker
kernel) — and this module decides where a stage runs, overlaps the two,
and accounts for moving rows across the boundary:

  ``TransferModel``      the explicit host<->device transfer-cost term:
                         per-transfer latency plus rows x bytes/row over a
                         link bandwidth, serialized on one virtual link.
  ``HeteroCostModel``    per-substrate per-row stage cost vectors. Host
                         rates calibrate from ``FeedbackLog`` observations;
                         device rates come from measured walker times
                         (``device_costs``) or from ``simulate_dag`` frozen
                         replays of each stage's table (folding launch and
                         table-step overheads into the rate), scaled by a
                         measured or assumed device speedup.
  ``StagePlacement``     HOST, DEVICE, or SPLIT(device_fraction): a
                         row-range split of one stage across both
                         substrates (device takes the leading rows).
  ``simulate_hetero_dag``  virtual-time co-execution replay: ``n_workers``
                         host lanes plus one fused device lane share the
                         DAG, with per-chunk transfer events whenever a
                         consumer chunk needs rows the other substrate
                         produced. Bitwise the reference's virtual times.
  ``select_placement``   the transfer-aware solver: scores all-HOST and
                         all-DEVICE, starts from the better one, then
                         coordinate-descends per stage over
                         {HOST, DEVICE, SPLIT(f)} accepting only
                         improvements — so the chosen placement's simulated
                         makespan is never worse than min(host-only,
                         device-only).

``core/hetero.py`` executes a chosen placement (device super-table shards
concurrently with host chunk workers); ``core/autotune.py`` wraps the
solver as ``select_offline_hetero`` / ``tune_online_hetero``, and
``core/online.py:default_hetero_arms`` extends the bandit arms with the
substrate choice, which ``replay_online_hetero`` trains in virtual time.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field

import numpy as np

from .simulator import (
    DagStats,
    SimOverheads,
    _pop_chunk,
    _combo_of,
    _resolve_row_costs,
    _SimQueue,
    _SimStage,
)

__all__ = [
    "HOST", "DEVICE", "SPLIT", "TransferModel", "HeteroCostModel",
    "StagePlacement", "Placement", "TransferEvent", "HeteroSimResult",
    "calibrate_hetero_costs", "simulate_hetero_dag", "select_placement",
    "replay_online_hetero",
]

HOST = "host"
DEVICE = "device"
SPLIT = "split"


@dataclass(frozen=True)
class TransferModel:
    """The explicit host<->device transfer-cost term.

    A transfer of ``rows`` rows of stage ``stage`` costs
    ``latency_s + rows * bytes_per_row / (gb_per_s * 1e9)`` virtual
    seconds; ``bytes_per_row`` may be a per-stage dict. All transfers
    serialize on ONE virtual link (both directions), so placements that
    ping-pong rows across the boundary pay for it — the signal the
    solver's transfer awareness keys on.
    """

    latency_s: float = 2e-5
    bytes_per_row: float | dict[str, float] = 8.0
    gb_per_s: float = 8.0

    def seconds(self, stage: str, rows: int) -> float:
        """Virtual seconds to move ``rows`` rows of ``stage`` across."""
        if rows <= 0:
            return 0.0
        bpr = (self.bytes_per_row.get(stage, 8.0)
               if isinstance(self.bytes_per_row, dict)
               else float(self.bytes_per_row))
        return self.latency_s + rows * bpr / (self.gb_per_s * 1e9)


@dataclass(frozen=True)
class HeteroCostModel:
    """Per-substrate per-row stage cost vectors plus the transfer term.

    ``host[name]`` / ``device[name]`` are per-row seconds for stage
    ``name`` on the host pool / the device walker. Build by hand for
    synthetic studies or with ``calibrate_hetero_costs`` from runtime
    feedback + frozen-replay makespans.
    """

    host: dict[str, np.ndarray]
    device: dict[str, np.ndarray]
    transfer: TransferModel = field(default_factory=TransferModel)


@dataclass(frozen=True)
class StagePlacement:
    """Where one stage runs: HOST, DEVICE, or SPLIT(device_fraction).

    SPLIT is a row-range split of the stage across both substrates: the
    device takes the LEADING ``device_fraction`` of the rows (matching
    super-table ascending-tile order), the host pool the rest.
    """

    substrate: str
    device_fraction: float = 0.0

    def __post_init__(self):
        if self.substrate not in (HOST, DEVICE, SPLIT):
            raise ValueError(f"unknown substrate {self.substrate!r}")
        if self.substrate == SPLIT and not 0.0 < self.device_fraction < 1.0:
            raise ValueError(
                f"SPLIT needs device_fraction in (0, 1), got "
                f"{self.device_fraction}")

    def device_rows(self, n_rows: int) -> int:
        """Rows [0, k) the device owns under this placement."""
        if self.substrate == HOST:
            return 0
        if self.substrate == DEVICE:
            return n_rows
        k = int(round(self.device_fraction * n_rows))
        return min(max(k, 1), n_rows - 1)


class Placement:
    """A per-stage substrate assignment for one PipelineDAG."""

    def __init__(self, stages: dict[str, StagePlacement]):
        self.stages = dict(stages)

    def __getitem__(self, name: str) -> StagePlacement:
        return self.stages[name]

    def get(self, name: str) -> StagePlacement:
        """The stage's placement (stages not mentioned default to HOST)."""
        return self.stages.get(name, StagePlacement(HOST))

    def device_rows(self, name: str, n_rows: int) -> int:
        """Rows [0, k) of stage ``name`` the device owns."""
        return self.get(name).device_rows(n_rows)

    @classmethod
    def all_host(cls, names) -> "Placement":
        """Every stage on the host pool (the PipelineExecutor path)."""
        return cls({n: StagePlacement(HOST) for n in names})

    @classmethod
    def all_device(cls, names) -> "Placement":
        """Every stage on the device walker (one fused walk)."""
        return cls({n: StagePlacement(DEVICE) for n in names})

    def describe(self) -> str:
        """Compact one-line tag (for bench rows / logs)."""
        parts = []
        for n, p in self.stages.items():
            if p.substrate == SPLIT:
                parts.append(f"{n}=split{p.device_fraction:.2f}")
            else:
                parts.append(f"{n}={p.substrate}")
        return " ".join(parts)

    def __repr__(self):
        return f"Placement({self.describe()})"


@dataclass(frozen=True)
class TransferEvent:
    """One host<->device row movement on the virtual timeline."""

    producer: str
    consumer: str
    rows: int
    t_start: float
    t_end: float
    to_device: bool


@dataclass
class HeteroSimResult:
    """Virtual-time outcome of one simulate_hetero_dag co-execution replay.

    ``per_worker_busy`` lists the host lanes first, the device lane last.
    """

    makespan: float
    per_worker_busy: list[float]
    stage_start: dict[str, float]
    stage_finish: dict[str, float]
    queue_wait: float
    transfer_s: float
    transfer_events: list[TransferEvent]
    stats: DagStats
    placement: Placement

    def overlap_s(self, a: str, b: str) -> float:
        """Virtual seconds during which stages ``a`` and ``b`` overlapped."""
        return max(0.0, min(self.stage_finish[a], self.stage_finish[b])
                   - max(self.stage_start[a], self.stage_start[b]))


def calibrate_hetero_costs(
    dag,
    feedback=None,
    host_costs: dict[str, np.ndarray] | None = None,
    device_costs: dict[str, np.ndarray] | None = None,
    device_speedup: float | dict[str, float] = 1.0,
    tile: int = 1,
    transfer: TransferModel | None = None,
    overheads: SimOverheads = SimOverheads(),
    seed: int = 0,
) -> HeteroCostModel:
    """Build a HeteroCostModel from runtime feedback + frozen replays.

    Host per-row rates: an explicit ``host_costs`` entry wins, else the
    stage's observed per-row rate from ``feedback`` (a FeedbackLog),
    else ``Stage.cost_of_range``, else unit costs. Device per-row rates:
    an explicit ``device_costs`` entry wins; otherwise the host rate is
    divided by ``device_speedup`` (float or per-stage dict — the measured
    or assumed accelerator throughput advantage) and then CALIBRATED
    against a ``simulate_dag(frozen=True)`` replay of the stage's own
    single-stage super-table: the fused makespan (which folds ``h_launch``
    and the per-slot ``h_local`` table-step overhead into virtual time)
    divided by the row count becomes the uniform device rate. Stages a
    frozen table cannot represent keep the scaled host rate.
    """
    import dataclasses as _dc

    from .dag import PipelineDAG
    from .simulator import simulate_dag

    host = dict(_resolve_row_costs(dag, host_costs))
    if feedback is not None:
        for n in dag.stage_names:
            if host_costs is not None and n in host_costs:
                continue
            fb = feedback.stage(n)
            if fb is not None and fb.n > 0 and fb.rate_mean > 0:
                host[n] = np.full(dag.stages[n].n_rows, fb.rate_mean)
    device: dict[str, np.ndarray] = {}
    for n in dag.stage_names:
        if device_costs is not None and n in device_costs:
            device[n] = np.asarray(device_costs[n], dtype=float)
            continue
        speed = (device_speedup.get(n, 1.0)
                 if isinstance(device_speedup, dict) else float(device_speedup))
        scaled = host[n] / max(speed, 1e-12)
        rows = dag.stages[n].n_rows
        if rows > 0 and rows % max(1, tile) == 0:
            solo = PipelineDAG([_dc.replace(dag.stages[n], deps=())])
            ms = simulate_dag(solo, {n: scaled}, frozen=True, tile=tile,
                              overheads=overheads, seed=seed).makespan
            device[n] = np.full(rows, ms / rows)
        else:
            device[n] = scaled
    return HeteroCostModel(host=host, device=device,
                           transfer=transfer or TransferModel())


def _as_cost_model(dag, costs) -> HeteroCostModel:
    """Coerce a plain per-row dict into a HeteroCostModel (same rates)."""
    if isinstance(costs, HeteroCostModel):
        return costs
    host = _resolve_row_costs(dag, costs)
    return HeteroCostModel(host=host, device=dict(host))


def simulate_hetero_dag(
    dag,
    costs,
    placement: Placement,
    stage_configs: dict[str, tuple] | tuple | None = None,
    n_workers: int = 20,
    overheads: SimOverheads = SimOverheads(),
    seed: int = 0,
) -> HeteroSimResult:
    """Co-execution replay: host lanes and one device lane share the DAG.

    ``n_workers`` host lanes run each stage's host row range exactly as
    ``simulate_dag`` would (per-stage technique chunking, FIFO-head
    dependency gating, rotating stage cursors, queue-access overheads,
    locality penalty). One additional DEVICE lane — the fused walker —
    drains every stage's device range in super-table order: ``h_launch``
    once, ``h_local`` per slot, slots chunked by the stage's technique
    and consumed ascending with the same rotating-cursor streaming.

    Transfers: a chunk whose dependency rows were produced on the OTHER
    substrate pays the ``TransferModel`` cost before executing, serialized
    on one virtual link. Elementwise edges transfer per consumer chunk
    (streaming across the boundary); full edges materialize the producer's
    foreign part once per direction and are cached. ``costs`` is a
    HeteroCostModel (or a plain per-row dict, applied to both substrates
    with a default TransferModel).
    """
    cm = _as_cost_model(dag, costs)
    names = dag.stage_names
    if stage_configs is None:
        stage_configs = {}
    if isinstance(stage_configs, tuple):
        stage_configs = {n: stage_configs for n in names}
    ov = overheads
    xfer = cm.transfer

    from .partitioners import chunk_schedule

    split_k: dict[str, int] = {}
    host_st: dict[str, _SimStage] = {}
    dev_st: dict[str, _SimStage] = {}
    deps = {n: [(d.producer, d.kind) for d in dag.stages[n].deps]
            for n in names}
    for n in names:
        st = dag.stages[n]
        combo = _combo_of(stage_configs.get(n, ("STATIC", "CENTRALIZED", "SEQ")))
        tech, layout, _ = combo
        k = placement.device_rows(n, st.n_rows)
        split_k[n] = k
        shared_rows = np.full(st.n_rows, np.inf)
        if st.n_rows - k > 0:
            sched = chunk_schedule(tech, st.n_rows - k, n_workers, seed=seed)
            sched = np.asarray(sched).reshape(-1, 2).copy()
            sched[:, 0] += k
            hs = _SimStage(n, deps[n], sched, cm.host[n], layout.upper())
            hs.row_time = shared_rows
            host_st[n] = hs
        if k > 0:
            dsched = chunk_schedule(tech, k, n_workers, seed=seed)
            ds = _SimStage(n, deps[n], dsched, cm.device[n], "PERCORE")
            ds.row_time = shared_rows
            dev_st[n] = ds

    def side_finish(name: str) -> float:
        """Combined finish of a stage: both present sides must be done."""
        f = 0.0
        for side in (host_st, dev_st):
            st = side.get(name)
            if st is not None:
                f = max(f, st.finish)
        return f

    def head_ready(st: _SimStage) -> float:
        """Virtual time this side's FIFO-head chunk becomes runnable
        (transfer delays are applied at pop, not here)."""
        s, z = st.chunks[st.ptr]
        rt = 0.0
        for prod, kind in st.deps:
            if kind == "full":
                rt = max(rt, side_finish(prod))
            else:
                seg = (host_st.get(prod) or dev_st[prod]).row_time[s:s + z]
                rt = max(rt, float(seg.max()) if len(seg) else 0.0)
        return rt

    def foreign_rows(consumer_is_dev: bool, prod: str, s: int, z: int,
                     kind: str) -> int:
        """Rows of ``prod`` the consumer needs from the other substrate."""
        kp = split_k[prod]
        if kind == "full":
            n_p = dag.stages[prod].n_rows
            return (n_p - kp) if consumer_is_dev else kp
        if consumer_is_dev:
            return max(0, (s + z) - max(s, kp))
        return max(0, min(s + z, kp) - s)

    link = _SimQueue()
    materialized: dict[tuple[str, bool], float] = {}
    transfer_events: list[TransferEvent] = []
    transfer_total = 0.0
    stats = DagStats()

    def apply_transfers(t: float, st: _SimStage, consumer_is_dev: bool) -> float:
        """Serialize this chunk's cross-substrate inputs on the link."""
        nonlocal transfer_total
        s, z = st.chunks[st.ptr]
        for prod, kind in st.deps:
            rows = foreign_rows(consumer_is_dev, prod, s, z, kind)
            if rows <= 0:
                continue
            if kind == "full":
                key = (prod, consumer_is_dev)
                if key not in materialized:
                    dur = xfer.seconds(prod, rows)
                    done = link.access(t, dur)
                    materialized[key] = done
                    transfer_events.append(TransferEvent(
                        prod, st.name, rows, done - dur, done, consumer_is_dev))
                    transfer_total += dur
                    stats.add_transfer(st.name, dur)
                t = max(t, materialized[key])
            else:
                dur = xfer.seconds(prod, rows)
                done = link.access(t, dur)
                transfer_events.append(TransferEvent(
                    prod, st.name, rows, done - dur, done, consumer_is_dev))
                transfer_total += dur
                stats.add_transfer(st.name, dur)
                t = done
        return t

    dev_lane = n_workers
    heap: list[tuple[float, int]] = [(0.0, w) for w in range(n_workers)]
    if dev_st:
        heap.append((ov.h_launch, dev_lane))
    heapq.heapify(heap)
    pending: list[int] = []
    side_order = {False: [host_st[n] for n in names if n in host_st],
                  True: [dev_st[n] for n in names if n in dev_st]}
    cursor: dict[int, int] = {}
    busy = [0.0] * (n_workers + 1)
    queue_wait = 0.0
    last_completion = 0.0
    remaining = sum(len(st.chunks) for sts in (host_st, dev_st)
                    for st in sts.values())
    for sts in (host_st, dev_st):
        for st in sts.values():
            if not st.chunks:
                st.start = st.finish = 0.0

    while remaining > 0:
        if not heap:
            raise RuntimeError("simulate_hetero_dag: no runnable chunk but "
                               "work remains (unsatisfiable dependency)")
        t, lane = heapq.heappop(heap)
        is_dev = lane == dev_lane
        order = side_order[is_dev]
        if not order:
            continue
        taken = None
        cur = cursor.get(lane, lane % len(order))
        for kk in range(len(order)):
            idx = (cur + kk) % len(order)
            st = order[idx]
            if st.ptr >= len(st.chunks):
                continue
            if head_ready(st) <= t:
                taken = (idx, st)
                break
        if taken is None:
            wakes = [head_ready(st) for st in order
                     if st.ptr < len(st.chunks)]
            wakes = [wt for wt in wakes if math.isfinite(wt) and wt > t]
            if wakes:
                heapq.heappush(heap, (min(wakes), lane))
            else:
                pending.append(lane)
            continue
        idx, st = taken
        cursor[lane] = (idx + 1) % len(order)
        # the device lane's per-slot table step is _pop_chunk's h_local
        # queue hold (its layout is distributed, its queue uncontended)
        t_x = apply_transfers(t, st, is_dev)
        tid, s0, z0, cost, _, t_end, wait = _pop_chunk(st, lane, t_x, ov)
        queue_wait += wait
        stats.add_chunk(st.name, cost, wait)
        busy[lane] += cost
        last_completion = max(last_completion, t_end)
        remaining -= 1
        heapq.heappush(heap, (t_end, lane))
        if pending:
            for pl in pending:
                heapq.heappush(heap, (t, pl))
            pending.clear()

    stage_start, stage_finish = {}, {}
    for n in names:
        starts = [st.start for st in (host_st.get(n), dev_st.get(n))
                  if st is not None]
        ends = [st.max_end for st in (host_st.get(n), dev_st.get(n))
                if st is not None]
        stage_start[n] = min([s for s in starts if math.isfinite(s)],
                             default=0.0)
        stage_finish[n] = max(ends, default=0.0)
    return HeteroSimResult(
        makespan=last_completion, per_worker_busy=busy,
        stage_start=stage_start, stage_finish=stage_finish,
        queue_wait=queue_wait, transfer_s=transfer_total,
        transfer_events=transfer_events, stats=stats, placement=placement)


def select_placement(
    dag,
    costs,
    n_workers: int = 20,
    stage_configs: dict[str, tuple] | tuple | None = None,
    fractions: tuple[float, ...] = (0.25, 0.5, 0.75),
    passes: int = 2,
    overheads: SimOverheads = SimOverheads(),
    seed: int = 0,
) -> tuple[Placement, float, dict[str, float]]:
    """Transfer-aware placement search over the stage DAG.

    Scores the two homogeneous placements first (all-HOST — the host
    pool — and all-DEVICE — the fused walker), starts from the better one,
    then coordinate-descends per stage over {HOST, DEVICE, SPLIT(f) for f
    in ``fractions``} with ``simulate_hetero_dag`` as the objective,
    accepting only improvements. The returned placement's simulated
    makespan is therefore NEVER worse than min(host-only, device-only),
    and strictly better whenever stages have opposite substrate
    affinities (the transfer term keeps the solver from ping-ponging rows
    across the boundary to get there).

    Returns ``(placement, makespan, baselines)`` with ``baselines`` the
    {"host": .., "device": ..} homogeneous makespans.
    """
    names = list(dag.stage_names)
    cm = _as_cost_model(dag, costs)

    def score(pl: Placement) -> float:
        """Simulated co-execution makespan of one placement."""
        return simulate_hetero_dag(
            dag, cm, pl, stage_configs=stage_configs, n_workers=n_workers,
            overheads=overheads, seed=seed).makespan

    baselines = {HOST: score(Placement.all_host(names)),
                 DEVICE: score(Placement.all_device(names))}
    start_sub = HOST if baselines[HOST] <= baselines[DEVICE] else DEVICE
    assign = {n: StagePlacement(start_sub) for n in names}
    best = baselines[start_sub]
    candidates = [StagePlacement(HOST), StagePlacement(DEVICE)]
    candidates += [StagePlacement(SPLIT, f) for f in fractions]

    for _ in range(max(1, passes)):
        improved = False
        for n in names:
            for cand in candidates:
                if cand == assign[n]:
                    continue
                trial = dict(assign)
                trial[n] = cand
                v = score(Placement(trial))
                if v < best:
                    best, assign, improved = v, trial, True
        if not improved:
            break
    return Placement(assign), best, baselines


def replay_online_hetero(
    dag,
    costs,
    online,
    rounds: int,
    n_workers: int = 20,
    overheads: SimOverheads | None = None,
    seed: int = 0,
):
    """Train an OnlineScheduler whose arms carry a substrate choice.

    The feedback loop over ``default_hetero_arms``: each round ONE
    focus stage (rotating round-robin, the DagTuner discipline) consults
    its bandit for a ``(technique, layout, victim, substrate)`` arm while
    the other stages play their current best, the round replays with
    ``simulate_hetero_dag`` under the implied placement, and the focus
    stage's realized span — now attributable, because concurrent
    exploration can't serialize every stage onto the device lane at once
    and poison each other's substrate rewards — is credited to its arm.
    The focus stage's bandit plays all its arms within
    ``n_stages * n_arms`` rounds. Returns the per-round OnlineRound
    history (combos hold the 4-tuple arms; the MAKESPAN rewards only the
    focus stage).
    """
    from .online import OnlineRound

    cm = _as_cost_model(dag, costs)
    ov = overheads if overheads is not None else SimOverheads()
    names = list(dag.stage_names)
    history: list[OnlineRound] = []
    for r in range(max(1, rounds)):
        focus = names[r % len(names)]
        choice = online.suggest(focus)
        combos = dict(online.best_combos(names))
        combos[focus] = choice.combo
        placement = Placement({
            n: StagePlacement(DEVICE if c[3] == DEVICE else HOST)
            for n, c in combos.items()})
        cfgs = {n: c[:3] for n, c in combos.items()}
        res = simulate_hetero_dag(dag, cm, placement, stage_configs=cfgs,
                                  n_workers=n_workers, overheads=ov,
                                  seed=seed)
        spans = {n: max(0.0, res.stage_finish[n] - res.stage_start[n])
                 for n in names}
        rows = max(1, dag.stages[focus].n_rows)
        span = spans[focus]
        online.observe(choice, (span if span > 0 else res.makespan) / rows)
        history.append(OnlineRound(dict(combos), res.makespan, spans))
    return history
