"""Static DLS task tables and pipeline-DAG super-tables (numpy only).

The GPU has no device-side dynamic queues for the walker either, so the
schedule is frozen on the host: the same 11 chunk formulas
(core/partitioners.py) produce a task table ``(n_chunks, 2) = (start,
size)``, chunks are assigned to shards round-robin (the centralized-queue
analogue) or in contiguous runs (the PERGROUP analogue), and a pipeline
DAG is merged into per-shard ``(stage, start, size)`` super-tables that
the walker kernel (kernels/dag_walk.py) drains in one launch per shard.

Work stealing becomes persistent re-balancing: after a walk each shard
reports its measured load, and ``rebalance`` / ``rebalance_dag`` shift
chunks from overloaded to underloaded shards (nearest first) for the next
walk. ``device_walk_spans`` folds the walker's stamp buffer (one
``(stage, start, size, slot)`` row a slot) into the tracer's device spans.

All tables are padded to a fixed slot count; padding rows have size 0 and
are skipped by the walker.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .partitioners import chunk_schedule

__all__ = [
    "build_task_table",
    "assign_chunks",
    "per_shard_tables",
    "cost_balanced_assignment",
    "rebalance",
    "DeviceDagTables",
    "build_dag_tables",
    "dag_signature",
    "build_dag_tables_cached",
    "dag_table_cache_stats",
    "clear_dag_table_cache",
    "device_walk_spans",
    "rebalance_dag",
]


def build_task_table(
    technique: str,
    n_rows: int,
    n_workers: int,
    max_chunks: int | None = None,
    seed: int = 0,
) -> np.ndarray:
    """(max_chunks, 2) int32 (start, size) table; padded with size-0 rows."""
    table = chunk_schedule(technique, n_rows, n_workers, seed=seed)
    if max_chunks is None:
        max_chunks = len(table)
    if len(table) > max_chunks:
        raise ValueError(
            f"technique {technique} produced {len(table)} chunks > max_chunks={max_chunks}"
        )
    out = np.zeros((max_chunks, 2), dtype=np.int32)
    out[: len(table)] = table
    return out


def assign_chunks(
    n_chunks: int, n_shards: int, mode: str = "roundrobin"
) -> np.ndarray:
    """Chunk -> shard assignment. 'roundrobin' interleaves (centralized-queue
    analogue); 'contiguous' gives each shard a run (PERGROUP locality
    analogue)."""
    idx = np.arange(n_chunks)
    if mode == "roundrobin":
        return (idx % n_shards).astype(np.int32)
    if mode == "contiguous":
        per = -(-n_chunks // n_shards)
        return np.minimum(idx // per, n_shards - 1).astype(np.int32)
    raise ValueError(f"unknown assignment mode {mode!r}")


def per_shard_tables(
    table: np.ndarray, assignment: np.ndarray, n_shards: int
) -> np.ndarray:
    """Stack per-shard task tables, padded to the max chunks/shard.

    Returns (n_shards, max_per_shard, 2) int32 — the input each shard_map
    body receives (its frozen work queue).
    """
    groups = [table[assignment == s] for s in range(n_shards)]
    m = max((len(g) for g in groups), default=0)
    out = np.zeros((n_shards, max(1, m), 2), dtype=np.int32)
    for s, g in enumerate(groups):
        out[s, : len(g)] = g
    return out


def cost_balanced_assignment(
    table: np.ndarray, chunk_costs: np.ndarray, n_shards: int
) -> np.ndarray:
    """Greedy LPT assignment by measured/estimated chunk cost.

    The beyond-paper auto path: when per-chunk costs are known (e.g. nnz per
    row-block), longest-processing-time-first beats both round-robin and
    contiguous for skewed sparse inputs.
    """
    n = len(table)
    order = np.argsort(-np.asarray(chunk_costs[:n], dtype=np.float64))
    load = np.zeros(n_shards)
    assign = np.zeros(n, dtype=np.int32)
    for c in order:
        s = int(np.argmin(load))
        assign[c] = s
        load[s] += float(chunk_costs[c])
    return assign


def rebalance(
    assignment: np.ndarray,
    measured_load: np.ndarray,
    chunk_costs: np.ndarray,
    neighbors_first: np.ndarray | None = None,
    max_moves: int = 8,
) -> np.ndarray:
    """Persistent-stealing step: move chunks from the most- to the
    least-loaded shard, preferring moves to neighbouring shards.

    ``measured_load``: per-shard load from the previous step (summed on
    the device, fed back on the host). ``neighbors_first``: (n_shards, n_shards)
    preference matrix (smaller = closer); defaults to ring distance.
    Returns the updated chunk->shard assignment for the next step.
    """
    assignment = assignment.copy()
    n_shards = len(measured_load)
    load = np.asarray(measured_load, dtype=np.float64).copy()
    if neighbors_first is None:
        i = np.arange(n_shards)
        neighbors_first = np.minimum(
            np.abs(i[:, None] - i[None, :]),
            n_shards - np.abs(i[:, None] - i[None, :]),
        )
    for _ in range(max_moves):
        src = int(np.argmax(load))
        mean = load.mean()
        if load[src] <= 1.05 * mean:  # within 5% of balance: stop
            break
        # candidate destinations: underloaded, nearest first (SEQPRI analogue)
        dsts = sorted(
            (s for s in range(n_shards) if load[s] < mean),
            key=lambda s: neighbors_first[src, s],
        )
        if not dsts:
            break
        dst = dsts[0]
        # steal from the tail of src's chunks (paper: thief pops victim tail)
        src_chunks = np.where(assignment == src)[0]
        if len(src_chunks) <= 1:
            load[src] = -np.inf  # cannot shed further
            continue
        c = src_chunks[-1]
        assignment[c] = dst
        delta = float(chunk_costs[c])
        load[src] -= delta
        load[dst] += delta
    return assignment


# ---------------------------------------------------------------------------
# pipeline-DAG lowering: per-stage frozen tables merged into super-tables
# (DESIGN.md §11 — the device analogue of the §9 streaming executor)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DeviceDagTables:
    """A PipelineDAG frozen into per-shard (stage, start, size) super-tables.

    ``tables`` is ``(n_shards, max_slots, 3) int32``; each row is one
    row-tile of work: the stage id (index into ``stage_names``, topological
    order), the tile's start row, and its row count (0 = padding slot).
    Slot order within a shard encodes the §9 dependency semantics at trace
    time: an elementwise consumer tile's slot follows its producer tile's
    slot, and a full-dep consumer's slots follow ALL producer slots — so a
    sequential walker draining the table (kernels/dag_walk.py) streams the
    whole DAG in one launch.

    ``stage_chunks`` keeps the technique's chunk granularity per stage (in
    tile units) and ``chunk_shard`` the chunk -> shard assignment — the
    migration unit for re-balancing between iterations.
    """

    tables: np.ndarray                       # (n_shards, max_slots, 3) int32
    stage_names: tuple[str, ...]             # topological order == stage ids
    tile: int
    techniques: dict[str, str]
    stage_chunks: dict[str, np.ndarray]      # (n_chunks, 2) int32, tile units
    chunk_shard: dict[str, np.ndarray]       # (n_chunks,) int32
    deps: dict[str, tuple[tuple[str, str], ...]]  # consumer -> ((prod, kind),)
    seed: int = 0                            # chunk_schedule seed (rebuilds)
    n_workers: int = 1                       # chunk_schedule worker count

    @property
    def n_shards(self) -> int:
        """Number of per-shard super-tables."""
        return int(self.tables.shape[0])

    def slots(self, shard: int) -> np.ndarray:
        """The non-padding slots of ``shard``, in walk order."""
        t = self.tables[shard]
        return t[t[:, 2] > 0]

    def stage_rows(self, name: str) -> int:
        """Row count of stage ``name`` (tiles x tile size)."""
        return int(self.stage_chunks[name][:, 1].sum()) * self.tile


def _dag_chunk_assignment(
    names: list[str],
    n_tiles: dict[str, int],
    deps: dict[str, tuple[tuple[str, str], ...]],
    techniques: dict[str, str],
    n_shards: int,
    n_workers: int,
    assignment: str,
    chunk_costs: dict[str, np.ndarray] | None,
    seed: int,
    root_assign: dict[str, np.ndarray] | None = None,
) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """Chunk each stage with its technique and assign chunks to shards.

    Root stages (no elementwise dep) get ``assignment`` mode (or LPT when
    ``chunk_costs`` has an entry, or an explicit ``root_assign`` override
    from a re-balancing pass). Elementwise consumers are row-aligned: every
    consumer tile lands on the shard owning the producer tile with the same
    index, splitting chunks at owner boundaries — within-shard slot order
    is then sufficient to honour the edge. Returns
    (stage_chunks, chunk_shard), both keyed by stage name.
    """
    stage_chunks: dict[str, np.ndarray] = {}
    chunk_shard: dict[str, np.ndarray] = {}
    tile_owner: dict[str, np.ndarray] = {}
    for si, name in enumerate(names):
        sched = chunk_schedule(techniques[name], n_tiles[name], n_workers,
                               seed=seed + si).astype(np.int32)
        ew = [p for p, k in deps[name] if k == "elementwise"]
        if ew:
            owner = tile_owner[ew[0]]
            for other in ew[1:]:
                if not np.array_equal(tile_owner[other], owner):
                    raise ValueError(
                        f"stage {name!r}: elementwise producers {ew[0]!r} and "
                        f"{other!r} assign tiles to different shards; multiple "
                        "elementwise deps need identically-sharded producers "
                        "(same technique/assignment, or n_shards=1)")
            # split chunks at producer-owner boundaries (row alignment)
            chunks, shards = [], []
            for s0, z in sched:
                t = int(s0)
                while t < s0 + z:
                    o = owner[t]
                    run = t
                    while run < s0 + z and owner[run] == o:
                        run += 1
                    chunks.append((t, run - t))
                    shards.append(int(o))
                    t = run
            stage_chunks[name] = np.array(chunks, dtype=np.int32).reshape(-1, 2)
            chunk_shard[name] = np.array(shards, dtype=np.int32)
        else:
            stage_chunks[name] = sched
            if root_assign is not None and name in root_assign:
                chunk_shard[name] = np.asarray(root_assign[name], np.int32)
            elif chunk_costs is not None and name in chunk_costs:
                per_row = np.asarray(chunk_costs[name], dtype=np.float64)
                cc = np.array([per_row[s:s + z].sum() for s, z in sched])
                chunk_shard[name] = cost_balanced_assignment(sched, cc, n_shards)
            else:
                chunk_shard[name] = assign_chunks(len(sched), n_shards,
                                                  assignment)
        own = np.empty(n_tiles[name], dtype=np.int32)
        for (s0, z), sh in zip(stage_chunks[name], chunk_shard[name]):
            own[s0:s0 + z] = sh
        tile_owner[name] = own
    return stage_chunks, chunk_shard


def _merge_shard_slots(
    names: list[str],
    deps: dict[str, tuple[tuple[str, str], ...]],
    stage_chunks: dict[str, np.ndarray],
    chunk_shard: dict[str, np.ndarray],
    tile: int,
    n_shards: int,
    max_slots: int | None,
) -> np.ndarray:
    """Greedy streaming merge of per-stage tile lists into super-tables.

    Mirrors the §9 executor's rotating stage cursor: emit the next ready
    tile of the cursor stage, then advance past it — so elementwise
    consumers drain eagerly behind their producers (streaming) and
    independent branches interleave. Readiness: elementwise = the producer
    tile with the same index was already emitted (same shard by
    row-alignment); full = the producer is fully emitted.
    """
    per_shard: list[list[tuple[int, int, int]]] = [[] for _ in range(n_shards)]
    for shard in range(n_shards):
        tiles = {
            n: [t for (s0, z), sh in zip(stage_chunks[n], chunk_shard[n])
                if sh == shard for t in range(int(s0), int(s0 + z))]
            for n in names
        }
        ptr = {n: 0 for n in names}
        emitted = {n: set() for n in names}

        def ready(n: str) -> bool:
            """Is stage ``n``'s next tile runnable on this shard?"""
            t = tiles[n][ptr[n]]
            for p, kind in deps[n]:
                if kind == "full":
                    if ptr[p] < len(tiles[p]):
                        return False
                elif t not in emitted[p]:
                    return False
            return True

        total = sum(len(v) for v in tiles.values())
        cursor = 0
        while sum(ptr.values()) < total:
            progressed = False
            for k in range(len(names)):
                idx = (cursor + k) % len(names)
                n = names[idx]
                if ptr[n] >= len(tiles[n]) or not ready(n):
                    continue
                t = tiles[n][ptr[n]]
                per_shard[shard].append((idx, t * tile, tile))
                emitted[n].add(t)
                ptr[n] += 1
                cursor = (idx + 1) % len(names)
                progressed = True
                break
            if not progressed:
                raise RuntimeError(
                    "build_dag_tables: no ready tile but work remains "
                    "(cross-shard dependency?)")
    m = max((len(s) for s in per_shard), default=0)
    if max_slots is None:
        max_slots = max(1, m)
    if m > max_slots:
        raise ValueError(f"{m} slots > max_slots={max_slots}")
    out = np.zeros((n_shards, max_slots, 3), dtype=np.int32)
    for shard, slots in enumerate(per_shard):
        for i, row in enumerate(slots):
            out[shard, i] = row
    return out


def build_dag_tables(
    dag,
    tile: int,
    stage_techniques: dict[str, str] | str | None = None,
    n_shards: int = 1,
    n_workers: int | None = None,
    assignment: str = "roundrobin",
    chunk_costs: dict[str, np.ndarray] | None = None,
    seed: int = 0,
    max_slots: int | None = None,
) -> DeviceDagTables:
    """Lower a §9 ``PipelineDAG`` into per-shard frozen super-tables.

    Each stage is chunked by its own technique (``stage_techniques`` maps
    stage name -> technique; a single string applies to all; default
    STATIC) over its row-tile count, then the stages' tiles are merged
    into one ``(stage, start, size)`` super-table per shard with slot
    ordering that honours the DAG's edges — the trace-time analogue of §9
    streaming, executable in ONE device launch by the walker kernel
    (kernels/dag_walk.py) instead of one launch per operator.

    Elementwise consumers are row-aligned with their producer's shard
    assignment (consumer chunks split at owner boundaries), so the edge
    holds per shard without cross-shard synchronization. Full (barrier)
    edges order ALL producer slots before the consumer's; they cannot be
    satisfied across concurrently-draining shards, so they require
    ``n_shards == 1`` — split the DAG at barrier edges to scale out.

    ``chunk_costs`` (per-row cost vectors, keyed by stage) switches root
    stages to cost-balanced LPT assignment. Every stage's row count must
    be a positive multiple of ``tile``.
    """
    names = list(dag.stage_names)
    if isinstance(stage_techniques, str):
        stage_techniques = {n: stage_techniques for n in names}
    techniques = {n: (stage_techniques or {}).get(n, "STATIC") for n in names}
    deps = {n: tuple((d.producer, d.kind) for d in dag.stages[n].deps)
            for n in names}
    n_tiles = {}
    for n in names:
        rows = dag.stages[n].n_rows
        if rows <= 0 or rows % tile:
            raise ValueError(
                f"stage {n!r}: n_rows={rows} must be a positive multiple of "
                f"tile={tile}")
        n_tiles[n] = rows // tile
        if n_shards > 1 and any(k == "full" for _, k in deps[n]):
            raise ValueError(
                f"stage {n!r} has a full dep: barrier edges need n_shards=1 "
                "(split the DAG at the barrier for multi-shard launches)")
    nw = n_workers or max(1, n_shards)
    stage_chunks, chunk_shard = _dag_chunk_assignment(
        names, n_tiles, deps, techniques, n_shards, nw, assignment,
        chunk_costs, seed)
    tables = _merge_shard_slots(names, deps, stage_chunks, chunk_shard, tile,
                                n_shards, max_slots)
    return DeviceDagTables(tables, tuple(names), tile, techniques,
                           stage_chunks, chunk_shard, deps, seed, nw)


def dag_signature(
    dag,
    tile: int,
    stage_techniques: dict[str, str] | str | None = None,
    n_shards: int = 1,
    n_workers: int | None = None,
    assignment: str = "roundrobin",
    chunk_costs: dict[str, np.ndarray] | None = None,
    seed: int = 0,
    max_slots: int | None = None,
) -> tuple:
    """Hashable identity of a ``build_dag_tables`` lowering.

    Two calls with equal signatures produce bit-identical super-tables:
    the signature captures everything the lowering reads — per-stage
    (name, row count, dep edges), the resolved technique map, and the
    shard-layout parameters. Stage ops and operand VALUES are excluded
    on purpose: the table freezes the schedule, not the data, which is
    why submissions sharing a front-door ``batch_signature`` (same DAG
    shape, different closures) also share a dag_signature and hit the
    same cached lowering.

    ``chunk_costs`` arrays are fingerprinted by content (they steer LPT
    assignment, so different costs mean a different table).
    """
    names = tuple(dag.stage_names)
    if isinstance(stage_techniques, str):
        tech = tuple((n, stage_techniques) for n in names)
    else:
        tech = tuple((n, (stage_techniques or {}).get(n, "STATIC"))
                     for n in names)
    shape = tuple(
        (n, int(dag.stages[n].n_rows),
         tuple((d.producer, d.kind) for d in dag.stages[n].deps))
        for n in names)
    costs = None
    if chunk_costs:
        costs = tuple(sorted(
            (n, np.asarray(v, dtype=np.float64).tobytes())
            for n, v in chunk_costs.items()))
    return (shape, int(tile), tech, int(n_shards),
            int(n_workers or max(1, n_shards)), str(assignment), costs,
            int(seed), None if max_slots is None else int(max_slots))


_DAG_TABLE_CACHE: dict[tuple, DeviceDagTables] = {}
_DAG_TABLE_STATS = {"hits": 0, "misses": 0}


def build_dag_tables_cached(
    dag,
    tile: int,
    stage_techniques: dict[str, str] | str | None = None,
    n_shards: int = 1,
    n_workers: int | None = None,
    assignment: str = "roundrobin",
    chunk_costs: dict[str, np.ndarray] | None = None,
    seed: int = 0,
    max_slots: int | None = None,
) -> DeviceDagTables:
    """``build_dag_tables`` memoized on ``dag_signature``.

    The serving front door relowers the SAME super-table for every job
    of a recurring shape (batched or not); the lowering is a pure
    function of the signature, so repeat jobs get the cached
    DeviceDagTables back in O(1) instead of re-running chunking + the
    streaming merge. Cached tables are marked read-only — callers that
    mutate (e.g. scaling slots to row space) must ``.copy()`` first,
    which the walker entry points already do.
    """
    key = dag_signature(dag, tile, stage_techniques, n_shards, n_workers,
                        assignment, chunk_costs, seed, max_slots)
    ddt = _DAG_TABLE_CACHE.get(key)
    if ddt is not None:
        _DAG_TABLE_STATS["hits"] += 1
        return ddt
    _DAG_TABLE_STATS["misses"] += 1
    ddt = build_dag_tables(dag, tile, stage_techniques, n_shards, n_workers,
                           assignment, chunk_costs, seed, max_slots)
    ddt.tables.setflags(write=False)
    _DAG_TABLE_CACHE[key] = ddt
    return ddt


def dag_table_cache_stats() -> dict:
    """Lowering-cache counters: ``{"hits", "misses", "size"}``."""
    return {**_DAG_TABLE_STATS, "size": len(_DAG_TABLE_CACHE)}


def clear_dag_table_cache() -> None:
    """Drop cached lowerings and reset the hit/miss counters."""
    _DAG_TABLE_CACHE.clear()
    _DAG_TABLE_STATS["hits"] = 0
    _DAG_TABLE_STATS["misses"] = 0


def device_walk_spans(
    stamps: np.ndarray,
    stage_names,
    tracer,
    lane: int = 0,
    job: str = "",
    row_costs: dict[str, np.ndarray] | None = None,
    h_local: float = 0.0,
    t0: float = 0.0,
) -> int:
    """Fold a ``dag_walk(stamp=True)`` event buffer into tracer spans.

    ``stamps`` is the ``(n_slots, 4) int32`` (stage_id, start, size,
    slot) buffer read back after the walk; slots execute sequentially on one
    walker lane, so each becomes one device exec span on a virtual
    clock: duration = the slot's row-cost sum (``row_costs`` per-stage
    vectors; unit cost per row when absent) plus ``h_local`` table-step
    overhead, starting at ``t0``. Spans carry ``F_DEVICE`` and the
    shared ``(job, stage, chunk=slot)`` identity. Returns the number of
    spans emitted (0 when the tracer is disabled).
    """
    from .telemetry import F_DEVICE, as_tracer

    tracer = as_tracer(tracer)
    if not tracer.enabled:
        return 0
    names = list(stage_names)
    tjob = job or tracer.job
    t = float(t0)
    rows = []
    for sid, s0, z, slot in np.asarray(stamps, dtype=np.int64):
        if z <= 0:
            continue
        name = names[int(sid)]
        if row_costs is not None and name in row_costs:
            cost = float(np.asarray(row_costs[name])[s0:s0 + z].sum())
        else:
            cost = float(z)
        t1 = t + h_local + cost
        rows.append(("exec", tjob, name, int(slot), lane, t, t1,
                     F_DEVICE, 0.0, f"rows={int(s0)}:{int(s0 + z)}"))
        t = t1
    tracer.extend_raw(rows)
    return len(rows)


def rebalance_dag(
    ddt: DeviceDagTables,
    measured: dict[str, np.ndarray],
    neighbors_first: np.ndarray | None = None,
    max_moves: int = 8,
    max_slots: int | None = None,
) -> DeviceDagTables:
    """Persistent re-balancing over per-(stage, chunk) measured loads.

    Generalizes ``rebalance`` from one flat chunk set to the whole DAG:
    ``measured`` maps stage name -> per-chunk load (aligned with
    ``ddt.stage_chunks``). Root stages migrate their chunks independently
    against the SHARED per-shard load (summed over all stages, so a shard
    hot on one stage sheds another stage's chunks too); elementwise
    consumers re-align to the new producer owners when the super-tables
    are rebuilt. Returns a new DeviceDagTables for the next iteration.
    """
    names = list(ddt.stage_names)
    n_shards = ddt.n_shards
    load = np.zeros(n_shards, dtype=np.float64)
    for n in names:
        costs = np.asarray(measured.get(n, np.ones(len(ddt.stage_chunks[n]))),
                           dtype=np.float64)
        for c, sh in enumerate(ddt.chunk_shard[n]):
            load[sh] += float(costs[c])
    root_assign: dict[str, np.ndarray] = {}
    for n in names:
        if any(k == "elementwise" for _, k in ddt.deps[n]):
            continue  # re-aligned to its producer at rebuild time
        costs = np.asarray(measured.get(n, np.ones(len(ddt.stage_chunks[n]))),
                           dtype=np.float64)
        new = rebalance(ddt.chunk_shard[n], load, costs,
                        neighbors_first=neighbors_first, max_moves=max_moves)
        for c, (old, sh) in enumerate(zip(ddt.chunk_shard[n], new)):
            if old != sh:
                load[old] -= float(costs[c])
                load[sh] += float(costs[c])
        root_assign[n] = new
    n_tiles = {n: int(ddt.stage_chunks[n][:, 1].sum()) for n in names}
    stage_chunks, chunk_shard = _dag_chunk_assignment(
        names, n_tiles, ddt.deps, ddt.techniques, n_shards, ddt.n_workers,
        "roundrobin", None, ddt.seed, root_assign=root_assign)
    tables = _merge_shard_slots(names, ddt.deps, stage_chunks, chunk_shard,
                                ddt.tile, n_shards, max_slots)
    return DeviceDagTables(tables, ddt.stage_names, ddt.tile, ddt.techniques,
                           stage_chunks, chunk_shard, ddt.deps,
                           ddt.seed, ddt.n_workers)
