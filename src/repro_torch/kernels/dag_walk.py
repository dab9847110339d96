"""Multi-stage DAG walker: one launch drains a whole super-table.

A pipeline-DAG super-table (core/device_schedule.py:build_dag_tables) is
``(n_slots, 3) = (stage, start, size)``. The walker visits the slots in
order (a shard draining its frozen queue); each slot runs the body of the
stage its id names over that slot's row tile:

* ``concat`` stages write their row tile of an ``(n_rows, ...)`` output;
* ``sum`` stages start from zero — or, for a stage resumed from a
  checkpoint, from its ``seed`` (the prefix accumulator) — and fold each
  tile's contribution in ascending slot order;
* a consumer reads its producer's output in the middle of the walk — its
  own row tile of a ``concat`` producer (``rows``) or the whole
  accumulator of a ``sum`` producer (``full``). build_dag_tables orders
  every consumer slot after the producer slots it reads, so what it reads
  is final.

Each ``WalkStage`` carries two forms of its body. ``body(ctx, ins, out)``
is plain PyTorch over tile views (``out`` is written in place); the plain
walker ``dag_walk_plain`` runs it on any device. ``device_body`` names the
body's CUDA counterpart in ``csrc/dag_walk.cu``, which holds one walker
template instantiated per program (linreg, recommendation, moe, cc); it
replaces the Pallas kernel ``repro/kernels/dag_walk.py:dag_walk``. A
stage with ``inner > 1`` steps runs on the CUDA walker only when its
device body loops over the inner steps itself (``INNER_BODIES``): the
slot's owner walks them in ascending order inside the slot, where the
Pallas grid had a second axis. The
source note there gives the kernel's design and its bound.

On the CUDA walker a float ``sum`` stage folds in two levels: groups of
the stage's consecutive slots fold in ascending order into partials, and
the partials fold in group order onto the buffer (zeros or the seed) at
the first grid barrier before a slot that reads the stage, or at the
launch end. ``fold_plan`` computes the groups, the pieces the CTAs take
and the fold points from the table alone, so the result does not depend
on the grid; the plain walker folds slot by slot. The CC program's int
count of its producer's rows is taken where those rows are written
(``count_fusion``), so a CC launch needs no grid barrier. The
recommendation program's ``scores`` reads ``item_norms`` through one
denominator an item (``DERIVED_READS``), computed once a launch: by the
fold that publishes ``item_norms``, or, when the launch does not fold it,
by a pass at the launch start behind one barrier (``FoldPlan.prepass``).

A batched walk (``vee/apps.py:merge_device_lowerings``) holds up to
``MAX_MEMBERS`` members of one program; each stage's ``member`` picks the
pointers and sizes its body runs with, so one launch drains the batch.

``dag_walk`` takes the plain walker for CPU tensors only. For CUDA tensors
it launches the kernel, or raises — naming the stage — when a stage has
no device body, when no compiled program runs the stages' bodies, when a
stage has inner steps its body does not loop over, or when a batch mixes
programs or has more than ``MAX_MEMBERS`` members.
"""

from __future__ import annotations

import ctypes
import dataclasses
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ._build import DAG_WALK, ptr, stream

__all__ = ["WalkOperand", "WalkStage", "WalkCtx", "dag_walk", "dag_walk_plain",
           "dag_walk_stagewise", "dag_walk_sharded", "cuda_program",
           "sync_flags", "count_fusion", "fold_plan", "FoldPlan", "FOLD_GROUPS",
           "FOLD_BODIES", "COUNTED_READS", "DERIVED_READS",
           "device_table_cache_stats", "clear_device_table_cache",
           "MAX_MEMBERS", "INNER_BODIES"]

#: most members one batched launch holds (``BatchPolicy.max_batch``)
MAX_MEMBERS = 8


# ---------------------------------------------------------------------------
# device-resident super-table cache
#
# The table is the one host->device transfer every launch pays even when
# the schedule is frozen (jobs of a recurring shape walk the SAME table).
# One cache, keyed by the table's content (shape + bytes, so a stale hit is
# impossible), keeps each table's device copy and, beside it, the CUDA
# walker's fold plan of each stage list that walked it: a walk repeated on
# the same table (a recurring job shape, a timing loop) pays neither the
# transfer nor the plan's numpy again. Least recently used entries go first.
# ---------------------------------------------------------------------------

_DEVICE_TABLE_CACHE: OrderedDict = OrderedDict()
_DEVICE_TABLE_CACHE_SIZE = 16
_DEVICE_TABLE_STATS = {"hits": 0, "misses": 0}


@dataclass(frozen=True)
class _DeviceTable:
    table: torch.Tensor      # int32 copy of the table on the device
    plans: dict              # stage signature -> _DevicePlan


@dataclass(frozen=True)
class _DevicePlan:
    ints: torch.Tensor       # body_of_sid, member_of_sid, then FoldPlan.packed()
    offs: tuple              # offsets of the 11 arrays in ``ints`` (-1: no counts)
    n_seg: int
    scratch: int             # floats of partials
    prepass: frozenset       # FoldPlan.prepass


def device_table_cache_stats() -> dict:
    """Device-table cache counters: ``{"hits", "misses", "size"}``."""
    return {**_DEVICE_TABLE_STATS, "size": len(_DEVICE_TABLE_CACHE)}


def clear_device_table_cache() -> None:
    """Drop device-resident tables and their plans; reset the counters."""
    _DEVICE_TABLE_CACHE.clear()
    _DEVICE_TABLE_STATS["hits"] = 0
    _DEVICE_TABLE_STATS["misses"] = 0


def _pinned_put(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """An int32 copy of ``host`` on ``device``; on a CUDA device issued with
    ``non_blocking=True`` from pinned memory, so it overlaps a running walk."""
    t = torch.from_numpy(np.array(host, dtype=np.int32))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _device_table(table: np.ndarray, device: torch.device) -> _DeviceTable:
    """The cache entry of a host super-table on ``device``: the copy
    happens once per distinct table, later launches reuse it."""
    key = (str(device), table.shape, table.tobytes())
    hit = _DEVICE_TABLE_CACHE.get(key)
    if hit is not None:
        _DEVICE_TABLE_STATS["hits"] += 1
        _DEVICE_TABLE_CACHE.move_to_end(key)
        return hit
    _DEVICE_TABLE_STATS["misses"] += 1
    entry = _DEVICE_TABLE_CACHE[key] = _DeviceTable(_pinned_put(table, device), {})
    while len(_DEVICE_TABLE_CACHE) > _DEVICE_TABLE_CACHE_SIZE:
        _DEVICE_TABLE_CACHE.popitem(last=False)
    return entry


def _device_plan(entry: _DeviceTable, stages: list, body_map: list, members: list,
                 table: np.ndarray, device: torch.device) -> _DevicePlan:
    """The device plan of ``table`` for ``stages`` (``body_map``: each
    stage's body index; ``members``: each stage's dense member), kept in
    the table's cache ``entry``."""
    sig = tuple((s.name, s.combine, str(s.out_dtype), tuple(s.out_shape), s.reads, b, m)
                for s, b, m in zip(stages, body_map, members))
    hit = entry.plans.get(sig)
    if hit is not None:
        return hit
    plan = fold_plan(stages, table)
    packed, offs = plan.packed()
    n = len(stages)
    ints = np.concatenate([np.asarray(body_map, dtype=np.int32),
                           np.asarray(members, dtype=np.int32), packed])
    offs = [0, n, *[2 * n + o for o in offs]]
    if not len(plan.counts):
        offs[-1] = -1                               # the kernel gets a null pointer
    dp = entry.plans[sig] = _DevicePlan(
        ints=_pinned_put(ints, device), offs=tuple(offs), n_seg=plan.n_seg,
        scratch=plan.scratch, prepass=frozenset(plan.prepass))
    return dp


@dataclass(frozen=True)
class WalkOperand:
    """One kernel input: a named tensor with per-axis block indexing.

    ``index`` kinds per axis: ``row`` (the slot's row tile — block index
    ``start // block``, clamped), ``tile`` (one entry per row tile — block
    index ``start // tile``, clamped: per-slot operands such as an
    expert's weights, passed once instead of repeated along the rows),
    ``inner`` (the inner step index, for stages that loop over column
    tiles), ``zero`` (whole axis in one block).
    """

    name: str
    block: tuple[int, ...]
    index: tuple[str, ...]

    def __post_init__(self):
        if len(self.block) != len(self.index):
            raise ValueError(f"operand {self.name!r}: block/index rank mismatch")
        bad = set(self.index) - {"row", "tile", "inner", "zero"}
        if bad:
            raise ValueError(f"operand {self.name!r}: unknown index kinds {bad}")


@dataclass(frozen=True)
class WalkStage:
    """One DAG stage lowered to a walker body.

    ``body(ctx, ins, out)`` is the plain PyTorch body: ``ins`` maps operand
    names and producer stage names (``reads``) to tile views, ``out`` is
    this stage's output block, written in place. ``combine`` is
    ``concat`` (row-blocked ``(n_rows, ...)`` output, each tile written by
    its slot) or ``sum`` (one accumulator, zero at the start, folded in
    slot order). ``reads`` entries are ``(producer, kind)`` with kind
    ``rows`` | ``full``. ``inner`` is how many inner steps the body uses.
    ``device_body`` names the CUDA body (``"linreg.moments"``, ...) that
    the kernel runs for this stage on a CUDA device; ``None`` means the
    stage runs only on the plain walker.

    ``seed`` names an entry of the walk's ``values`` that a ``sum``
    stage's accumulator starts from instead of zero: a checkpoint's
    ascending-prefix accumulator, so the walk continues the fold
    ``seed + tile_0 + tile_1 + ...`` (core/preempt.py:migrate_to_device).
    It must match ``out_shape`` / ``out_dtype`` and lie on the walk's
    device; the walkers raise otherwise.

    ``member`` is the stage's batch member (``merge_device_lowerings``
    numbers them from 0); the CUDA walker runs each member's bodies with
    that member's tensors. The plain walker does not read it.
    """

    name: str
    n_rows: int
    out_shape: tuple[int, ...]
    out_dtype: torch.dtype
    combine: str
    body: Callable
    operands: tuple[str, ...] = ()
    reads: tuple[tuple[str, str], ...] = ()
    inner: int = 1
    device_body: str | None = None
    seed: str | None = None
    member: int = 0

    def __post_init__(self):
        if self.combine not in ("concat", "sum"):
            raise ValueError(f"stage {self.name!r}: unknown combine {self.combine!r}")
        if self.combine == "concat" and self.out_shape[0] != self.n_rows:
            raise ValueError(
                f"stage {self.name!r}: concat out_shape {self.out_shape} must "
                f"lead with n_rows={self.n_rows}")
        for _, kind in self.reads:
            if kind not in ("rows", "full"):
                raise ValueError(f"stage {self.name!r}: unknown read kind {kind!r}")


@dataclass(frozen=True)
class WalkCtx:
    """Per-slot scalars handed to a stage body."""

    slot: int    # slot index in the table
    inner: int   # inner step index (column tile)
    start: int   # slot start row
    size: int    # slot row count


def _block(x: torch.Tensor, block: tuple[int, ...], kinds: tuple[str, ...],
           start: int, j: int, tile: int) -> torch.Tensor:
    """The view of ``x`` a slot's block index map selects (clamped)."""
    idx = []
    for a, kind in enumerate(kinds):
        nb = max(1, x.shape[a] // block[a])
        if kind == "row":
            b = min(start // block[a], nb - 1)
        elif kind == "tile":
            b = min(start // tile, nb - 1)
        elif kind == "inner":
            b = min(j, nb - 1)
        else:
            b = 0
        idx.append(slice(b * block[a], (b + 1) * block[a]))
    return x[tuple(idx)]


def _read_operand(stages_by_name: dict[str, WalkStage], prod: str, kind: str,
                  tile: int) -> WalkOperand:
    """Operand spec for reading producer ``prod``'s output as an input."""
    p = stages_by_name[prod]
    if kind == "rows":
        if p.combine != "concat":
            raise ValueError(f"rows-read of non-concat producer {prod!r}")
        block = (tile,) + tuple(p.out_shape[1:])
        index = ("row",) + ("zero",) * (len(p.out_shape) - 1)
    else:
        if p.combine != "sum":
            raise ValueError(
                f"full-read of concat producer {prod!r} needs a launch split "
                "(see build_dag_tables)")
        block = tuple(p.out_shape)
        index = ("zero",) * len(p.out_shape)
    return WalkOperand(prod, block, index)


def _out_spec(stage: WalkStage, tile: int) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """(block, index kinds) of a stage output buffer."""
    if stage.combine == "concat":
        return ((tile,) + tuple(stage.out_shape[1:]),
                ("row",) + ("zero",) * (len(stage.out_shape) - 1))
    return tuple(stage.out_shape), ("zero",) * len(stage.out_shape)


def _check_table(table) -> np.ndarray:
    table = np.ascontiguousarray(np.asarray(table, dtype=np.int32))
    if table.ndim != 2 or table.shape[1] != 3:
        raise ValueError(f"super-table must be (n_slots, 3), got {table.shape}")
    return table


def _walk_device(operands: list[WalkOperand], values: dict) -> torch.device:
    if operands:
        return values[operands[0].name].device
    return torch.device("cpu")


def _init_outs(stages: list[WalkStage], values: dict,
               device) -> dict[str, torch.Tensor]:
    """Each stage's output buffer: zeros, or a copy of its seed.

    Raises, naming the stage, for a seed on a stage that is not ``sum``,
    a seed missing from ``values``, and one whose shape, dtype or device
    differs from the output's.
    """
    outs = {}
    for s in stages:
        if s.seed is None:
            outs[s.name] = torch.zeros(s.out_shape, dtype=s.out_dtype,
                                       device=device)
            continue
        if s.combine != "sum":
            raise ValueError(f"stage {s.name!r}: only a sum stage can start "
                             f"from a seed, not a {s.combine!r} stage")
        if s.seed not in values:
            raise ValueError(f"stage {s.name!r}: seed {s.seed!r} is not in values")
        seed = values[s.seed]
        if tuple(seed.shape) != tuple(s.out_shape) or seed.dtype != s.out_dtype:
            raise ValueError(
                f"stage {s.name!r}: seed {s.seed!r} is {seed.dtype} "
                f"{tuple(seed.shape)}, the output {s.out_dtype} "
                f"{tuple(s.out_shape)}")
        if seed.device != device:
            raise ValueError(f"stage {s.name!r}: seed {s.seed!r} lies on "
                             f"{seed.device}, the walk on {device}")
        outs[s.name] = seed.clone(memory_format=torch.contiguous_format)
    return outs


def dag_walk_plain(
    stages: list[WalkStage],
    operands: list[WalkOperand],
    values: dict[str, torch.Tensor],
    table: np.ndarray,
    tile: int,
    stamp: bool = False,
):
    """The walker in plain PyTorch: each slot runs its stage's ``body``.

    Runs on whatever device ``values`` lie on. Same contract as
    ``dag_walk``.
    """
    table = _check_table(table)
    if len({s.name for s in stages}) != len(stages):
        raise ValueError("duplicate stage names")
    specs = {op.name: (op.block, op.index) for op in operands}
    outs = _init_outs(stages, values, _walk_device(operands, values))
    out_specs = {s.name: _out_spec(s, tile) for s in stages}
    stamps = np.zeros((len(table), 4), dtype=np.int32)
    for i, (sid, start, size) in enumerate(table.tolist()):
        stamps[i] = (sid, start, size, i)
        if size <= 0 or not 0 <= sid < len(stages):
            continue
        s = stages[sid]
        for j in range(s.inner):
            ins = {n: _block(values[n], *specs[n], start, j, tile)
                   for n in s.operands}
            for prod, _kind in s.reads:
                if prod in outs:
                    ins[prod] = _block(outs[prod], *out_specs[prod], start, j, tile)
                else:
                    ins[prod] = _block(values[prod], *specs[prod], start, j, tile)
            s.body(WalkCtx(i, j, start, size), ins,
                   _block(outs[s.name], *out_specs[s.name], start, j, tile))
    return (outs, stamps) if stamp else outs


# ---------------------------------------------------------------------------
# the CUDA walker: compiled programs and their argument lists
# ---------------------------------------------------------------------------

#: program -> its device bodies, in the order csrc/dag_walk.cu numbers them
_PROGRAMS = {
    "linreg": ("linreg.moments", "linreg.syrk_gemv"),
    "recommendation": ("recommendation.item_norms", "recommendation.user_bias",
                       "recommendation.scores"),
    "moe": ("moe.experts",),
    "cc": ("cc.propagate", "cc.changed"),
}

#: device bodies that loop over their stage's inner steps inside the slot
INNER_BODIES = frozenset({"cc.propagate"})

#: most feature columns the linreg program takes (csrc/dag_walk.cu: one
#: moments column a thread of 256)
LINREG_MAX_D = 256

#: device bodies of float sums: they run as partials and a fold (``FoldPlan``)
FOLD_BODIES = frozenset({"linreg.moments", "linreg.syrk_gemv",
                         "recommendation.item_norms"})


def _program_of(bodies: list[str]) -> str | None:
    """The program holding every body in ``bodies``, or None."""
    return next((p for p, known in _PROGRAMS.items()
                 if set(bodies) <= set(known)), None)


def cuda_program(stages: list[WalkStage]) -> tuple[str, list[int]]:
    """The compiled program that runs ``stages`` and its stage -> body map.

    Raises, naming the stage, when a stage has no device body, and when a
    stage has inner steps that its device body does not loop over (a body
    outside ``INNER_BODIES``). Raises when
    no single program holds every stage's body, when a member runs a body
    twice, and for a batch (stages of several ``member`` values) that
    mixes programs, whose members differ in their bodies, or that has more
    than ``MAX_MEMBERS`` members: each member must be one copy of the walk.
    """
    for s in stages:
        if s.device_body is None:
            raise ValueError(
                f"stage {s.name!r} has no device body: the CUDA walker cannot "
                "run it (use dag_walk_plain, or give it a device_body)")
        if s.inner != 1 and s.device_body not in INNER_BODIES:
            raise ValueError(
                f"stage {s.name!r} has {s.inner} inner steps, but its device "
                f"body {s.device_body!r} has no inner loop")
    if not stages:
        raise ValueError("no stages to walk")
    members = sorted({s.member for s in stages})
    if len(members) > MAX_MEMBERS:
        raise ValueError(f"a batch of {len(members)} members: one walker launch "
                         f"holds at most {MAX_MEMBERS}")
    prog = first = None
    for m in members:
        mine = [s for s in stages if s.member == m]
        bodies = [s.device_body for s in mine]
        p = _program_of(bodies)
        if p is None:
            home = _program_of(bodies[:1])
            odd = next(s for s in mine if s.device_body not in _PROGRAMS[home])
            raise ValueError(
                f"no compiled walker program runs the bodies {bodies}: stage "
                f"{odd.name!r} runs {odd.device_body!r}, not a body of stage "
                f"{mine[0].name!r}'s {home!r} program")
        if len(set(bodies)) != len(bodies):
            raise ValueError(f"device bodies repeat in one walk: {bodies}")
        if prog is None:
            prog, first = p, set(bodies)
        elif p != prog:
            raise ValueError(
                f"stage {mine[0].name!r} of member {m} runs the {p!r} program, "
                f"member 0 the {prog!r} program: a batch runs one program")
        elif set(bodies) != first:
            raise ValueError(
                f"stage {mine[0].name!r} of member {m}: member {m} runs the "
                f"bodies {sorted(bodies)}, member 0 {sorted(first)}; each "
                "member must be one copy of the walk")
    known = _PROGRAMS[prog]
    return prog, [known.index(s.device_body) for s in stages]


def sync_flags(stages: list[WalkStage], table: np.ndarray) -> np.ndarray:
    """Per slot: 1 where the kernel needs a grid barrier before the slot.

    A slot needs one when its stage reads a producer of this launch that
    some slot has written since the last barrier.
    """
    names = [s.name for s in stages]
    reads = [{names.index(p) for p, _ in s.reads if p in names} for s in stages]
    flags = np.zeros(len(table), dtype=np.uint8)
    real = np.flatnonzero((table[:, 2] > 0) & (table[:, 0] >= 0)
                          & (table[:, 0] < len(stages)))
    sids = table[real, 0]
    # within a run of one stage's slots only the first can need a barrier:
    # a stage never reads itself
    run_starts = np.flatnonzero(np.r_[True, sids[1:] != sids[:-1]]) \
        if len(sids) else ()
    dirty: set[int] = set()
    for r in run_starts:
        sid = int(sids[r])
        if reads[sid] & dirty:
            flags[real[r]] = 1
            dirty.clear()
        dirty.add(sid)
    return flags


#: (producer body, consumer body) of a ``rows`` edge whose consumer is an
#: exact int count over the producer's rows: the CC program's flip count
COUNTED_READS = frozenset({("cc.propagate", "cc.changed")})


def count_fusion(stages: list[WalkStage],
                 table: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per slot: where the CUDA walker counts a consumer in its producer's slot.

    For a ``rows`` edge of ``COUNTED_READS``, a consumer slot whose rows a
    producer slot earlier in the same table writes (same start and size)
    does no work of its own: the warps that write those rows add their
    flips to the count with integer atomics, exact in any order, so the
    consumer needs no grid barrier. A consumer slot whose rows were
    written in another launch (a stagewise walk, another shard) keeps its
    owner body. Returns ``(counts, skips)``, uint8 per slot: 1 on each
    producer slot that counts, and on each consumer slot it stands for.
    Computed from the table alone.
    """
    n = len(table)
    counts, skips = np.zeros(n, np.uint8), np.zeros(n, np.uint8)
    names = [s.name for s in stages]
    sid = table[:, 0]
    real = (table[:, 2] > 0) & (sid >= 0) & (sid < len(stages))
    for c, st in enumerate(stages):
        for prod, kind in st.reads:
            p = names.index(prod) if prod in names else -1
            if kind != "rows" or p < 0 or \
                    (stages[p].device_body, st.device_body) not in COUNTED_READS:
                continue
            written = {}                            # (start, size) -> producer slot
            for i in np.flatnonzero(real & ((sid == p) | (sid == c))):
                key = (int(table[i, 1]), int(table[i, 2]))
                if sid[i] == p:
                    written[key] = i
                elif key in written:
                    counts[written.pop(key)] = 1
                    skips[i] = 1
    return counts, skips


#: consumer body -> the producer body it reads through a value derived
#: from each of the producer's entries: the recommendation ``scores``
#: body's denominator sqrt(item_norms[c]) + 1e-9, computed once an item a
#: launch (csrc/dag_walk.cu: Recommendation)
DERIVED_READS = {"recommendation.scores": "recommendation.item_norms"}

#: a float ``sum`` stage's slots are cut into about this many groups
FOLD_GROUPS = 512


def folds(stage: WalkStage) -> bool:
    """Whether the CUDA walker runs ``stage`` as partials and a fold: a
    ``sum`` stage of a floating type (an int count keeps its one owner)."""
    return stage.combine == "sum" and stage.out_dtype.is_floating_point


@dataclass(frozen=True)
class FoldPlan:
    """How the CUDA walker drains one table, computed from the table alone.

    The table is cut into segments at the grid barriers ``sync_flags``
    asks for. In each segment every CTA walks the segment's other slots
    (``walk``) in order, then the CTAs take the segment's ``pieces`` by
    grid stride. A piece is the part of one group of one float ``sum``
    stage that lies in the segment: its slots fold in ascending order
    into the group's partial, which starts from zero, or from the
    partial its earlier piece stored (``cont``). At the start of a
    segment (after its barrier) or at the launch end, each stage of
    ``fold_at`` that is due has its buffer (zeros or the seed) plus its
    partials added in ascending group order by each entry's owner, and a
    second barrier publishes the sums.

    Groups hold ``group_size[name]`` consecutive slots of the stage's own
    slots (ordinal k goes to group k // group_size); the size depends
    only on the stage's slot count in the table. Nothing here depends on
    the grid that walks it.

    ``count_fusion``'s consumer slots are planned as padding: they do no
    work and need no barrier. ``counts`` marks the producer slots that
    count for them (empty when the walk counts nothing that way).

    ``prepass`` names the stages of ``DERIVED_READS`` bodies with slots in
    the table whose member's producer stage the launch does not fold (it
    is absent, has no slots here, or is walked alone in a stagewise
    launch): their derived values are computed by a pass at the launch
    start, behind one grid barrier. Where the producer folds in the
    launch, its fold writes them, before the consumer's first slot, at no
    barrier of its own.
    """

    flags: np.ndarray        # (n_slots,) uint8: a grid barrier before the slot
    walk: np.ndarray         # slots walked one at a time, in table order
    walk_ptr: np.ndarray     # (n_seg + 1,) each segment's range of ``walk``
    pieces: np.ndarray       # (n_pieces, 5): instance, group, first, count, cont
    piece_ptr: np.ndarray    # (n_seg + 1,) each segment's range of ``pieces``
    piece_slots: np.ndarray  # the pieces' slots, ascending within a piece
    fold_inst: np.ndarray    # instances folded at each segment start
    fold_ptr: np.ndarray     # (n_seg + 2,) ranges of ``fold_inst``; n_seg = end
    inst: np.ndarray         # (n_inst, 4): stage id, n_groups, offset, entries
    group_size: dict         # stage name -> slots a group
    groups: dict             # stage name -> group of each of its slots, in order
    fold_at: dict            # stage name -> slot its fold precedes (n_slots: end)
    counts: np.ndarray       # (n_slots,) uint8: the slot also counts its rows, or (0,)
    prepass: tuple = ()      # stages whose derived reads a launch-start pass computes

    @property
    def n_seg(self) -> int:
        return len(self.walk_ptr) - 1

    @property
    def scratch(self) -> int:
        """Floats of partials the walk needs."""
        return int((self.inst[:, 1].astype(np.int64) * self.inst[:, 3]).sum())

    def packed(self) -> tuple[np.ndarray, list[int]]:
        """The int arrays the kernel reads, in one int32 array, and the
        offset of each (``walk``, ``walk_ptr``, ``pieces``, ``piece_ptr``,
        ``piece_slots``, ``fold_inst``, ``fold_ptr``, ``inst``, ``counts``)."""
        parts = [self.walk, self.walk_ptr, self.pieces.ravel(), self.piece_ptr,
                 self.piece_slots, self.fold_inst, self.fold_ptr, self.inst.ravel(),
                 self.counts]
        offs = np.cumsum([0] + [len(p) for p in parts[:-1]]).tolist()
        return np.concatenate(parts).astype(np.int32), offs


def fold_plan(stages: list[WalkStage], table: np.ndarray,
              n_groups: int = FOLD_GROUPS) -> FoldPlan:
    """The CUDA walker's plan for ``table`` (see ``FoldPlan``).

    A float ``sum`` stage folds at the first barrier after its last slot
    when a slot of this table reads it after that slot (build_dag_tables
    puts a barrier there), and at the launch end otherwise.
    """
    table = _check_table(table)
    n = len(table)
    counts, skips = count_fusion(stages, table)
    if skips.any():                                 # counted slots: padding
        table = np.where(skips[:, None] == 1, np.int32([-1, 0, 0]), table)
    flags = sync_flags(stages, table)
    sid = table[:, 0]
    real = (table[:, 2] > 0) & (sid >= 0) & (sid < len(stages))
    seg = np.cumsum(flags, dtype=np.int64)          # segment of each slot
    starts = np.flatnonzero(flags)                  # segment k + 1 starts here
    n_seg = len(starts) + 1
    bounds = np.r_[0, starts, n]
    fold_sids = [k for k, s in enumerate(stages) if folds(s)]
    folded = real & np.isin(sid, fold_sids)
    walk = np.flatnonzero(real & ~folded)
    walk_ptr = np.searchsorted(walk, bounds)

    names = [s.name for s in stages]
    pieces, piece_slots, inst, fold_seg = [], [], [], []
    group_size, groups, fold_at = {}, {}, {}
    offset, first = 0, 0
    for k in fold_sids:
        idx = np.flatnonzero(folded & (sid == k))
        if len(idx) == 0:
            continue                                # the buffer is the answer
        st = stages[k]
        g = -(-len(idx) // n_groups)
        grp = np.arange(len(idx)) // g
        j = len(inst)
        entries = int(np.prod(st.out_shape))
        inst.append((k, int(grp[-1]) + 1, offset, entries))
        offset += (int(grp[-1]) + 1) * entries
        group_size[st.name], groups[st.name] = g, grp
        # a piece ends where its group or its segment does
        s_of = seg[idx]
        cut = np.flatnonzero((grp[1:] != grp[:-1]) | (s_of[1:] != s_of[:-1])) + 1
        lo = np.r_[0, cut]
        hi = np.r_[cut, len(idx)]
        cont = np.r_[False, grp[lo[1:]] == grp[lo[1:] - 1]]
        pieces.append(np.stack([s_of[lo], np.full(len(lo), j), grp[lo], first + lo,
                                hi - lo, cont], axis=1))
        first += len(idx)
        piece_slots.append(idx)
        last = int(idx[-1])
        readers = [r for r, s in enumerate(stages)
                   if any(p == st.name for p, _ in s.reads)]
        read = real & np.isin(sid, readers)
        if read[:last].any():
            early = int(np.flatnonzero(read[:last])[0])
            raise ValueError(
                f"slot {early} reads {st.name!r} before its last slot {last}: "
                "a full read needs every slot of its producer first")
        if read[last + 1:].any():
            b = int(starts[np.searchsorted(starts, last, side="right")])
            fold_seg.append((int(seg[b]), j))
            fold_at[st.name] = b
        else:
            fold_seg.append((n_seg, j))
            fold_at[st.name] = n
    member_body = {(s.member, s.device_body): s.name for s in stages}
    prepass = tuple(
        st.name for k, st in enumerate(stages)
        if st.device_body in DERIVED_READS and (real & (sid == k)).any()
        and member_body.get((st.member, DERIVED_READS[st.device_body])) not in fold_at)
    pieces = np.concatenate(pieces) if pieces else np.zeros((0, 6), np.int64)
    pieces = pieces[np.argsort(pieces[:, 0], kind="stable")]  # by segment
    fold_seg.sort(key=lambda f: f[0])
    f_seg = np.array([f[0] for f in fold_seg], dtype=np.int64)
    if offset >= 2 ** 31:
        raise ValueError(f"the walk's partials need {offset} floats, past int32")
    return FoldPlan(
        flags=flags, walk=walk.astype(np.int32), walk_ptr=walk_ptr.astype(np.int32),
        pieces=np.ascontiguousarray(pieces[:, 1:], dtype=np.int32),
        piece_ptr=np.searchsorted(pieces[:, 0], np.arange(n_seg + 1)).astype(np.int32),
        piece_slots=(np.concatenate(piece_slots) if piece_slots
                     else np.zeros(0, np.int64)).astype(np.int32),
        fold_inst=np.array([f[1] for f in fold_seg], dtype=np.int32),
        fold_ptr=np.searchsorted(f_seg, np.arange(n_seg + 2)).astype(np.int32),
        inst=np.array(inst, dtype=np.int32).reshape(-1, 4),
        group_size=group_size, groups=groups,
        fold_at={names[k]: fold_at[names[k]] for k in fold_sids if names[k] in fold_at},
        counts=counts if counts.any() else np.zeros(0, np.uint8), prepass=prepass)


def _checked(t: torch.Tensor, shape: tuple, what: str, dtype=torch.float32) -> torch.Tensor:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{what}: need a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    return t


# Each program's argument builder turns one member's inputs ({body: [input
# tensors]}), outputs ({body: output}), inner step counts ({body: inner})
# and whether the launch start computes its derived reads (``prepass``)
# into the pointers (tensors, or None for a null pointer) and int sizes
# that csrc/dag_walk.cu's P::unpack reads, in its order.

def _linreg_args(inputs: dict, outs: dict, tile: int, inner: dict,
                 prepass: bool) -> tuple[list, list]:
    """X, y, moments, mom_in, syrk; n, d."""
    X = next(ins[0] for ins in inputs.values())
    n, d = X.shape
    _checked(X, (n, d), "linreg X")
    if d > LINREG_MAX_D:
        raise ValueError(f"linreg X has {d} feature columns: the walker's linreg "
                         f"program takes at most {LINREG_MAX_D} (one a thread)")
    y = mom_in = None
    if "linreg.syrk_gemv" in inputs:
        Xs, y, mom_in = inputs["linreg.syrk_gemv"]
        if Xs.data_ptr() != X.data_ptr():
            raise ValueError("linreg bodies must read the same X")
        _checked(y, (n, 1), "linreg y")
        _checked(mom_in, (2, d), "linreg moments read by syrk_gemv")
    mom = outs.get("linreg.moments")
    syrk = outs.get("linreg.syrk_gemv")
    if mom is not None:
        _checked(mom, (2, d), "linreg moments output")
    if syrk is not None:
        _checked(syrk, (d + 1, d + 2), "linreg syrk_gemv output")
    return [X, y, mom, mom_in, syrk], [n, d]


def _recommendation_args(inputs: dict, outs: dict, tile: int, inner: dict,
                         prepass: bool) -> tuple[list, list]:
    """R, item_norms, user_bias, scores, norms_in, bias_in, den; n_users,
    n_items, den_pre.

    ``den`` holds the scores body's denominator of each item, written
    once a launch: by the fold of ``item_norms``, or (``den_pre``) by the
    launch start from ``norms_in``."""
    R = next(ins[0] for ins in inputs.values())
    n_users, n_items = R.shape
    _checked(R, (n_users, n_items), "recommendation R")
    for body, ins in inputs.items():
        if ins[0].data_ptr() != R.data_ptr():
            raise ValueError(f"{body} must read the same R as the other bodies")
    norms_in = bias_in = den = None
    if "recommendation.scores" in inputs:
        _, norms_in, bias_in = inputs["recommendation.scores"]
        _checked(norms_in, (n_items,), "item_norms read by scores")
        _checked(bias_in, (n_users,), "user_bias read by scores")
        den = torch.empty(n_items, dtype=torch.float32, device=R.device)
    norms = outs.get("recommendation.item_norms")
    bias = outs.get("recommendation.user_bias")
    scores = outs.get("recommendation.scores")
    if norms is not None:
        _checked(norms, (n_items,), "item_norms output")
    if bias is not None:
        _checked(bias, (n_users,), "user_bias output")
    if scores is not None:
        _checked(scores, (n_users,), "scores output", torch.int32)
    return [R, norms, bias, scores, norms_in, bias_in, den], [n_users, n_items,
                                                               int(prepass)]


def _moe_args(inputs: dict, outs: dict, tile: int, inner: dict,
              prepass: bool) -> tuple[list, list]:
    """x, wi, wo, out, h scratch; E*C, d, f (C = tile, one slab a slot).

    ``h`` holds every slab's gated activations (E*C, f): the kernel writes
    all of them, then computes every slab's output from them."""
    x, wi, wo = inputs["moe.experts"]
    e, d, f2 = wi.shape
    f = f2 // 2
    _checked(x, (e * tile, d), f"moe xdisp ({e} experts x capacity {tile})")
    _checked(wi, (e, d, 2 * f), "moe wi")
    _checked(wo, (e, f, d), "moe wo")
    out = _checked(outs["moe.experts"], (e * tile, d), "moe experts output")
    if d % 4 or f % 4:
        raise ValueError(f"moe: d_model={d} and d_ff_expert={f} must be multiples "
                         "of 4 (the kernel copies 16-byte vectors)")
    if any(t.data_ptr() % 16 for t in (x, wi, wo, out)):
        raise ValueError("moe: xdisp, wi, wo and the output must be 16-byte aligned")
    h = torch.empty((e * tile, f), dtype=torch.float32, device=x.device)
    return [x, wi, wo, out, h], [e * tile, d, f]


def _cc_args(inputs: dict, outs: dict, tile: int, inner: dict,
             prepass: bool) -> tuple[list, list]:
    """G, c_col, c_row, propagate, changed, prop_in; n, tile_c."""
    G = c_col = prop_in = None
    tile_c = 0
    if "cc.propagate" in inputs:
        G, c_col, c_row = inputs["cc.propagate"]
        n = G.shape[0]
        _checked(G, (n, n), "cc G")
        _checked(c_col, (n,), "cc c_col")
        steps = inner["cc.propagate"]
        tile_c = n // steps
        if tile_c * steps != n or tile_c % 4:
            raise ValueError(f"cc propagate: {steps} inner steps must cut n={n} "
                             "into column tiles of a multiple of 4")
        if G.data_ptr() % 16 or c_col.data_ptr() % 16:
            raise ValueError("cc propagate reads 16-byte vectors: G and c_col "
                             "must be 16-byte aligned")
    if "cc.changed" in inputs:
        c_row_changed, prop_in = inputs["cc.changed"]
        if G is not None and c_row_changed.data_ptr() != c_row.data_ptr():
            raise ValueError("cc.changed must compare with the c_row that "
                             "cc.propagate starts from")
        c_row = c_row_changed
    n = c_row.shape[0] if G is None else G.shape[0]
    _checked(c_row, (n,), "cc c_row")
    if prop_in is not None:
        _checked(prop_in, (n,), "propagate read by changed")
    prop, changed = outs.get("cc.propagate"), outs.get("cc.changed")
    if prop is not None:
        _checked(prop, (n,), "cc propagate output")
    if changed is not None:
        _checked(changed, (1,), "cc changed output", torch.int32)
    return [G, c_col, c_row, prop, changed, prop_in], [n, tile_c]


_ARGS = {"linreg": _linreg_args, "recommendation": _recommendation_args,
         "moe": _moe_args, "cc": _cc_args}


def _walk_cuda(stages, operands, values, table, tile, stamp):
    """Launch the compiled walker program over one shard's table."""
    prog, body_map = cuda_program(stages)
    device = _walk_device(operands, values)
    outs = _init_outs(stages, values, device)  # the kernel folds into these
    n_slots = len(table)
    if n_slots == 0:
        return (outs, np.zeros((0, 4), dtype=np.int32)) if stamp else outs
    for s in stages:
        if s.n_rows % tile:
            raise ValueError(f"stage {s.name!r}: n_rows={s.n_rows} is not a "
                             f"multiple of tile={tile}")
        if folds(s) and s.device_body not in FOLD_BODIES:
            raise ValueError(f"stage {s.name!r}: the device body {s.device_body!r} "
                             "has no partial-and-fold form for a float sum")
    # members in ascending order, numbered densely for the kernel
    dense = {m: k for k, m in enumerate(sorted({s.member for s in stages}))}
    n_members = len(dense)
    inputs = [{} for _ in range(n_members)]
    by_body = [{} for _ in range(n_members)]
    inner = [{} for _ in range(n_members)]
    for s in stages:
        names = s.operands + tuple(p for p, _ in s.reads)
        ins = [outs[n] if n in outs else values[n] for n in names]
        for n, t in zip(names, ins):
            if t.device != device:
                raise ValueError(f"stage {s.name!r}: {n!r} lies on {t.device}, "
                                 f"the walk on {device}")
        inputs[dense[s.member]][s.device_body] = ins
        by_body[dense[s.member]][s.device_body] = outs[s.name]
        inner[dense[s.member]][s.device_body] = s.inner
    entry = _device_table(table, device)
    plan = _device_plan(entry, stages, body_map, [dense[s.member] for s in stages],
                        table, device)
    pre = {dense[s.member] for s in stages if s.name in plan.prepass}
    ptrs, dims = [], []
    for m in range(n_members):
        p, d = _ARGS[prog](inputs[m], by_body[m], tile, inner[m], m in pre)
        ptrs += p
        dims += d
    # host arrays of the members' pointers and sizes; `ptrs` keeps every
    # tensor (the MoE and recommendation scratch among them) alive through
    # the launch
    ptr_arr = (ctypes.c_void_p * len(ptrs))(
        *[None if t is None else t.data_ptr() for t in ptrs])
    dim_arr = (ctypes.c_int * len(dims))(*dims)
    off_arr = (ctypes.c_int * len(plan.offs))(*plan.offs)
    scratch = torch.empty(max(plan.scratch, 1), dtype=torch.float32, device=device)
    stamps = torch.zeros((n_slots, 4), dtype=torch.int32, device=device) if stamp else None
    barrier = torch.zeros(2, dtype=torch.int32, device=device)
    DAG_WALK.launch(f"walk_{prog}", ptr(entry.table), ctypes.c_int(n_slots), ptr(plan.ints),
                    ctypes.cast(off_arr, ctypes.c_void_p), ctypes.c_int(plan.n_seg),
                    ptr(scratch), ptr(stamps), ptr(barrier), ctypes.c_int(tile),
                    ctypes.c_int(n_members), ctypes.cast(ptr_arr, ctypes.c_void_p),
                    ctypes.cast(dim_arr, ctypes.c_void_p), stream(device))
    if stamp:
        return outs, stamps.cpu().numpy()
    return outs


def dag_walk(
    stages: list[WalkStage],
    operands: list[WalkOperand],
    values: dict[str, torch.Tensor],
    table: np.ndarray,
    tile: int,
    stamp: bool = False,
):
    """Drain one shard's super-table in a single launch.

    ``table`` is ``(n_slots, 3) int32`` (stage, start, size) from
    build_dag_tables (stage ids index ``stages``, which must be in the
    same topological order). Returns {stage name: output tensor}; on a
    multi-shard table a shard only fills the tiles it owns (combine with
    ``dag_walk_sharded``). The table's device copy and fold plan stay
    cached by content across launches (``device_table_cache_stats``).

    ``stamp=True`` adds an ``(n_slots, 4) int32`` numpy event buffer:
    slot ``i`` writes ``(stage_id, start, size, i)`` into row ``i``. The
    return becomes ``({stage: out}, stamps)``.
    """
    table = _check_table(table)
    device = _walk_device(operands, values)
    if device.type == "cpu":
        return dag_walk_plain(stages, operands, values, table, tile, stamp=stamp)
    if device.type != "cuda":
        raise ValueError(f"dag_walk: unsupported device {device}")
    if len({s.name for s in stages}) != len(stages):
        raise ValueError("duplicate stage names")
    return _walk_cuda(stages, operands, values, table, tile, stamp)


def dag_walk_stagewise(
    stages: list[WalkStage],
    operands: list[WalkOperand],
    values: dict[str, torch.Tensor],
    table: np.ndarray,
    tile: int,
) -> dict[str, torch.Tensor]:
    """One launch per stage: the pre-fusion baseline.

    Each stage drains only its own slots of the super-table; producer
    outputs from earlier launches are re-fed as plain operands. The same
    per-tile work in the same per-stage order as the fused walker, so the
    results match it.
    """
    table = _check_table(table)
    ops_by_name = {o.name: o for o in operands}
    by_name = {s.name: s for s in stages}
    results: dict[str, torch.Tensor] = {}
    for k, s in enumerate(stages):
        sub = table[(table[:, 0] == k) & (table[:, 2] > 0)].copy()
        sub[:, 0] = 0
        stage_ops = [ops_by_name[n] for n in s.operands]
        stage_vals = {n: values[n] for n in s.operands}
        if s.seed in values:  # a missing seed raises in the walk
            stage_vals[s.seed] = values[s.seed]
        for prod, kind in s.reads:
            stage_ops.append(_read_operand(by_name, prod, kind, tile))
            stage_vals[prod] = results[prod]
        solo = dataclasses.replace(
            s, operands=s.operands + tuple(p for p, _ in s.reads), reads=())
        results[s.name] = dag_walk([solo], stage_ops, stage_vals, sub, tile)[s.name]
    return results


def dag_walk_sharded(
    stages: list[WalkStage],
    operands: list[WalkOperand],
    values: dict[str, torch.Tensor],
    tables: np.ndarray,
    tile: int,
) -> dict[str, torch.Tensor]:
    """Walk every shard's super-table and combine the per-shard outputs.

    ``tables`` is ``(n_shards, max_slots, 3)``. concat outputs merge by
    tile ownership; sum outputs add per-shard partials in ascending shard
    order (deterministic, but a different association than one shard, so
    bit-wise claims hold per shard count). Outputs lie on the walk's
    device. A seeded stage raises on more than one shard: every shard
    would start from the seed, so the sum would hold it once per shard.

    Shard ``s+1``'s table is copied (non-blocking, from pinned memory)
    before shard ``s`` is walked, so the next transfer rides behind the
    current walk; every shard table stays in the device-table cache.
    """
    tables = np.ascontiguousarray(np.asarray(tables, dtype=np.int32))
    n_shards = tables.shape[0]
    if n_shards > 1:
        for s in stages:
            if s.seed is not None:
                raise ValueError(
                    f"stage {s.name!r} starts from seed {s.seed!r}: a "
                    f"{n_shards}-shard walk would add it once per shard")
    device = _walk_device(operands, values)

    if n_shards:
        _device_table(tables[0], device)
    shard_outs = []
    for s in range(n_shards):
        if s + 1 < n_shards:
            _device_table(tables[s + 1], device)
        shard_outs.append(dag_walk(stages, operands, values, tables[s], tile))
    combined: dict[str, torch.Tensor] = {}
    for k, s in enumerate(stages):
        if s.combine == "sum":
            acc = shard_outs[0][s.name]
            for o in shard_outs[1:]:
                acc = acc + o[s.name]
            combined[s.name] = acc
            continue
        buf = torch.zeros_like(shard_outs[0][s.name])
        for sh in range(n_shards):
            t = tables[sh]
            mine = t[(t[:, 0] == k) & (t[:, 2] > 0)]
            if len(mine) == 0:
                continue
            rows = torch.from_numpy(np.concatenate(
                [np.arange(st, st + z) for _, st, z in mine])).to(device)
            buf[rows] = shard_outs[sh][s.name][rows]
        combined[s.name] = buf
    return combined
