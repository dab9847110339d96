"""The CUDA walker's fold plan (``kernels/dag_walk.py:fold_plan``), on the CPU.

The plan is numpy computed from the table alone; the kernel follows it, so
what the plan fixes is what the card's results may depend on. These tests
hold it to the walker's guarantees:

* a float ``sum`` stage's groups depend only on the stage's own slots:
  a member of a batched table and a stage walked alone
  (``dag_walk_stagewise``) get the groups of the single fused walk;
* each such stage folds at the first grid barrier before a slot of the
  launch that reads it, and at the launch end when nothing reads it
  (linreg, recommendation under four techniques, a seeded K3 remainder,
  a device prefix of a migration);
* nothing depends on the grid: an emulation of the kernel's grid-stride
  walk over the plan, in float32, gives the same bits for every grid
  size, equal to the two-level ascending sum (slots within a group, then
  groups from the seed) computed directly.
"""

import dataclasses
import inspect

import numpy as np
import pytest

from repro_torch.core import (PipelineDAG, PreemptiveRunner, SchedulerConfig,
                              Stage, StageDep, build_dag_tables)
from repro_torch.core.dag import DEP_FULL
from repro_torch.core.preempt import _ss_table, device_remainder
from repro_torch.kernels import dag_walk as twalk
from repro_torch.vee import apps as tapps

TECHNIQUES = ["STATIC", "GSS", "TSS", "FAC2"]


def _rows(low, technique, n_shards=1):
    rows = build_dag_tables(low.dag, 1, technique, n_shards=n_shards).tables.copy()
    rows[:, :, 1:] *= low.tile
    return rows


def _lowering(name, seed=1, **kw):
    if name == "linreg":
        return tapps.linreg_device_lowering(kw.get("rows", 64 * 700), 9, seed=seed,
                                            device="cpu")
    return tapps.recommendation_device_lowering(kw.get("rows", 64 * 300), 16,
                                                seed=seed, device="cpu")


def _stage_slots(stages, table, name):
    """The real slots of stage ``name`` (indices into ``table``)."""
    k = [s.name for s in stages].index(name)
    return np.flatnonzero((table[:, 0] == k) & (table[:, 2] > 0))


def _check_fold_points(stages, table, plan):
    """Each float sum stage folds at the first barrier after its last slot
    that precedes a reader's slot, or at the launch end."""
    n = len(table)
    folded = [s for s in stages if twalk.folds(s)]
    assert set(plan.fold_at) == {s.name for s in folded
                                 if len(_stage_slots(stages, table, s.name))}
    for s in folded:
        mine = _stage_slots(stages, table, s.name)
        if not len(mine):
            continue
        last, at = int(mine[-1]), plan.fold_at[s.name]
        readers = [r.name for r in stages if any(p == s.name for p, _ in r.reads)]
        later = [int(i) for r in readers for i in _stage_slots(stages, table, r)
                 if i > last]
        if later:
            assert last < at <= min(later)
            assert plan.flags[at] == 1
            assert not plan.flags[last + 1:at].any()
        else:
            assert at == n
    # the kernel's view of the same fold points: segment starts and the end
    seg_start = np.r_[0, np.flatnonzero(plan.flags), n]
    names = [s.name for s in stages]
    for seg in range(plan.n_seg + 1):
        for j in plan.fold_inst[plan.fold_ptr[seg]:plan.fold_ptr[seg + 1]]:
            name = names[plan.inst[j, 0]]
            assert plan.fold_at[name] == (n if seg == plan.n_seg else seg_start[seg])


def _check_cover(stages, table, plan):
    """Pieces cover each float sum slot once, in ascending order; the walk
    holds every other real slot once; a piece lies in one segment, and a
    continued group's earlier piece lies in an earlier segment."""
    seg = np.cumsum(plan.flags)
    names = [s.name for s in stages]
    seen = {}
    for s in range(plan.n_seg):
        for j, g, first, count, cont in plan.pieces[plan.piece_ptr[s]:plan.piece_ptr[s + 1]]:
            slots = plan.piece_slots[first:first + count]
            assert count > 0 and (seg[slots] == s).all()
            assert (np.diff(slots) > 0).all()
            name = names[plan.inst[j, 0]]
            if cont:
                assert seen[(name, g)][-1][0] < s
            seen.setdefault((name, g), []).append((s, slots))
        walk = plan.walk[plan.walk_ptr[s]:plan.walk_ptr[s + 1]]
        assert (seg[walk] == s).all()
    real = (table[:, 2] > 0) & (table[:, 0] >= 0) & (table[:, 0] < len(stages))
    for k, st in enumerate(stages):
        mine = np.flatnonzero(real & (table[:, 0] == k))
        if twalk.folds(st):
            got = [sl for (name, _g), parts in sorted(seen.items(), key=lambda x: x[0][1])
                   if name == st.name for _s, sl in parts]
            got = np.concatenate(got) if got else np.zeros(0, int)
            assert np.array_equal(np.sort(got), mine)
            grp = plan.groups.get(st.name, np.zeros(0, int))
            assert np.array_equal(grp, np.arange(len(mine)) // max(
                plan.group_size.get(st.name, 1), 1))
        else:
            assert np.array_equal(np.intersect1d(plan.walk, mine), mine)


def _starts(stages, table, name):
    return table[_stage_slots(stages, table, name), 1]


# ---------------------------------------------------------------------------
# groups depend only on the stage-local ordinal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["linreg", "recommendation"])
@pytest.mark.parametrize("technique", ["GSS", "TSS"])
def test_batched_members_get_the_single_walks_groups(name, technique):
    lows = [_lowering(name, seed=s) for s in (1, 2, 3)]
    merged = tapps.merge_device_lowerings(lows)
    rows_b = _rows(merged, technique)[0]
    plan_b = twalk.fold_plan(merged.stages, rows_b)
    _check_cover(merged.stages, rows_b, plan_b)
    _check_fold_points(merged.stages, rows_b, plan_b)
    for j, low in enumerate(lows):
        rows = _rows(low, technique)[0]
        plan = twalk.fold_plan(low.stages, rows)
        for st in low.stages:
            if not twalk.folds(st):
                continue
            mj = f"{st.name}#{j}"
            assert plan_b.group_size[mj] == plan.group_size[st.name]
            assert np.array_equal(plan_b.groups[mj], plan.groups[st.name])
            assert np.array_equal(_starts(merged.stages, rows_b, mj),
                                  _starts(low.stages, rows, st.name))


@pytest.mark.parametrize("name", ["linreg", "recommendation"])
def test_stagewise_walks_get_the_fused_walks_groups(name):
    low = _lowering(name)
    rows = _rows(low, "GSS")[0]
    fused = twalk.fold_plan(low.stages, rows)
    for k, st in enumerate(low.stages):
        # the sub-table and stage dag_walk_stagewise launches
        sub = rows[(rows[:, 0] == k) & (rows[:, 2] > 0)].copy()
        sub[:, 0] = 0
        solo = dataclasses.replace(st, operands=st.operands + tuple(p for p, _ in st.reads),
                                   reads=())
        plan = twalk.fold_plan([solo], sub)
        if not twalk.folds(st):
            assert not plan.groups and len(plan.walk) == len(sub)
            continue
        assert np.array_equal(plan.groups[st.name], fused.groups[st.name])
        assert plan.fold_at[st.name] == len(sub)  # nothing in its launch reads it


def test_group_size_follows_the_slot_count_alone():
    """Padding slots, other stages' slots and barriers do not move groups;
    the slot count does: ~FOLD_GROUPS groups, one slot a group below it."""
    low = _lowering("linreg", rows=64 * 1100)
    rows = _rows(low, "GSS")[0]
    plan = twalk.fold_plan(low.stages, rows)
    assert plan.group_size == {"moments": 3, "syrk_gemv": 3}
    assert int(plan.inst[0, 1]) == -(-1100 // 3)
    padded = np.concatenate([rows[:5], np.array([[0, 0, 0], [-1, 0, 64]]), rows[5:]])
    plan_p = twalk.fold_plan(low.stages, padded.astype(np.int32))
    for s in ("moments", "syrk_gemv"):
        assert np.array_equal(plan_p.groups[s], plan.groups[s])
    small = twalk.fold_plan(low.stages, rows[:7])
    assert small.group_size == {"moments": 1} and small.fold_at == {"moments": 7}


# ---------------------------------------------------------------------------
# fold points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["linreg", "recommendation"])
@pytest.mark.parametrize("technique", TECHNIQUES)
def test_fold_before_the_first_reader(name, technique):
    low = _lowering(name)
    rows = _rows(low, technique)[0]
    plan = twalk.fold_plan(low.stages, rows)
    _check_cover(low.stages, rows, plan)
    _check_fold_points(low.stages, rows, plan)
    reader = {"linreg": ("moments", "syrk_gemv"),
              "recommendation": ("item_norms", "scores")}[name]
    first_read = int(_stage_slots(low.stages, rows, reader[1])[0])
    assert plan.fold_at[reader[0]] == first_read
    if name == "linreg":
        assert plan.fold_at["syrk_gemv"] == len(rows)


def test_sharded_tables_fold_per_shard():
    """A multi-shard walk (no full edge) folds each shard's own slots."""
    low = _lowering("recommendation")
    keep = [s for s in low.stages if s.name != "scores"]
    dag = PipelineDAG([Stage(s.name, low.dag.stages[s.name].n_rows, None,
                             combine=s.combine) for s in keep])
    tables = build_dag_tables(dag, 1, "GSS", n_shards=3, n_workers=4).tables.copy()
    tables[:, :, 1:] *= low.tile
    for t in tables:
        plan = twalk.fold_plan(keep, t)
        _check_cover(keep, t, plan)
        _check_fold_points(keep, t, plan)
        assert plan.fold_at == {"item_norms": len(t)}


@pytest.mark.parametrize("name,cut", [("linreg", 700 + 40), ("recommendation", 200)])
def test_seeded_remainder_folds_from_its_seed(name, cut):
    low = _lowering(name)
    cfg = SchedulerConfig(technique="SS", queue_layout="CENTRALIZED", n_workers=1)
    _, ck = PreemptiveRunner(low.dag, cfg, preempt_after=cut).run()
    rem = device_remainder(ck, low)
    seeded = [s for s in rem.stages if s.seed is not None]
    assert seeded and all(twalk.folds(s) for s in seeded)
    plan = twalk.fold_plan(rem.stages, rem.table)
    _check_cover(rem.stages, rem.table, plan)
    _check_fold_points(rem.stages, rem.table, plan)


@pytest.mark.parametrize("name", ["linreg", "recommendation"])
@pytest.mark.parametrize("frac", [0.2, 0.6])
def test_device_prefix_folds_at_its_end(name, frac):
    """``run_device_prefix`` walks a prefix of the SS table; a sum stage
    cut short has no reader in the launch, so it folds at the end and the
    walk returns its prefix accumulator."""
    low = _lowering(name)
    table, _ = _ss_table(low.dag)
    live = table[table[:, 2] > 0]
    prefix = live[:int(frac * len(live))].copy()
    prefix[:, 1:] *= low.tile
    plan = twalk.fold_plan(low.stages, prefix)
    _check_cover(low.stages, prefix, plan)
    _check_fold_points(low.stages, prefix, plan)
    cut_short = [s.name for s in low.stages if twalk.folds(s)
                 and 0 < len(_stage_slots(low.stages, prefix, s.name))
                 < low.dag.stages[s.name].n_rows]
    assert cut_short
    for s in cut_short:
        assert plan.fold_at[s] == len(prefix)


def test_fold_points_on_a_dag_with_a_sum_read_mid_table():
    """A float sum read by a concat stage whose slots interleave with an
    unrelated stage's: the fold lands on the reader's barrier."""
    import torch

    dag = PipelineDAG([Stage("a", 40, None, combine="sum"),
                       Stage("b", 40, None, combine="concat"),
                       Stage("c", 40, None, combine="concat",
                             deps=(StageDep("a", DEP_FULL),))])
    stages = [twalk.WalkStage("a", 40 * 8, (3,), torch.float32, "sum", None),
              twalk.WalkStage("b", 40 * 8, (40 * 8,), torch.float32, "concat", None),
              twalk.WalkStage("c", 40 * 8, (40 * 8,), torch.float32, "concat", None,
                              reads=(("a", "full"),))]
    for tech in TECHNIQUES:
        rows = build_dag_tables(dag, 1, tech).tables[0].copy()
        plan = twalk.fold_plan(stages, rows)
        _check_cover(stages, rows, plan)
        _check_fold_points(stages, rows, plan)


# ---------------------------------------------------------------------------
# scores' denominators: written by item_norms' fold, or by a launch-start
# pass behind one barrier (FoldPlan.prepass)
# ---------------------------------------------------------------------------

def _emulated_barriers(plan):
    """The grid barriers csrc/dag_walk.cu's walk_kernel runs on ``plan``:
    the prepass's, then per segment start s > 0 one barrier, and a second
    after the folds due there; at the launch end one before the folds."""
    n = int(bool(plan.prepass))
    for s in range(1, plan.n_seg + 1):
        due = plan.fold_ptr[s + 1] > plan.fold_ptr[s]
        if s < plan.n_seg or due:
            n += 1
        if due and s < plan.n_seg:
            n += 1
    return n


@pytest.mark.parametrize("technique", TECHNIQUES)
def test_fused_recommendation_writes_den_in_the_fold(technique):
    """A fused walk folds item_norms at the barrier before the first scores
    slot: that fold writes den, so no prepass and no barrier of its own
    (one barrier before scores, one after the fold)."""
    low = _lowering("recommendation")
    rows = _rows(low, technique)[0]
    plan = twalk.fold_plan(low.stages, rows)
    assert plan.prepass == ()
    assert _emulated_barriers(plan) == 2


def test_stagewise_scores_computes_den_at_the_launch_start():
    """dag_walk_stagewise's scores launch reads item_norms from an earlier
    launch: den is a prepass, one barrier; the item_norms and user_bias
    launches have none."""
    low = _lowering("recommendation")
    rows = _rows(low, "GSS")[0]
    want = {"item_norms": ((), 1), "user_bias": ((), 0), "scores": (("scores",), 1)}
    for k, st in enumerate(low.stages):
        sub = rows[(rows[:, 0] == k) & (rows[:, 2] > 0)].copy()
        sub[:, 0] = 0
        solo = dataclasses.replace(st, operands=st.operands + tuple(p for p, _ in st.reads),
                                   reads=())
        plan = twalk.fold_plan([solo], sub)
        assert (plan.prepass, _emulated_barriers(plan)) == want[st.name]


@pytest.mark.parametrize("cut,prepass", [(200, ()), (2 * 300 + 20, ("scores",))])
def test_remainder_walks_plan_den_where_item_norms_is(cut, prepass):
    """A K3 remainder that still walks item_norms (seeded) folds den with
    it; one whose item_norms the host finished reads it as an operand, so
    den is a prepass. Both have the barrier before scores (it reads the
    replayed user_bias rows) and one more: the fold's, or the prepass's."""
    low = _lowering("recommendation")
    cfg = SchedulerConfig(technique="SS", queue_layout="CENTRALIZED", n_workers=1)
    _, ck = PreemptiveRunner(low.dag, cfg, preempt_after=cut).run()
    rem = device_remainder(ck, low)
    assert ("item_norms" in [s.name for s in rem.stages]) == (not prepass)
    plan = twalk.fold_plan(rem.stages, rem.table)
    assert plan.prepass == prepass
    assert _emulated_barriers(plan) == 2


def test_batched_recommendation_plans_den_per_member():
    """Members fused in one table fold their own den; the stagewise walk of
    the batch's scores stages (all members in one launch) is one prepass."""
    merged = tapps.merge_device_lowerings([_lowering("recommendation", seed=s)
                                           for s in (1, 2, 3)])
    rows = _rows(merged, "TSS")[0]
    plan = twalk.fold_plan(merged.stages, rows)
    assert plan.prepass == ()
    ks = [k for k, st in enumerate(merged.stages) if st.name.startswith("scores")]
    sub = rows[np.isin(rows[:, 0], ks) & (rows[:, 2] > 0)].copy()
    sub[:, 0] = np.searchsorted(ks, sub[:, 0])
    solo = [dataclasses.replace(merged.stages[k], reads=(),
                                operands=merged.stages[k].operands
                                + tuple(p for p, _ in merged.stages[k].reads))
            for k in ks]
    plan = twalk.fold_plan(solo, sub)
    assert sorted(plan.prepass) == [f"scores#{j}" for j in range(3)]
    assert _emulated_barriers(plan) == 1


def test_no_prepass_without_scores_slots():
    """A table without scores slots (a device prefix that stops before
    them) computes no den."""
    low = _lowering("recommendation")
    table, _ = _ss_table(low.dag)
    live = table[table[:, 2] > 0]
    prefix = live[:len(live) // 2].copy()
    prefix[:, 1:] *= low.tile
    assert twalk.fold_plan(low.stages, prefix).prepass == ()


# ---------------------------------------------------------------------------
# nothing depends on the grid
# ---------------------------------------------------------------------------

def test_plan_takes_no_grid():
    params = inspect.signature(twalk.fold_plan).parameters
    assert list(params) == ["stages", "table", "n_groups"]


def _emulate(plan, stages, table, terms, seeds, grid):
    """The kernel's arithmetic on the plan, CTA by CTA in float32: pieces by
    grid stride (each CTA's in turn, the CTAs in reverse so that the order
    between CTAs is not the plan's), each folding its slots' terms into
    the group's partial; then the folds. ``terms[slot]`` is a slot's
    contribution (one entry)."""
    scratch = np.zeros(max(plan.scratch, 1), np.float32)
    names = [s.name for s in stages]
    out = {n: np.float32(seeds.get(n, 0.0)) for n in names if n in plan.fold_at}
    for s in range(plan.n_seg + 1):
        for j in plan.fold_inst[plan.fold_ptr[s]:plan.fold_ptr[s + 1]]:
            sid, n_groups, off, _ = plan.inst[j]
            v = out[names[sid]]
            for g in range(n_groups):
                v = np.float32(v + scratch[off + g])
            out[names[sid]] = v
        if s == plan.n_seg:
            break
        p0, p1 = plan.piece_ptr[s], plan.piece_ptr[s + 1]
        for cta in reversed(range(grid)):
            for p in range(p0 + cta, p1, grid):
                j, g, first, count, cont = plan.pieces[p]
                _, _, off, _ = plan.inst[j]
                acc = scratch[off + g] if cont else np.float32(0)
                for slot in plan.piece_slots[first:first + count]:
                    acc = np.float32(acc + terms[slot])
                scratch[off + g] = acc
    return out


def _two_level(stages, table, plan, terms, seeds):
    out = {}
    for st in stages:
        if st.name not in plan.fold_at:
            continue
        mine = _stage_slots(stages, table, st.name)
        g = plan.group_size[st.name]
        v = np.float32(seeds.get(st.name, 0.0))
        for lo in range(0, len(mine), g):
            part = np.float32(0)
            for slot in mine[lo:lo + g]:
                part = np.float32(part + terms[slot])
            v = np.float32(v + part)
        out[st.name] = v
    return out


@pytest.mark.parametrize("name", ["linreg", "recommendation"])
def test_emulated_walk_is_the_same_for_every_grid(name):
    lows = [_lowering(name, seed=s, rows=64 * 150) for s in (1, 2, 3)]
    merged = tapps.merge_device_lowerings(lows)
    rows = _rows(merged, "TSS")[0]
    plan = twalk.fold_plan(merged.stages, rows, n_groups=16)
    rng = np.random.default_rng(0)
    terms = (rng.standard_normal(len(rows)) * 10.0 ** rng.integers(-3, 4, len(rows))
             ).astype(np.float32)
    seeds = {s.name: np.float32(rng.standard_normal()) for s in merged.stages}
    want = _two_level(merged.stages, rows, plan, terms, seeds)
    assert want
    for grid in (1, 3, 16, 132, 264):
        got = _emulate(plan, merged.stages, rows, terms, seeds, grid)
        assert {k: v.tobytes() for k, v in got.items()} == \
            {k: v.tobytes() for k, v in want.items()}, grid


def test_a_group_that_straddles_a_barrier_continues_its_partial():
    """Hand-made table: ``a`` (float sum) has slots on both sides of the
    barrier ``c`` needs (it reads ``d``'s rows), so a group's second piece
    continues from the partial the first stored; every grid gives the
    two-level sum's bits."""
    import torch

    stages = [twalk.WalkStage("a", 64, (1,), torch.float32, "sum", None),
              twalk.WalkStage("d", 64, (64,), torch.float32, "concat", None),
              twalk.WalkStage("c", 64, (64,), torch.float32, "concat", None,
                              reads=(("d", "rows"),))]
    table = np.array([[0, 0, 8], [0, 8, 8], [1, 0, 8], [1, 8, 8], [2, 0, 8],
                      [0, 16, 8], [0, 24, 8], [2, 8, 8], [0, 32, 8], [-1, 0, 0],
                      [1, 16, 8], [2, 16, 8], [0, 40, 8]], dtype=np.int32)
    for n_groups in (1, 2, 6):
        plan = twalk.fold_plan(stages, table, n_groups=n_groups)
        _check_cover(stages, table, plan)
        _check_fold_points(stages, table, plan)
        assert plan.n_seg == 3 and plan.fold_at == {"a": len(table)}
        assert plan.pieces[:, 4].any() == (n_groups < 6)
        rng = np.random.default_rng(n_groups)
        terms = rng.standard_normal(len(table)).astype(np.float32) * 1e3
        seeds = {"a": np.float32(0.1)}
        want = _two_level(stages, table, plan, terms, seeds)
        for grid in (1, 2, 5):
            got = _emulate(plan, stages, table, terms, seeds, grid)
            assert got["a"].tobytes() == want["a"].tobytes()


def test_a_read_before_the_producers_last_slot_is_refused():
    low = _lowering("linreg", rows=64 * 20)
    rows = _rows(low, "GSS")[0]
    bad = rows.copy()
    first_syrk = int(np.flatnonzero(bad[:, 0] == 1)[0])
    bad[[first_syrk - 1, first_syrk]] = bad[[first_syrk, first_syrk - 1]]
    with pytest.raises(ValueError, match="reads 'moments' before its last slot"):
        twalk.fold_plan(low.stages, bad)
