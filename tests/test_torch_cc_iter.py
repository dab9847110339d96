"""The CC iteration against the JAX package's: the host DAG on the
pipeline executor, and the walker's CC-iteration program (the super-table
of ``tests/test_device_dag.py``'s ``test_cc_iteration_super_table``).

Every comparison is bitwise: the labels are a max (exact in any order)
and ``changed`` an int32 count.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PipelineDAG as JDAG, Stage as JStage, StageDep as JDep
from repro.core import PipelineExecutor as JExecutor, SchedulerConfig as JConfig
from repro.core import build_dag_tables as j_build_dag_tables
from repro.kernels import dag_walk as jwalk
from repro.kernels import ref as jref
from repro.kernels.cc_propagate import propagate_body as j_propagate_body
from repro.vee import apps as japps
from repro.vee import sparse as jsparse
from repro_torch.core import PipelineExecutor, SchedulerConfig, build_dag_tables
from repro_torch.kernels import dag_walk as twalk
from repro_torch.kernels import ref as tref
from repro_torch.vee import apps as tapps
from repro_torch.vee import sparse as tsparse


def _graphs(scale: int = 9, seed: int = 5):
    kw = dict(scale=scale, edge_factor=8, seed=seed, relabel=True)
    return jsparse.rmat_graph(**kw), tsparse.rmat_graph(**kw)


def test_row_max_gather_bitwise():
    jg, tg = _graphs()
    c = np.random.default_rng(0).permutation(jg.n_rows).astype(np.int64) + 1
    for lo, hi in ((0, None), (17, 130), (500, 512), (40, 40)):
        np.testing.assert_array_equal(tg.row_max_gather(c, lo, hi),
                                      jg.row_max_gather(c, lo, hi))


@pytest.mark.parametrize("technique,workers", [("SS", 1), ("GSS", 3), ("FAC2", 2)])
def test_cc_iteration_dag_on_the_host_executor(technique, workers):
    """The host DAG's values and stage structure equal the reference's,
    and its labels equal one dense CC step."""
    jg, tg = _graphs()
    c = np.arange(1, jg.n_rows + 1, dtype=np.int64)
    jdag, tdag = japps.cc_iteration_dag(jg, c), tapps.cc_iteration_dag(tg, c)
    assert tdag.stage_names == jdag.stage_names
    for name in tdag.stage_names:
        assert tdag.stages[name].combine == jdag.stages[name].combine
    assert tdag.stages["changed"].cost_of_range is None
    assert tdag.stages["propagate"].cost_of_range(3, 40) == \
        jdag.stages["propagate"].cost_of_range(3, 40)
    want = JExecutor(jdag, JConfig(technique=technique, n_workers=workers)).run()
    got = PipelineExecutor(tdag, SchedulerConfig(technique=technique,
                                                 n_workers=workers)).run()
    for name in ("propagate", "changed"):
        np.testing.assert_array_equal(np.asarray(got.values[name]),
                                      np.asarray(want.values[name]))
    G = torch.from_numpy(tg.to_dense())
    step = tref.cc_propagate_ref(G, torch.from_numpy(c.astype(np.float32)))
    np.testing.assert_array_equal(np.asarray(got.values["propagate"], np.float32),
                                  step.numpy())


def _jax_stages(n, tile_r, tile_c):
    """The reference test's CC-iteration stages for the Pallas walker."""
    def prop_body(ctx, ins, out):
        j_propagate_body(ctx.inner, ins["G"], ins["c_col"], ins["c_row"], out)

    def changed_body(ctx, ins, out):
        out[...] += (ins["propagate"][...]
                     != ins["c_row"][...]).sum().astype(jnp.int32)[None]

    stages = [
        jwalk.WalkStage("propagate", n, (n,), jnp.float32, "concat", prop_body,
                        operands=("G", "c_col", "c_row"), inner=n // tile_c),
        jwalk.WalkStage("changed", n, (1,), jnp.int32, "sum", changed_body,
                        operands=("c_row",), reads=(("propagate", "rows"),)),
    ]
    operands = [
        jwalk.WalkOperand("G", (tile_r, tile_c), ("row", "inner")),
        jwalk.WalkOperand("c_col", (tile_c,), ("inner",)),
        jwalk.WalkOperand("c_row", (tile_r,), ("row",)),
    ]
    return stages, operands


@pytest.mark.parametrize("n_shards", [1, 2])
def test_cc_iteration_walk_matches_pallas(n_shards):
    n, tile_r, tile_c = 256, 32, 64
    rng = np.random.default_rng(7)
    G = (rng.uniform(size=(n, n)) < 0.05).astype(np.float32)
    np.fill_diagonal(G, 0)
    c = rng.integers(1, 1000, n).astype(np.float32)

    dag, stages, operands = tapps.cc_iteration_lowering(n, tile_r, tile_c)
    ddt = build_dag_tables(dag, tile_r, tapps.CC_TECHNIQUES, n_shards=n_shards,
                           n_workers=4)
    jdag = JDAG([JStage("propagate", n, None, combine="concat"),
                 JStage("changed", n, None, combine="sum",
                        deps=(JDep("propagate", "elementwise"),))])
    jddt = j_build_dag_tables(jdag, tile_r, {"propagate": "MFSC", "changed": "STATIC"},
                              n_shards=n_shards, n_workers=4)
    assert np.array_equal(ddt.tables, jddt.tables)
    jst, jops_ = _jax_stages(n, tile_r, tile_c)
    jvals = {"G": jnp.asarray(G), "c_col": jnp.asarray(c), "c_row": jnp.asarray(c)}
    tvals = {"G": torch.from_numpy(G), "c_col": torch.from_numpy(c),
             "c_row": torch.from_numpy(c)}
    if n_shards == 1:
        jout = jwalk.dag_walk(jst, jops_, jvals, ddt.tables[0], tile_r)
        tout = twalk.dag_walk(stages, operands, tvals, ddt.tables[0], tile_r)
    else:
        jout = jwalk.dag_walk_sharded(jst, jops_, jvals, ddt.tables, tile_r)
        tout = twalk.dag_walk_sharded(stages, operands, tvals, ddt.tables, tile_r)
    for name in ("propagate", "changed"):
        np.testing.assert_array_equal(tout[name].numpy(), np.asarray(jout[name]))
    want = jref.cc_propagate_ref(jnp.asarray(G), jnp.asarray(c))
    np.testing.assert_array_equal(tout["propagate"].numpy(), np.asarray(want))
    entry = tapps.cc_iteration_device(tvals["G"], tvals["c_row"], n_shards=n_shards,
                                      tile_r=tile_r, tile_c=tile_c)
    for name in ("propagate", "changed"):
        assert torch.equal(entry[name], tout[name]), name
    assert int(entry["changed"][0]) == int((np.asarray(want) != c).sum())


def test_cc_iteration_lowering_maps_to_the_cc_program():
    dag, stages, operands = tapps.cc_iteration_lowering(1024, 256, 128)
    assert twalk.cuda_program(stages) == ("cc", [0, 1])
    assert twalk.cuda_program(stages[::-1]) == ("cc", [1, 0])
    assert stages[0].inner == 8 and stages[0].device_body in twalk.INNER_BODIES
    with pytest.raises(ValueError, match="multiple of tile_r"):
        tapps.cc_iteration_lowering(1000, 256, 128)


def test_inner_steps_need_a_body_with_an_inner_loop():
    """A stage with inner > 1 whose device body has no inner loop is
    refused, naming the stage; the CC program's propagate is taken."""
    low = tapps.linreg_device_lowering(256, 5, device="cpu")
    odd = [dataclasses.replace(low.stages[0], inner=3), low.stages[1]]
    with pytest.raises(ValueError, match="'moments' has 3 inner steps, but its "
                                         "device body 'linreg.moments'"):
        twalk.cuda_program(odd)
    _, stages, _ = tapps.cc_iteration_lowering(512, 64, 128)
    wrong = [stages[0], dataclasses.replace(stages[1], inner=2)]
    with pytest.raises(ValueError, match="'changed' has 2 inner steps"):
        twalk.cuda_program(wrong)


def test_cc_iteration_on_cpu_launches_no_kernel():
    from repro_torch.kernels import _build

    before = dict(_build.DAG_WALK.launches)
    G = torch.from_numpy(_graphs(scale=8)[1].to_dense())
    tapps.cc_iteration_device(G, torch.arange(1, 257.0), tile_r=64, tile_c=128)
    assert dict(_build.DAG_WALK.launches) == before


# ---------------------------------------------------------------------------
# the CUDA walker's plan for the CC program: flips counted where rows are
# written (kernels/dag_walk.py:count_fusion), no ordering barrier
# ---------------------------------------------------------------------------

CC_TABLE_TECHNIQUES = [tapps.CC_TECHNIQUES, {"propagate": "GSS", "changed": "STATIC"},
                       {"propagate": "FAC2", "changed": "TSS"}, "SS"]


def _cc_tables(n, tile_r, techniques, n_shards):
    dag, stages, operands = tapps.cc_iteration_lowering(n, tile_r, n // 4)
    tables = build_dag_tables(dag, tile_r, techniques, n_shards=n_shards,
                              n_workers=4).tables
    return stages, operands, tables


def _fused_count(plan, stages, table, prop, c_row):
    """The kernel's count on ``plan``: each counting ``propagate`` slot adds
    its rows' flips, each walked ``changed`` slot (the owner body) its own."""
    names = [s.name for s in stages]
    total = 0
    for i in plan.walk:
        sid, start, size = table[i]
        flips = int((prop[start:start + size] != c_row[start:start + size]).sum())
        if names[sid] == "changed" or (len(plan.counts) and plan.counts[i]):
            total += flips
    return total


@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("techniques", CC_TABLE_TECHNIQUES, ids=str)
def test_cc_plan_counts_where_rows_are_written(n_shards, techniques):
    """One launch of a CC table has no grid barrier: every ``changed`` slot
    is counted by the ``propagate`` slot of its rows, which comes earlier
    in the same table; the generic rule alone would put a barrier before
    each ``changed`` run. Emulating the kernel's count on the plan gives
    the plain walk's ``changed`` on every shard."""
    n, tile_r = 1024, 64
    stages, operands, tables = _cc_tables(n, tile_r, techniques, n_shards)
    rng = np.random.default_rng(3)
    G = torch.from_numpy((rng.uniform(size=(n, n)) < 0.02).astype(np.float32))
    c = torch.from_numpy(rng.integers(1, 500, n).astype(np.float32))
    values = {"G": G, "c_col": c, "c_row": c}
    for table in tables:
        plan = twalk.fold_plan(stages, table)
        real = table[:, 2] > 0
        assert plan.n_seg == 1 and not plan.flags.any()
        assert twalk.sync_flags(stages, table).sum() >= 1
        counts, skips = twalk.count_fusion(stages, table)
        assert np.array_equal(plan.counts, counts)
        assert np.array_equal(np.flatnonzero(counts), np.flatnonzero(real & (table[:, 0] == 0)))
        assert np.array_equal(np.flatnonzero(skips), np.flatnonzero(real & (table[:, 0] == 1)))
        assert np.array_equal(plan.walk, np.flatnonzero(real & (table[:, 0] == 0)))
        plain = twalk.dag_walk_plain(stages, operands, values, table, tile_r)
        assert _fused_count(plan, stages, table, plain["propagate"], c) == \
            int(plain["changed"][0])


@pytest.mark.parametrize("n_shards", [1, 2])
def test_cc_stagewise_changed_keeps_its_owner_body(n_shards):
    """A stagewise walk runs ``changed`` alone, reading labels of an earlier
    launch: nothing is counted elsewhere, every ``changed`` slot is walked,
    and no barrier orders it; its count is the plain walk's."""
    n, tile_r = 1024, 64
    stages, operands, tables = _cc_tables(n, tile_r, tapps.CC_TECHNIQUES, n_shards)
    rng = np.random.default_rng(4)
    prop = torch.from_numpy(rng.integers(1, 500, n).astype(np.float32))
    c = torch.where(torch.from_numpy(rng.uniform(size=n) < 0.3), prop + 1, prop)
    solo = dataclasses.replace(stages[1], operands=("c_row", "propagate"), reads=())
    ops = [operands[2], twalk.WalkOperand("propagate", (tile_r,), ("row",))]
    for table in tables:
        sub = table[(table[:, 0] == 1) & (table[:, 2] > 0)].copy()
        sub[:, 0] = 0
        plan = twalk.fold_plan([solo], sub)
        assert len(plan.counts) == 0 and not plan.flags.any()
        assert np.array_equal(plan.walk, np.arange(len(sub)))
        values = {"c_row": c, "propagate": prop}
        want = twalk.dag_walk_plain([solo], ops, values, sub, tile_r)["changed"]
        assert _fused_count(plan, [solo], sub, prop, c) == int(want[0])


def test_count_fusion_needs_the_producer_earlier_in_the_table():
    """A ``changed`` slot whose ``propagate`` slot is missing from the table
    (written in another launch) keeps its owner body and is ordered by a
    barrier after the table's own ``propagate`` slots, as the generic rule
    says; the plans of other programs count nothing."""
    _, stages, _ = tapps.cc_iteration_lowering(256, 64, 64)
    table = np.array([[0, 0, 64], [1, 0, 64], [0, 64, 64], [1, 128, 64],
                      [1, 64, 64], [0, 192, 64], [1, 192, 64]], dtype=np.int32)
    counts, skips = twalk.count_fusion(stages, table)
    assert counts.tolist() == [1, 0, 1, 0, 0, 1, 0]
    assert skips.tolist() == [0, 1, 0, 0, 1, 0, 1]
    plan = twalk.fold_plan(stages, table)
    assert plan.walk.tolist() == [0, 2, 3, 5]
    assert plan.flags.tolist() == [0, 0, 0, 1, 0, 0, 0]
    low = tapps.linreg_device_lowering(256, 5, device="cpu")
    lin_table = np.array([[0, 0, 64]] * 4 + [[1, 0, 64]] * 4, dtype=np.int32)
    assert len(twalk.fold_plan(low.stages, lin_table).counts) == 0
