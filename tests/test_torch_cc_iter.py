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
