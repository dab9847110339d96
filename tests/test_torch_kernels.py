"""The port's kernel modules against the JAX package's Pallas kernels.

The same numpy inputs go through the JAX function (Pallas in interpret
mode, as the JAX package's own tests run it) and the port's plain version
on the CPU. Max-, copy- and int32-valued outputs must match bitwise; a
float sum inside a tile is summed in another order by PyTorch and XLA, so
float reductions are held to a relative tolerance of 1e-5 (float32
rounding of a few dozen terms). The CUDA kernels themselves are held
against these plain versions on the card in ``test_torch_cuda.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_dag_tables as j_build_dag_tables
from repro.core import PipelineDAG as JDAG, Stage as JStage, StageDep as JDep
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.cc_propagate import propagate_body as j_propagate_body
from repro.kernels import dag_walk as jwalk
from repro.vee import apps as japps
from repro_torch.core.partitioners import PARTITIONERS
from repro_torch.core import PipelineDAG, Stage, StageDep, build_dag_tables
from repro_torch.kernels import dag_walk as twalk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.cc_propagate import (cc_propagate, cc_propagate_plain,
                                              propagate_body)
from repro_torch.vee import apps as tapps

TECHS = sorted(PARTITIONERS)
FLOAT_RTOL = 1e-5


def _graph(n, seed=7, p=0.05):
    rng = np.random.default_rng(seed)
    G = (rng.uniform(size=(n, n)) < p).astype(np.float32)
    np.fill_diagonal(G, 0)
    c = rng.integers(1, 1000, n).astype(np.float32)
    return G, c


@pytest.mark.parametrize("tech", TECHS)
def test_cc_step_bitwise(tech):
    G, c = _graph(512)
    want = np.asarray(jops.cc_step(jnp.asarray(G), jnp.asarray(c), technique=tech,
                                   tile_r=64, tile_c=128))
    got = tops.cc_step(torch.from_numpy(G), torch.from_numpy(c), technique=tech,
                       tile_r=64, tile_c=128)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tops.dls_tile_schedule(tech, 512, 64),
                          jops.dls_tile_schedule(tech, 512, 64))


def test_cc_propagate_ref_bitwise():
    G, c = _graph(300, seed=1)
    want = np.asarray(jref.cc_propagate_ref(jnp.asarray(G), jnp.asarray(c)))
    got = tref.cc_propagate_ref(torch.from_numpy(G), torch.from_numpy(c))
    assert np.array_equal(got.numpy(), want)


def test_cc_propagate_rejects_bad_shapes():
    G = torch.zeros(96, 96)
    with pytest.raises(ValueError, match="multiple"):
        cc_propagate(G, torch.ones(96), torch.arange(2), tile_r=64, tile_c=32)
    with pytest.raises(ValueError, match="one entry per row tile"):
        cc_propagate(G, torch.ones(96), torch.arange(2), tile_r=32, tile_c=32)


# ---------------------------------------------------------------------------
# the plain walker against the Pallas walker
# ---------------------------------------------------------------------------

def _jax_values(low):
    return {k: np.asarray(v) for k, v in low.values.items()}


def _tables(low, techniques, n_shards=1):
    ddt = build_dag_tables(low.dag, 1, techniques, n_shards=n_shards)
    rows = ddt.tables.copy()
    rows[:, :, 1:] *= low.tile
    return ddt, rows


def _compare(jout, tout, float_sum_names=()):
    for name, jv in jout.items():
        jv, tv = np.asarray(jv), tout[name].cpu().numpy()
        assert tv.dtype == jv.dtype and tv.shape == jv.shape, name
        if name in float_sum_names:
            np.testing.assert_allclose(tv, jv, rtol=FLOAT_RTOL,
                                       atol=FLOAT_RTOL * np.abs(jv).max(), err_msg=name)
        else:
            assert np.array_equal(tv, jv), name


LOWERINGS = {
    # (JAX builder, port builder, args, float reductions)
    "linreg": (japps.linreg_device_lowering, tapps.linreg_device_lowering,
               dict(num_rows=512, num_cols=9, tile=64),
               ("moments", "syrk_gemv")),
    "recommendation": (japps.recommendation_device_lowering,
                       tapps.recommendation_device_lowering,
                       dict(n_users=256, n_items=32, tile=32),
                       ("item_norms", "user_bias")),
}


@pytest.mark.parametrize("name", sorted(LOWERINGS))
@pytest.mark.parametrize("tech", ["STATIC", "GSS", "FAC2"])
def test_plain_walker_matches_pallas(name, tech):
    jbuild, tbuild, kw, sums = LOWERINGS[name]
    jlow, tlow = jbuild(**kw), tbuild(**kw, device="cpu")
    _, rows = _tables(tlow, tech)
    jout, jst = jwalk.dag_walk(jlow.stages, jlow.operands, jlow.values, rows[0],
                               jlow.tile, stamp=True)
    tout, tst = twalk.dag_walk(tlow.stages, tlow.operands, tlow.values, rows[0],
                               tlow.tile, stamp=True)
    _compare(jout, tout, sums)
    assert np.array_equal(tst, np.asarray(jst))
    # the stagewise baseline: the same per-tile work, so equal to the fused walk
    sw = twalk.dag_walk_stagewise(tlow.stages, tlow.operands, tlow.values,
                                  rows[0], tlow.tile)
    for k in tout:
        assert torch.equal(sw[k], tout[k]), k
    jsw = jwalk.dag_walk_stagewise(jlow.stages, jlow.operands, jlow.values,
                                   rows[0], jlow.tile)
    _compare(jsw, sw, sums)


def _cc_stages(walk, n, tile_r, tile_c, torch_side):
    """The CC two-stage program (propagate concat + changed sum)."""
    if torch_side:
        def prop_body(ctx, ins, out):
            propagate_body(ctx.inner, ins["G"], ins["c_col"], ins["c_row"], out)

        def changed_body(ctx, ins, out):
            out += (ins["propagate"] != ins["c_row"]).sum().to(torch.int32)[None]
        f32, i32 = torch.float32, torch.int32
    else:
        def prop_body(ctx, ins, out):
            j_propagate_body(ctx.inner, ins["G"], ins["c_col"], ins["c_row"], out)

        def changed_body(ctx, ins, out):
            out[...] += (ins["propagate"][...]
                         != ins["c_row"][...]).sum().astype(jnp.int32)[None]
        f32, i32 = jnp.float32, jnp.int32
    stages = [
        walk.WalkStage("propagate", n, (n,), f32, "concat", prop_body,
                       operands=("G", "c_col", "c_row"), inner=n // tile_c),
        walk.WalkStage("changed", n, (1,), i32, "sum", changed_body,
                       operands=("c_row",), reads=(("propagate", "rows"),)),
    ]
    operands = [
        walk.WalkOperand("G", (tile_r, tile_c), ("row", "inner")),
        walk.WalkOperand("c_col", (tile_c,), ("inner",)),
        walk.WalkOperand("c_row", (tile_r,), ("row",)),
    ]
    return stages, operands


@pytest.mark.parametrize("n_shards", [1, 2])
def test_cc_two_stage_walk_matches_pallas(n_shards):
    n, tile_r, tile_c = 256, 32, 64
    G, c = _graph(n)
    dag = PipelineDAG([
        Stage("propagate", n, None, combine="concat"),
        Stage("changed", n, None, combine="sum",
              deps=(StageDep("propagate", "elementwise"),)),
    ])
    ddt = build_dag_tables(dag, tile_r, {"propagate": "MFSC", "changed": "STATIC"},
                           n_shards=n_shards, n_workers=4)
    jdag = JDAG([JStage("propagate", n, None, combine="concat"),
                 JStage("changed", n, None, combine="sum",
                        deps=(JDep("propagate", "elementwise"),))])
    jddt = j_build_dag_tables(jdag, tile_r, {"propagate": "MFSC", "changed": "STATIC"},
                              n_shards=n_shards, n_workers=4)
    assert np.array_equal(ddt.tables, jddt.tables)
    jst, jops_ = _cc_stages(jwalk, n, tile_r, tile_c, torch_side=False)
    tst, tops_ = _cc_stages(twalk, n, tile_r, tile_c, torch_side=True)
    jvals = {"G": jnp.asarray(G), "c_col": jnp.asarray(c), "c_row": jnp.asarray(c)}
    tvals = {"G": torch.from_numpy(G), "c_col": torch.from_numpy(c),
             "c_row": torch.from_numpy(c)}
    if n_shards == 1:
        jout, jstamps = jwalk.dag_walk(jst, jops_, jvals, ddt.tables[0], tile_r,
                                       stamp=True)
        tout, tstamps = twalk.dag_walk(tst, tops_, tvals, ddt.tables[0], tile_r,
                                       stamp=True)
        assert np.array_equal(tstamps, np.asarray(jstamps))
    else:
        jout = jwalk.dag_walk_sharded(jst, jops_, jvals, ddt.tables, tile_r)
        tout = twalk.dag_walk_sharded(tst, tops_, tvals, ddt.tables, tile_r)
    _compare(jout, tout)
    want = tref.cc_propagate_ref(tvals["G"], tvals["c_row"])
    assert torch.equal(tout["propagate"], want)
    assert int(tout["changed"][0]) == int((want != tvals["c_row"]).sum())


@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_walk_matches_pallas(n_shards):
    """Recommendation's concat stages alone shard; sums add in shard order."""
    jlow = japps.recommendation_device_lowering(256, 32, tile=32)
    tlow = tapps.recommendation_device_lowering(256, 32, tile=32, device="cpu")
    keep = ("item_norms", "user_bias")
    jst = [s for s in jlow.stages if s.name in keep]
    tst = [s for s in tlow.stages if s.name in keep]
    dag = PipelineDAG([Stage(n, 8, None, combine=s.combine) for n, s in
                       zip(keep, tst)])
    ddt = build_dag_tables(dag, 1, "GSS", n_shards=n_shards, n_workers=4)
    rows = ddt.tables.copy()
    rows[:, :, 1:] *= 32
    jout = jwalk.dag_walk_sharded(jst, jlow.operands, jlow.values, rows, 32)
    tout = twalk.dag_walk_sharded(tst, tlow.operands, tlow.values, rows, 32)
    _compare(jout, tout, ("item_norms", "user_bias"))


def test_device_table_cache():
    twalk.clear_device_table_cache()
    table = np.array([[0, 0, 4], [0, 4, 4]], dtype=np.int32)
    cpu = torch.device("cpu")
    a = twalk._device_table(table, cpu)
    b = twalk._device_table(table, cpu)
    assert a is b and a.table.dtype == torch.int32
    assert torch.equal(a.table, torch.from_numpy(table)) and a.plans == {}
    twalk._device_table(table + 1, cpu)  # new content: its own entry
    assert twalk.device_table_cache_stats() == {"hits": 1, "misses": 2, "size": 2}
    for k in range(twalk._DEVICE_TABLE_CACHE_SIZE):  # the oldest entries go first
        twalk._device_table(table + 2 + k, cpu)
    assert twalk.device_table_cache_stats()["size"] == twalk._DEVICE_TABLE_CACHE_SIZE
    assert twalk._device_table(table, cpu) is not a
    twalk.clear_device_table_cache()
    assert twalk.device_table_cache_stats() == {"hits": 0, "misses": 0, "size": 0}


def test_cuda_program_maps_stage_ids_to_bodies():
    low = tapps.recommendation_device_lowering(64, 8, tile=32, device="cpu")
    prog, body_map = twalk.cuda_program(low.stages)
    assert prog == "recommendation" and body_map == [0, 1, 2]
    # stage ids follow the table builder's order, not the program's
    prog, body_map = twalk.cuda_program(low.stages[::-1])
    assert body_map == [2, 1, 0]
    solo = dataclasses.replace(low.stages[2], reads=())
    assert twalk.cuda_program([solo]) == ("recommendation", [2])


def test_cuda_program_raises_without_device_body():
    low = tapps.linreg_device_lowering(128, 5, device="cpu")
    bare = dataclasses.replace(low.stages[1], device_body=None)
    with pytest.raises(ValueError, match="'syrk_gemv' has no device body"):
        twalk.cuda_program([low.stages[0], bare])
    stages, _ = _cc_stages(twalk, 64, 32, 32, torch_side=True)
    with pytest.raises(ValueError, match="'propagate' has no device body"):
        twalk.cuda_program(stages)
    mixed = [low.stages[0], tapps.recommendation_device_lowering(
        64, 8, tile=32, device="cpu").stages[0]]
    with pytest.raises(ValueError, match="no compiled walker program"):
        twalk.cuda_program(mixed)


def test_sync_flags_only_where_a_dirty_producer_is_read():
    rec = tapps.recommendation_device_lowering(128, 8, tile=32, device="cpu")
    # item_norms, user_bias interleaved, then scores reads both
    table = np.array([[0, 0, 32], [1, 0, 32], [0, 32, 32], [1, 32, 32],
                      [2, 0, 32], [1, 64, 32], [2, 32, 32], [0, 0, 0],
                      [2, 64, 32]], dtype=np.int32)
    flags = twalk.sync_flags(rec.stages, table)
    assert flags.tolist() == [0, 0, 0, 0, 1, 0, 1, 0, 0]
    lin = tapps.linreg_device_lowering(256, 5, device="cpu")
    lin_table = np.array([[0, 0, 64]] * 4 + [[1, 0, 64]] * 4, dtype=np.int32)
    assert twalk.sync_flags(lin.stages, lin_table).tolist() == [0] * 4 + [1] + [0] * 3


def test_cpu_path_launches_no_kernel():
    """On CPU tensors the wrappers run the plain version and count nothing."""
    from repro_torch.kernels import _build

    before = {k.source.name: dict(k.launches) for k in _build.KERNELS}
    tapps.recommendation_device(128, 16, tile=32, device="cpu")
    G, c = _graph(256)
    tops.cc_step(torch.from_numpy(G), torch.from_numpy(c), tile_r=64, tile_c=128)
    assert {k.source.name: dict(k.launches) for k in _build.KERNELS} == before


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor on neither the CPU nor CUDA is refused, not walked plainly."""
    low = tapps.linreg_device_lowering(128, 5, device="meta")
    rows = build_dag_tables(low.dag, 1, "GSS").tables[0].copy()
    rows[:, 1:] *= low.tile
    with pytest.raises(ValueError, match="unsupported device meta"):
        twalk.dag_walk(low.stages, low.operands, low.values, rows, low.tile)
    G = torch.zeros(128, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        cc_propagate(G, torch.ones(128, device="meta"), torch.arange(2), tile_r=64,
                     tile_c=64)
