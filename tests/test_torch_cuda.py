"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one. The file imports neither ``jax`` nor ``repro``, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the kernel sums a tile's rows in another order than PyTorch's
reduction, so float sums agree to a relative 1e-4 of the output's largest
magnitude; ``scores`` (an argmax over IEEE-rounded arithmetic), stamps,
max-valued outputs and the stagewise walk must match bitwise. ``beta``
agrees with the float64 oracle to 1e-2 of its largest feature entry (the
features' betas are small: y is drawn apart from X). A migrated run's sums
are held to the unmigrated kernel walk by the same ``SUM_RTOL``: the host
part sums its tiles in PyTorch's order, the kernel in its own. The MoE
program's slabs (two fp32 products of a few hundred terms each) are held
to the plain body by the same ``SUM_RTOL``. A member of a batched walk
must be bitwise equal to its lowering walked alone.
"""

import dataclasses
import importlib.util
import math
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import (PipelineDAG, PreemptiveRunner, SchedulerConfig,
                              Stage, build_dag_tables, rebalance_dag,
                              select_offline_device_dag)
from repro_torch.core.preempt import device_remainder
from repro_torch.core.partitioners import PARTITIONERS
from repro_torch.kernels import _build
from repro_torch.kernels import dag_walk as twalk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.cc_propagate import cc_propagate, cc_propagate_plain
from repro_torch.configs import get_config
from repro_torch.vee import apps as tapps
from repro_torch.vee import ml_apps as tml
from repro_torch.vee.sparse import rmat_graph

SUM_RTOL = 1e-4
ROOT = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rows(low, techniques, n_shards=1):
    rows = build_dag_tables(low.dag, 1, techniques, n_shards=n_shards).tables.copy()
    rows[:, :, 1:] *= low.tile
    return rows


def _close_sum(got, want, what):
    torch.testing.assert_close(got, want, rtol=SUM_RTOL,
                               atol=SUM_RTOL * float(want.abs().max()), msg=what)


LOWERINGS = {
    "linreg": (tapps.linreg_device_lowering, dict(num_rows=4096, num_cols=33)),
    "recommendation": (tapps.recommendation_device_lowering,
                       dict(n_users=2048, n_items=256)),
}


@pytest.mark.parametrize("name", sorted(LOWERINGS))
@pytest.mark.parametrize("tech", ["GSS", "TSS"])
def test_walker_matches_plain(cuda, name, tech):
    build, kw = LOWERINGS[name]
    low = build(**kw, device=cuda)
    rows = _rows(low, tech)[0]
    before = _build.DAG_WALK.launches[f"walk_{name}"]
    got, stamps = twalk.dag_walk(low.stages, low.operands, low.values, rows,
                                 low.tile, stamp=True)
    assert _build.DAG_WALK.launches[f"walk_{name}"] == before + 1
    want = twalk.dag_walk_plain(low.stages, low.operands, low.values, rows, low.tile)
    assert np.array_equal(stamps, np.c_[rows, np.arange(len(rows))])
    for k in got:
        if k != "scores":
            _close_sum(got[k], want[k], k)
    if name == "recommendation":
        assert torch.equal(got["scores"], tapps.scores_plain(
            low.values["R"], got["item_norms"], got["user_bias"]))
    sw = twalk.dag_walk_stagewise(low.stages, low.operands, low.values, rows,
                                  low.tile)
    for k in got:
        assert torch.equal(sw[k], got[k]), k


@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_walk_matches_plain(cuda, n_shards):
    low = tapps.recommendation_device_lowering(2048, 256, device=cuda)
    keep = [s for s in low.stages if s.name != "scores"]
    dag = PipelineDAG([Stage(s.name, 2048 // low.tile, None, combine=s.combine)
                       for s in keep])
    rows = build_dag_tables(dag, 1, "GSS", n_shards=n_shards, n_workers=4).tables.copy()
    rows[:, :, 1:] *= low.tile
    got = twalk.dag_walk_sharded(keep, low.operands, low.values, rows, low.tile)
    cpu_vals = {k: v.cpu() for k, v in low.values.items()}
    want = twalk.dag_walk_sharded(keep, low.operands, cpu_vals, rows, low.tile)
    for k in got:
        assert got[k].device.type == "cuda"
        _close_sum(got[k].cpu(), want[k], k)


def test_walk_raises_without_device_body(cuda):
    low = tapps.linreg_device_lowering(512, 9, device=cuda)
    bare = [low.stages[0], dataclasses.replace(low.stages[1], device_body=None)]
    before = sum(_build.DAG_WALK.launches.values())
    with pytest.raises(ValueError, match="'syrk_gemv' has no device body"):
        twalk.dag_walk(bare, low.operands, low.values, _rows(low, "GSS")[0], low.tile)
    assert sum(_build.DAG_WALK.launches.values()) == before


@pytest.mark.parametrize("tech", sorted(PARTITIONERS))
def test_cc_propagate_bitwise(cuda, tech):
    rng = np.random.default_rng(7)
    G = torch.from_numpy((rng.uniform(size=(1024, 1024)) < 0.05).astype(np.float32))
    c = torch.from_numpy(rng.integers(1, 1000, 1024).astype(np.float32))
    G, c = G.to(cuda), c.to(cuda)
    sched = torch.from_numpy(tops.dls_tile_schedule(tech, 1024, 256)).to(cuda)
    got = cc_propagate(G, c, sched)
    assert torch.equal(got, cc_propagate_plain(G, c, sched))
    assert torch.equal(got, tref.cc_propagate_ref(G, c))
    assert torch.equal(tops.cc_step(G, c, technique=tech), got)


def _cc_case(cuda, n, seed, density=0.05):
    rng = np.random.default_rng(seed)
    G = torch.from_numpy((rng.uniform(size=(n, n)) < density).astype(np.float32)).to(cuda)
    c = torch.from_numpy(rng.integers(1, 10 * n, n).astype(np.float32)).to(cuda)
    return G, c


def _cc_poisoned(cuda, G, c, sched, **tiles):
    """``cc_propagate`` after the allocator has held NaN in a block of the
    output's size, so a row the kernel leaves unwritten shows."""
    poison = torch.full((G.shape[0],), float("nan"), device=cuda)
    del poison
    return cc_propagate(G, c, sched, **tiles)


@pytest.mark.parametrize("tile_r,tile_c", [(64, 256), (96, 4), (8, 1536), (1536, 512)])
def test_cc_propagate_bitwise_at_other_tiles(cuda, tile_r, tile_c):
    """Row tiles of 64, 96 (12 groups of 8 rows), 8 (one group) and the
    whole matrix, under every technique: bitwise the plain walk and the
    reference."""
    G, c = _cc_case(cuda, 1536, 5)
    want = tref.cc_propagate_ref(G, c)
    for tech in sorted(PARTITIONERS):
        sched = torch.from_numpy(tops.dls_tile_schedule(tech, 1536, tile_r)).to(cuda)
        got = _cc_poisoned(cuda, G, c, sched, tile_r=tile_r, tile_c=tile_c)
        assert torch.equal(got, want), tech
        assert torch.equal(got, cc_propagate_plain(G, c, sched, tile_r, tile_c)), tech


def test_cc_propagate_padding_slots_do_nothing(cuda):
    """Slots holding -1 or the tile count visit no tile: the other tiles'
    rows are bitwise the reference's, and so are the plain walk's."""
    G, c = _cc_case(cuda, 2048, 6)
    sched = torch.from_numpy(tops.dls_tile_schedule("GSS", 2048, 128)).to(cuda)
    skipped = sched[[1, 5, 9]].tolist()
    sched[1], sched[5], sched[9] = -1, 16, 17
    got = _cc_poisoned(cuda, G, c, sched, tile_r=128, tile_c=1024)
    plain = cc_propagate_plain(G, c, sched, 128, 1024)
    want = tref.cc_propagate_ref(G, c)
    rows = torch.ones(2048, dtype=torch.bool, device=cuda)
    for t in skipped:
        rows[t * 128:(t + 1) * 128] = False
    assert torch.equal(got[rows], want[rows]) and torch.equal(plain[rows], want[rows])


def test_cc_propagate_bitwise_at_the_smokes_size(cuda):
    """n = 16,384 (1 GiB of G), the smoke's size, under three techniques."""
    G, c = _cc_case(cuda, 16384, 8, density=0.001)
    want = tref.cc_propagate_ref(G, c)
    for tech in ("STATIC", "MFSC", "TSS"):
        sched = torch.from_numpy(tops.dls_tile_schedule(tech, 16384, 256)).to(cuda)
        assert torch.equal(_cc_poisoned(cuda, G, c, sched), want), tech


def test_end_to_end_small(cuda):
    beta, _, _ = tapps.linear_regression_device(8192, 17)
    ref = tapps.linear_regression_oracle(8192, 17)
    np.testing.assert_allclose(beta, ref, atol=1e-2 * np.abs(ref[:-1]).max())
    top, _, _ = tapps.recommendation_device(1024, 128)
    assert top.device.type == "cuda"
    agree = (top.cpu().numpy() == tapps.recommendation_oracle(1024, 128)).mean()
    assert agree >= 0.999


def _seeded_remainder(low, cut):
    cfg = SchedulerConfig(technique="SS", queue_layout="CENTRALIZED", n_workers=1)
    _, ck = PreemptiveRunner(low.dag, cfg, preempt_after=cut).run()
    return device_remainder(ck, low)


@pytest.mark.parametrize("name,cut", [("linreg", 40), ("linreg", 70),
                                      ("recommendation", 10)])
def test_seeded_walk_matches_plain(cuda, name, cut):
    build, kw = LOWERINGS[name]
    low = build(**kw, device=cuda)
    plan = _seeded_remainder(low, cut)
    seeded = [s.name for s in plan.stages if s.seed is not None]
    assert seeded and all(plan.values[s.seed].device.type == "cuda"
                          for s in plan.stages if s.seed)
    before = _build.DAG_WALK.launches[f"walk_{name}"]
    got = plan.walk()
    assert _build.DAG_WALK.launches[f"walk_{name}"] == before + 1
    want = twalk.dag_walk_plain(plan.stages, plan.operands, plan.values,
                                plan.table, plan.tile)
    for k in seeded:
        _close_sum(got[k], want[k], k)
        seed = plan.values[f"{k}__resume"]
        assert not torch.equal(got[k], seed)  # the walk added to the seed


@pytest.mark.parametrize("direction", ["host_to_device", "device_to_host"])
def test_migration_on_card_matches_unmigrated(cuda, direction):
    n, d1 = LOWERINGS["linreg"][1].values()
    want, want_vals, _ = tapps.linear_regression_device(n, d1)
    before = _build.DAG_WALK.launches["walk_linreg"]
    cut = {"host_to_device": n // 64 + 3, "device_to_host": 2 * (n // 64) - 5}
    beta, vals, seconds = tapps.linear_regression_migrated(n, d1, cut[direction],
                                                           direction=direction)
    assert _build.DAG_WALK.launches["walk_linreg"] == before + 1
    assert seconds["walk"] > 0 and seconds["host"] > 0
    for k in want_vals:
        assert vals[k].device.type == "cuda"
        _close_sum(vals[k], want_vals[k], k)
    np.testing.assert_allclose(beta, want, atol=1e-2 * np.abs(want[:-1]).max())

    users, items = LOWERINGS["recommendation"][1].values()
    low = tapps.recommendation_device_lowering(users, items, device=cuda)
    want_vals, _ = tapps.run_device_dag(low, "SS")
    before = _build.DAG_WALK.launches["walk_recommendation"]
    cut = {"host_to_device": 9, "device_to_host": 2 * (users // 64) - 7}
    top, vals, _ = tapps.recommendation_migrated(users, items, cut[direction],
                                                 direction=direction)
    assert _build.DAG_WALK.launches["walk_recommendation"] == before + 1
    for k in ("item_norms", "user_bias"):
        _close_sum(vals[k], want_vals[k], k)
    assert top.device.type == "cuda"
    assert torch.equal(top, tapps.scores_plain(low.values["R"], vals["item_norms"],
                                               vals["user_bias"]))


def test_seeded_stage_refuses_multi_shard_walk_on_card(cuda):
    low = tapps.recommendation_device_lowering(2048, 256, device=cuda)
    keep = [s for s in low.stages if s.name != "scores"]
    stages = [dataclasses.replace(keep[0], seed="seed"), keep[1]]
    dag = PipelineDAG([Stage(s.name, 2048 // low.tile, None, combine=s.combine)
                       for s in keep])
    rows = build_dag_tables(dag, 1, "GSS", n_shards=2, n_workers=4).tables.copy()
    rows[:, :, 1:] *= low.tile
    values = dict(low.values, seed=torch.zeros(256, device=cuda))
    before = sum(_build.DAG_WALK.launches.values())
    with pytest.raises(ValueError, match="'item_norms' starts from seed"):
        twalk.dag_walk_sharded(stages, low.operands, values, rows, low.tile)
    assert sum(_build.DAG_WALK.launches.values()) == before
    with pytest.raises(ValueError, match="seed 'seed' lies on cpu"):
        twalk.dag_walk(stages, low.operands, dict(values, seed=torch.zeros(256)),
                       rows[0], low.tile)
    assert sum(_build.DAG_WALK.launches.values()) == before


def _launches():
    return sum(_build.DAG_WALK.launches.values())


# MoE widths: the reduced config, and one whose capacity (75), d (200) and
# f (100) all leave ragged 64 x 64 tiles
MOE_SHAPES = {
    "reduced": dict(n_tokens=96),
    "ragged": dict(n_tokens=150, d_model=200, d_ff_expert=100, n_routed=5),
}


def _moe_lowering(cuda, shape):
    kw = dict(MOE_SHAPES[shape])
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    if "d_model" in kw:
        moe = dataclasses.replace(cfg.moe, d_ff_expert=kw.pop("d_ff_expert"),
                                  n_routed=kw.pop("n_routed"))
        cfg = dataclasses.replace(cfg, d_model=kw.pop("d_model"), moe=moe)
    return tml.moe_dispatch_lowering_for(cfg, seed=4, device=cuda, **kw)


@pytest.mark.parametrize("shape", sorted(MOE_SHAPES))
@pytest.mark.parametrize("tech", ["STATIC", "GSS"])
def test_moe_walk_matches_plain(cuda, shape, tech):
    low = _moe_lowering(cuda, shape)
    dlow = tml.moe_device_lowering(low)
    rows = _rows(dlow, tech)[0]
    before = _build.DAG_WALK.launches["walk_moe"]
    got = twalk.dag_walk(dlow.stages, dlow.operands, dlow.values, rows, dlow.tile)
    assert _build.DAG_WALK.launches["walk_moe"] == before + 1
    want = twalk.dag_walk_plain(dlow.stages, dlow.operands, dlow.values, rows,
                                dlow.tile)
    _close_sum(got["experts"], want["experts"], "experts")
    vals, _ = tapps.run_device_dag(dlow, tech)
    assert torch.equal(vals["experts"], got["experts"])   # deterministic
    y = dlow.finalize(vals)
    assert y.device.type == "cuda"
    _close_sum(y, dlow.finalize(want), "combined")
    _close_sum(y.cpu(), torch.from_numpy(low.run_direct()), "vs host pipeline")


def _smoke():
    """``chip_smoke.py`` as a module (at module level it imports the
    standard library and the port's ``kernels/limits.py``): its MoE and
    K5 limits."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _moe_within_limits(got, dlow):
    """Every slab entry within both of the smoke's float64 limits
    (``moe_limits``), one slab at a time."""
    smoke = _smoke()
    c, wi, wo = dlow.tile, dlow.values["wi"], dlow.values["wo"]
    for g in range(wi.shape[0]):
        sl = slice(g * c, (g + 1) * c)
        ref, lim, lim_rss = smoke.moe_limits(dlow.values["xdisp"][sl].double(),
                                             wi[g].double(), wo[g].double())
        for limit in (lim, lim_rss):
            assert smoke.beyond(got[sl], ref, limit)[0] == 0, g


def test_moe_walk_against_float64(cuda):
    low = _moe_lowering(cuda, "ragged")
    dlow = tml.moe_device_lowering(low)
    _moe_within_limits(tapps.run_device_dag(dlow)[0]["experts"], dlow)


# widths past every tile edge of the kernel (128 x 128 output tiles, 32-wide
# k stages, 64-column gated tiles): capacity, d and f are multiples of 4
# and of nothing larger that the kernel tiles by
MOE_OFF_TILE = {"d332_f172": dict(n_tokens=210, d_model=332, d_ff_expert=172, n_routed=7),
                "d196_f300": dict(n_tokens=90, d_model=196, d_ff_expert=300, n_routed=3)}


@pytest.mark.parametrize("shape", sorted(MOE_OFF_TILE))
def test_moe_walk_at_widths_off_the_tile(cuda, shape):
    kw = dict(MOE_OFF_TILE[shape])
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    moe = dataclasses.replace(cfg.moe, d_ff_expert=kw.pop("d_ff_expert"),
                              n_routed=kw.pop("n_routed"))
    cfg = dataclasses.replace(cfg, d_model=kw.pop("d_model"), moe=moe)
    dlow = tml.moe_device_lowering(tml.moe_dispatch_lowering_for(cfg, seed=5, device=cuda,
                                                                 **kw))
    assert dlow.tile % 128 and cfg.d_model % 32 and cfg.moe.d_ff_expert % 64
    rows = _rows(dlow, "GSS")[0]
    before = _build.DAG_WALK.launches["walk_moe"]
    got = twalk.dag_walk(dlow.stages, dlow.operands, dlow.values, rows, dlow.tile)["experts"]
    assert _build.DAG_WALK.launches["walk_moe"] == before + 1
    want = twalk.dag_walk_plain(dlow.stages, dlow.operands, dlow.values, rows,
                                dlow.tile)["experts"]
    _close_sum(got, want, "experts")
    _moe_within_limits(got, dlow)


def test_moe_batched_walk_bitwise_equal_to_single_walks(cuda):
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    lows = [tml.moe_device_lowering(tml.moe_dispatch_lowering_for(
        cfg, n_tokens=96, seed=s, device=cuda)) for s in (1, 2, 3)]
    singles = [tapps.run_device_dag(low, "GSS")[0] for low in lows]
    merged = tapps.merge_device_lowerings(lows)
    before = _build.DAG_WALK.launches["walk_moe"]
    vals, _ = tapps.run_device_dag(merged, "GSS")
    assert _build.DAG_WALK.launches["walk_moe"] == before + 1
    for j, member in enumerate(tapps.split_device_values(vals, len(lows))):
        assert torch.equal(member["experts"], singles[j]["experts"]), j


def test_moe_widths_off_four_launch_nothing(cuda):
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    cfg = dataclasses.replace(cfg, d_model=66)
    dlow = tml.moe_device_lowering(tml.moe_dispatch_lowering_for(cfg, n_tokens=32, seed=1,
                                                                 device=cuda))
    before = _launches()
    with pytest.raises(ValueError, match="multiples of 4"):
        twalk.dag_walk(dlow.stages, dlow.operands, dlow.values, _rows(dlow, "GSS")[0],
                       dlow.tile)
    assert _launches() == before


def test_moe_walk_runs_on_tensor_cores(cuda):
    """The MoE program's SASS issues Hopper warpgroup products (HGMMA); the
    other programs' issue none."""
    _build.DAG_WALK._load()
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    assert tool, "cuobjdump not found beside nvcc"
    sass = subprocess.run([tool, "-sass", str(_build.DAG_WALK.library)],
                          capture_output=True, text=True, check=True).stdout
    funcs = {f.split("\n", 1)[0]: f for f in re.split(r"\n\s*Function : ", sass)
             if "walk_kernel" in f.split("\n", 1)[0]}
    moe = [f for name, f in funcs.items() if "3MoeE" in name]
    others = [f for name, f in funcs.items() if "3MoeE" not in name]
    assert len(moe) == 1 and len(others) == 3
    assert "HGMMA" in moe[0]
    assert not any("HGMMA" in f for f in others)


@pytest.mark.parametrize("name", sorted(LOWERINGS))
def test_batched_walk_bitwise_equal_to_single_walks(cuda, name):
    build, kw = LOWERINGS[name]
    lows = [build(**kw, seed=s, device=cuda) for s in (1, 2, 3)]
    singles = [tapps.run_device_dag(low, "GSS")[0] for low in lows]
    merged = tapps.merge_device_lowerings(lows)
    before = _build.DAG_WALK.launches[f"walk_{name}"]
    vals, _ = tapps.run_device_dag(merged, "GSS")
    assert _build.DAG_WALK.launches[f"walk_{name}"] == before + 1
    for j, member in enumerate(tapps.split_device_values(vals, len(lows))):
        for k in singles[j]:
            assert torch.equal(member[k], singles[j][k]), (j, k)
    want = twalk.dag_walk_plain(merged.stages, merged.operands, merged.values,
                                _rows(merged, "GSS")[0], merged.tile)
    for k in want:
        if not k.startswith("scores"):
            _close_sum(vals[k], want[k], k)


def test_batched_linreg_members_of_different_widths(cuda):
    lows = [tapps.linreg_device_lowering(2048, d1, seed=s, device=cuda)
            for s, d1 in ((1, 17), (2, 65), (3, 33))]
    singles = [tapps.run_device_dag(low)[0] for low in lows]
    vals, _ = tapps.run_device_dag(tapps.merge_device_lowerings(lows))
    for j, member in enumerate(tapps.split_device_values(vals, len(lows))):
        for k in singles[j]:
            assert torch.equal(member[k], singles[j][k]), (j, k)


def test_batch_refusals_launch_nothing(cuda):
    lin = tapps.linreg_device_lowering(512, 9, tile=64, device=cuda)
    rec = tapps.recommendation_device_lowering(512, 16, tile=64, device=cuda)
    mixed = tapps.merge_device_lowerings([lin, rec])
    rows = _rows(mixed, "GSS")[0]
    before = _launches()
    with pytest.raises(ValueError, match="a batch runs one program"):
        twalk.dag_walk(mixed.stages, mixed.operands, mixed.values, rows, mixed.tile)
    nine = tapps.merge_device_lowerings(
        [tapps.linreg_device_lowering(128, 5, seed=s, device=cuda) for s in range(9)])
    with pytest.raises(ValueError, match="batch of 9 members"):
        tapps.run_device_dag(nine)
    assert _launches() == before
    # the plain walker still runs the mixed batch, on the CPU
    cpu_vals = {k: v.cpu() for k, v in mixed.values.items()}
    out = twalk.dag_walk(mixed.stages, mixed.operands, cpu_vals, rows, mixed.tile)
    assert set(out) == {s.name for s in mixed.stages}
    assert _launches() == before


# ---------------------------------------------------------------------------
# the CC-iteration program (the walker's inner axis) and K4 flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2])
def test_cc_iteration_walk_bitwise(cuda, n_shards):
    """Max and an int32 count are exact: the walk equals the plain walk,
    the reference step and the flip count bitwise, one launch a shard."""
    n = 2048
    rng = np.random.default_rng(7)
    G = torch.from_numpy((rng.uniform(size=(n, n)) < 0.02).astype(np.float32)).to(cuda)
    c = torch.from_numpy(rng.integers(1, 1000, n).astype(np.float32)).to(cuda)
    before = _build.DAG_WALK.launches["walk_cc"]
    got = tapps.cc_iteration_device(G, c, n_shards=n_shards, tile_r=256, tile_c=512)
    assert _build.DAG_WALK.launches["walk_cc"] == before + n_shards
    want = tref.cc_propagate_ref(G, c)
    assert torch.equal(got["propagate"], want)
    assert int(got["changed"][0]) == int((want != c).sum())
    dag, stages, operands = tapps.cc_iteration_lowering(n, 256, 512)
    tables = build_dag_tables(dag, 256, tapps.CC_TECHNIQUES, n_shards=n_shards,
                              n_workers=4).tables
    values = {"G": G, "c_col": c, "c_row": c}
    for s in range(n_shards):
        walked = twalk.dag_walk(stages, operands, values, tables[s], 256)
        plain = twalk.dag_walk_plain(stages, operands, values, tables[s], 256)
        for k in walked:
            assert torch.equal(walked[k], plain[k]), k


@pytest.mark.parametrize("n_shards", [1, 2])
def test_cc_iteration_fused_and_stagewise_bitwise(cuda, n_shards):
    """Each shard's table in one launch (its flips counted where its rows
    are written, no barrier) and stagewise (``changed`` alone, its owner
    body): both bitwise the plain walk."""
    n = 4096
    rng = np.random.default_rng(11)
    G = torch.from_numpy((rng.uniform(size=(n, n)) < 0.01).astype(np.float32)).to(cuda)
    c = torch.from_numpy(rng.integers(1, 2000, n).astype(np.float32)).to(cuda)
    dag, stages, operands = tapps.cc_iteration_lowering(n, 256, 1024)
    tables = build_dag_tables(dag, 256, tapps.CC_TECHNIQUES, n_shards=n_shards,
                              n_workers=4).tables
    values = {"G": G, "c_col": c, "c_row": c}
    for table in tables:
        plan = twalk.fold_plan(stages, table)
        assert not plan.flags.any() and plan.counts.any()
        plain = twalk.dag_walk_plain(stages, operands, values, table, 256)
        before = _build.DAG_WALK.launches["walk_cc"]
        fused = twalk.dag_walk(stages, operands, values, table, 256)
        assert _build.DAG_WALK.launches["walk_cc"] == before + 1
        staged = twalk.dag_walk_stagewise(stages, operands, values, table, 256)
        assert _build.DAG_WALK.launches["walk_cc"] == before + 3
        for k in plain:
            assert torch.equal(fused[k], plain[k]), k
            assert torch.equal(staged[k], plain[k]), k


def _cc_graph_on(cuda, scale=12):
    graph = rmat_graph(scale=scale, edge_factor=8)
    G = torch.from_numpy(graph.to_dense()).to(cuda)
    c = torch.arange(1, graph.n_rows + 1, dtype=torch.float32, device=cuda)
    return graph, G, c


def _cc_tables_walk_bitwise(tables, stages, operands, G, c):
    """Every shard's table bitwise its plain walk; the sharded walk
    bitwise the reference step, its flips exact, one launch a shard."""
    values = {"G": G, "c_col": c, "c_row": c}
    for table in tables:
        walked = twalk.dag_walk(stages, operands, values, table, 256)
        plain = twalk.dag_walk_plain(stages, operands, values, table, 256)
        for k in walked:
            assert torch.equal(walked[k], plain[k]), k
    before = _build.DAG_WALK.launches["walk_cc"]
    got = twalk.dag_walk_sharded(stages, operands, values, tables, 256)
    assert _build.DAG_WALK.launches["walk_cc"] == before + len(tables)
    want = tref.cc_propagate_ref(G, c)
    assert torch.equal(got["propagate"], want)
    assert int(got["changed"][0]) == int((want != c).sum())


@pytest.mark.parametrize("n_shards", [1, 2])
def test_tuned_cc_table_walks_bitwise(cuda, n_shards):
    """The device tuner's per-stage techniques (Listing 1's per-row cost,
    nnz + 1), frozen and walked: bitwise the plain walk and the step."""
    graph, G, c = _cc_graph_on(cuda)
    dag, stages, operands = tapps.cc_iteration_lowering(graph.n_rows, 256, 1024)
    techs, best, uniform = select_offline_device_dag(
        dag, {"propagate": (graph.row_nnz() + 1).astype(np.float64)}, tile=256,
        n_shards=n_shards)
    assert best <= min(uniform.values())
    tables = build_dag_tables(dag, 256, techs, n_shards=n_shards).tables
    _cc_tables_walk_bitwise(tables, stages, operands, G, c)


def test_rebalanced_cc_table_walks_bitwise(cuda):
    """A contiguous assignment re-balanced on the per-chunk nnz: a lower
    largest shard load, and the new table walks bitwise as the old."""
    graph, G, c = _cc_graph_on(cuda)
    dag, stages, operands = tapps.cc_iteration_lowering(graph.n_rows, 256, 1024)
    nnz = graph.row_nnz()
    old = build_dag_tables(dag, 256, tapps.CC_TECHNIQUES, n_shards=2, n_workers=4,
                           assignment="contiguous")

    def measured(d):
        return {n: np.array([nnz[s * 256:(s + z) * 256].sum()
                             for s, z in d.stage_chunks[n]], dtype=np.float64)
                for n in d.stage_names}

    def largest_load(d):
        load = np.zeros(d.n_shards)
        for n, per_chunk in measured(d).items():
            np.add.at(load, d.chunk_shard[n], per_chunk)
        return load.max()

    new = rebalance_dag(old, measured(old))
    assert largest_load(new) < largest_load(old)
    assert not np.array_equal(new.chunk_shard["propagate"], old.chunk_shard["propagate"])
    for ddt in (old, new):
        _cc_tables_walk_bitwise(ddt.tables, stages, operands, G, c)


def test_listing1_on_the_vee_equals_the_card_loop(cuda):
    """Listing 1 on the host pool and a loop of ``cc_iteration_device``
    on the card until no label flips: the same labels and iterations."""
    graph, G, c = _cc_graph_on(cuda)
    labels, iters, _ = tapps.connected_components(
        graph, SchedulerConfig(technique="MFSC", n_workers=4))
    cd, dev_iters = c, 0
    while dev_iters < 100:
        out = tapps.cc_iteration_device(G, cd)
        dev_iters += 1
        cd = out["propagate"]
        if int(out["changed"][0]) == 0:
            break
    assert dev_iters == iters
    assert np.array_equal(cd.cpu().numpy().astype(np.int64), labels)


def test_inner_steps_without_an_inner_loop_launch_nothing(cuda):
    low = tapps.linreg_device_lowering(512, 9, device=cuda)
    odd = [dataclasses.replace(low.stages[0], inner=2), low.stages[1]]
    before = sum(_build.DAG_WALK.launches.values())
    with pytest.raises(ValueError, match="'moments' has 2 inner steps"):
        twalk.dag_walk(odd, low.operands, low.values, _rows(low, "GSS")[0], low.tile)
    assert sum(_build.DAG_WALK.launches.values()) == before


# K4 against its plain version: the kernel groups the online softmax in
# 64-key tiles and sums in its own order, so fp32 outputs agree to 2e-5;
# bf16 outputs round to 8 bits (and p is rounded to bf16 before p . v), so
# they agree to 2e-2, the reference's kernel-test tolerances.
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


# every (dh, dv) the kernel is built for (kernels/flash_attention.py:WIDTHS)
FLASH_WIDTHS = [(16, 16), (64, 64), (96, 96), (112, 112), (128, 128), (192, 128)]
# widths off the compiled pairs, zero-padded to the pair covering them:
# DeepSeek-V2-Lite's reduced MLA (24, 16) onto (64, 64), an odd (80, 80)
# onto (96, 96)
PADDED_WIDTHS = [(24, 16), (80, 80)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh,dv", FLASH_WIDTHS + PADDED_WIDTHS)
@pytest.mark.parametrize("group", [1, 4, 7])
def test_flash_attention_matches_plain(cuda, dtype, causal, dh, dv, group):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    gen = torch.Generator(device=cuda)
    gen.manual_seed(dh * 10 + group)
    b, kv, s = 2, 2, 200  # 200 is no multiple of the 64- or 128-row tiles
    q = torch.randn((b, kv * group, s, dh), generator=gen, device=cuda).to(dtype)
    k = torch.randn((b, kv, s, dh), generator=gen, device=cuda).to(dtype)
    v = torch.randn((b, kv, s, dv), generator=gen, device=cuda).to(dtype)
    before = _build.FLASH_ATTENTION.launches["flash_attention"]
    got = flash_attention(q, k, v, causal=causal, tile_k=64)
    torch.cuda.synchronize()
    assert _build.FLASH_ATTENTION.launches["flash_attention"] == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, tile_k=64)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_attention_strided_views_and_offset(cuda):
    """``_split_heads``'s transposed views go in as they are, over more
    keys than queries, causal and not."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    x = torch.randn((2, 192, 8 * 64), generator=gen, device=cuda)
    q = x.reshape(2, 192, 8, 64).transpose(1, 2)[:, :, 64:]   # 128 queries
    k = x[:, :, :128].reshape(2, 192, 2, 64).transpose(1, 2)
    v = x[:, :, 128:256].reshape(2, 192, 2, 64).transpose(1, 2)
    for causal in (True, False):
        got = flash_attention(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, causal=causal, tile_k=64)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
        # widths off the compiled pairs: zero-padded copies of the views
        for qq, kk, vv in ((q[..., :32], k[..., :32], v[..., :32]), (q, k, v[..., :48])):
            got = flash_attention(qq, kk, vv, causal=causal)
            want = flash_attention_plain(qq, kk, vv, causal=causal, tile_k=64)
            torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    wide = torch.zeros((2, 8, 128, 200), device=cuda)
    with pytest.raises(ValueError, match="ROADMAP B0"):
        flash_attention(wide, wide[:, :2], wide[:, :2, :, :64])
    with pytest.raises(ValueError, match="one dtype"):
        flash_attention(q, k.bfloat16(), v)


def test_flash_attention_bf16_runs_on_tensor_cores(cuda):
    """The bf16 kernels' SASS issues Hopper warpgroup products (HGMMA), the
    forward's and the backward's (dK/dV and dQ, every width); the fp32
    kernels' issues none (fp32 FMA, no TF32); and no bf16 backward kernel
    spills (no stack frame, no local memory: ``cuobjdump -res-usage``)."""
    import re
    import shutil
    import subprocess
    from pathlib import Path

    _build.FLASH_ATTENTION._load()
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    assert tool, "cuobjdump not found beside nvcc"
    sass = subprocess.run([tool, "-sass", str(_build.FLASH_ATTENTION.library)],
                          capture_output=True, text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", sass)
    wgmma = [f for f in funcs if "flash_wgmma" in f.split("\n", 1)[0]]
    fp32 = [f for f in funcs if "flash_fwd" in f.split("\n", 1)[0]]
    assert len(wgmma) == len(FLASH_WIDTHS) and len(fp32) == len(FLASH_WIDTHS)
    assert all("HGMMA" in f for f in wgmma)
    assert not any("HGMMA" in f or "HMMA" in f for f in fp32)

    smoke = _smoke()
    _build.FLASH_ATTENTION_BWD._load()
    bwd = smoke.sass_functions(_build.FLASH_ATTENTION_BWD)
    bwd_wgmma = [f for f in bwd if "_wgmma" in f.split("\n", 1)[0]]
    bwd_fp32 = [f for f in bwd if re.search(r"bwd_(dkdv|dq)I", f.split("\n", 1)[0])]
    assert len(bwd_wgmma) == 2 * len(FLASH_WIDTHS) and len(bwd_fp32) == 2 * len(FLASH_WIDTHS)
    assert all("HGMMA" in f for f in bwd_wgmma)
    assert not any("HGMMA" in f or "HMMA" in f for f in bwd_fp32)
    kernels = smoke.k4_bwd_kernels()
    assert len(kernels) == 2 * len(FLASH_WIDTHS)
    assert all(hgmma and stack == 0 and local == 0
               for _, stack, local, hgmma in kernels.values()), kernels


def test_flash_attention_mla_widths_against_float64(cuda):
    """(dh 192, dv 128), DeepSeek-V2-Lite's MLA widths, bf16 and causal,
    against a float64 oracle within the smoke's per-entry limit:
    2^-8 (|o| + sum w|v|) + 2^-16 sum w|v|."""
    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    b, h, s = 1, 4, 384
    q, k = (torch.randn((b, h, s, 192), generator=gen, device=cuda).bfloat16()
            for _ in range(2))
    v = torch.randn((b, h, s, 128), generator=gen, device=cuda).bfloat16()
    got = flash_attention(q, k, v, causal=True)
    assert tuple(got.shape) == (b, h, s, 128)
    sc = (q.double() @ k.double().transpose(-1, -2)) / math.sqrt(192)
    mask = torch.arange(s, device=cuda)[:, None] >= torch.arange(s, device=cuda)[None, :]
    w = torch.softmax(sc.masked_fill(~mask, -1e30), dim=-1)
    o = w @ v.double()
    wv = w @ v.double().abs()
    lim = 2.0 ** -8 * (o.abs() + wv) + 2.0 ** -16 * wv
    assert bool(((got.double() - o).abs() <= lim).all())


@pytest.mark.parametrize("sq,skv,group,dh,causal", [
    (2048, 1500, 1, 64, False),   # Whisper's cross attention
    (1500, 1500, 1, 64, False),   # Whisper's encoder
    (2048, 2048, 6, 128, True),   # InternVL2's GQA group of 6
])
def test_flash_attention_at_the_frontend_families_shapes(cuda, sq, skv, group, dh, causal):
    """K4 in bf16 at the calls the smoke's Whisper and InternVL2 phases
    serve (one batch row, two kv heads): 1,500 keys end in a masked
    92-key tail, non-causal with more queries than keys trims no tile, and
    group 6; against its plain version (FLASH_TOL) and within the smoke's
    float64 limit (``k4_check``, non-causal where the call is)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    gen = torch.Generator(device=cuda)
    gen.manual_seed(sq + skv + group)
    q = torch.randn((1, 2 * group, sq, dh), generator=gen, device=cuda).bfloat16()
    k, v = (torch.randn((1, 2, skv, dh), generator=gen, device=cuda).bfloat16()
            for _ in range(2))
    tile_k = 750 if skv == 1500 else 1024
    before = _build.FLASH_ATTENTION.launches["flash_attention"]
    got = flash_attention(q, k, v, causal=causal, tile_k=tile_k)
    torch.cuda.synchronize()
    assert _build.FLASH_ATTENTION.launches["flash_attention"] == before + 1
    assert tuple(got.shape) == (1, 2 * group, sq, dh)
    want = flash_attention_plain(q, k, v, causal=causal, tile_k=tile_k)
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    checks = _smoke().k4_check(cuda, {"randn": (q, k, v)}, tile_k, causal)
    assert checks["randn"]["share_o"] <= 1 and checks["randn"]["share_p"] <= 1


def _linreg_and_rec(cuda, units):
    return (tapps.linreg_device_lowering(64 * units, 9, device=cuda),
            tapps.recommendation_device_lowering(64 * units, 64, device=cuda))


@pytest.mark.parametrize("units", [1, 1100])
def test_walker_groups_at_odd_slot_counts(cuda, units):
    """A stage of one slot, and one of 1,100 slots (groups of 3: the last
    holds 2), against the plain version; stagewise equals fused."""
    for low in _linreg_and_rec(cuda, units):
        rows = _rows(low, "GSS")[0]
        plan = twalk.fold_plan(low.stages, rows)
        assert set(plan.group_size.values()) == {1 if units == 1 else 3}
        got = twalk.dag_walk(low.stages, low.operands, low.values, rows, low.tile)
        want = twalk.dag_walk_plain(low.stages, low.operands, low.values, rows, low.tile)
        for k in got:
            if k == "scores":
                assert torch.equal(got[k], tapps.scores_plain(
                    low.values["R"], got["item_norms"], got["user_bias"]))
            else:
                _close_sum(got[k], want[k], k)
        sw = twalk.dag_walk_stagewise(low.stages, low.operands, low.values, rows,
                                      low.tile)
        for k in got:
            assert torch.equal(sw[k], got[k]), k


@pytest.mark.parametrize("num_cols", [126, 201])
def test_linreg_syrk_in_several_passes(cuda, num_cols):
    """Past d = 124 the syrk body's 4 x 4 blocks take several passes over
    a piece's tiles (d = 200: five); the walk still matches the plain one."""
    low = tapps.linreg_device_lowering(64 * 40, num_cols, device=cuda)
    rows = _rows(low, "GSS")[0]
    got = twalk.dag_walk(low.stages, low.operands, low.values, rows, low.tile)
    want = twalk.dag_walk_plain(low.stages, low.operands, low.values, rows, low.tile)
    for k in got:
        _close_sum(got[k], want[k], k)


def test_linreg_wider_than_the_program_launches_nothing(cuda):
    low = tapps.linreg_device_lowering(128, twalk.LINREG_MAX_D + 2, device=cuda)
    before = _launches()
    with pytest.raises(ValueError, match="at most 256"):
        twalk.dag_walk(low.stages, low.operands, low.values, _rows(low, "GSS")[0],
                       low.tile)
    assert _launches() == before


def test_batched_walk_with_a_group_across_a_barrier(cuda):
    """Member 1's ``item_norms`` has 301 slots before member 0's ``scores``
    barrier and 299 after it, so its group of ordinals 300-301 is folded in
    two pieces (the second continues the first's stored partial). The
    member stays bitwise equal to its lowering walked alone."""
    lows = [tapps.recommendation_device_lowering(64 * 600, 64, seed=s, device=cuda)
            for s in (1, 2)]
    merged = tapps.merge_device_lowerings(lows)
    sid = {s.name: k for k, s in enumerate(merged.stages)}

    def slots(name, tiles):
        return [(sid[name], 64 * t, 64) for t in tiles]

    table = np.array(
        slots("item_norms#0", range(600)) + slots("user_bias#0", range(600))
        + slots("item_norms#1", range(301)) + slots("scores#0", range(600))
        + slots("item_norms#1", range(301, 600)) + slots("user_bias#1", range(600))
        + slots("scores#1", range(600)), dtype=np.int32)
    plan = twalk.fold_plan(merged.stages, table)
    assert plan.pieces[:, 4].sum() == 1  # one continued piece
    got = twalk.dag_walk(merged.stages, merged.operands, merged.values, table, 64)
    lone = lows[1]
    lsid = {s.name: k for k, s in enumerate(lone.stages)}
    single = np.array([(lsid[n], 64 * t, 64) for n in ("item_norms", "user_bias",
                                                        "scores") for t in range(600)],
                      dtype=np.int32)
    alone = twalk.dag_walk(lone.stages, lone.operands, lone.values, single, 64)
    for k in alone:
        assert torch.equal(got[f"{k}#1"], alone[k]), k
    want = twalk.dag_walk_plain(merged.stages, merged.operands, merged.values, table, 64)
    for k in ("item_norms#0", "item_norms#1"):
        _close_sum(got[k], want[k], k)


# ---------------------------------------------------------------------------
# the recommendation program's rows: every warp of the grid, den once an item
# ---------------------------------------------------------------------------

# users: 37 tiles, a count no grid's warps divide; items: 16-byte vectors
# with a partial batch (260, 1028), scalars (130, 258, 2050), and R at an
# offset of one float ("misaligned": scalar loads at 260 items)
REC_SHAPES = [(37 * 64, 130), (37 * 64, 258), (37 * 64, 260), (37 * 64, 1028),
              (37 * 64, 2050), (37 * 64, 260, "misaligned")]
EPS32 = 2.0 ** -23


def _rec_lowering(cuda, users, items, seed=0, misaligned=False):
    low = tapps.recommendation_device_lowering(users, items, seed=seed, device=cuda)
    if misaligned:
        R = low.values["R"]
        buf = torch.empty(R.numel() + 1, dtype=R.dtype, device=cuda)
        low.values["R"] = buf[1:].view(R.shape)
        low.values["R"].copy_(R)
        assert low.values["R"].data_ptr() % 16
    return low


def _user_bias_checks(got, R, vectors):
    """The smoke's user_bias limit, eps32 sqrt(I) sum|R[r]| / I against the
    plain body, and the emulated order of additions, bitwise."""
    items = R.shape[1]
    lim = EPS32 * math.sqrt(items) * R.abs().sum(1).double() / items
    assert ((got.double() - R.mean(1).double()).abs() <= lim).all()
    assert torch.equal(got.cpu(), tref.user_bias_ref(R, vectors=vectors).cpu())


@pytest.mark.parametrize("shape", REC_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_recommendation_rows_at_odd_shapes(cuda, shape):
    """scores bitwise the plain body; user_bias in its emulated order and
    within the smoke's limit; the stagewise walk (den from a launch-start
    pass) bitwise the fused walk (den from item_norms' fold)."""
    users, items = shape[:2]
    low = _rec_lowering(cuda, users, items, misaligned=len(shape) > 2)
    rows = _rows(low, "GSS")[0]
    before = _build.DAG_WALK.launches["walk_recommendation"]
    got, stamps = twalk.dag_walk(low.stages, low.operands, low.values, rows,
                                 low.tile, stamp=True)
    assert _build.DAG_WALK.launches["walk_recommendation"] == before + 1
    assert np.array_equal(stamps, np.c_[rows, np.arange(len(rows))])
    R = low.values["R"]
    assert torch.equal(got["scores"], tapps.scores_plain(R, got["item_norms"],
                                                         got["user_bias"]))
    _user_bias_checks(got["user_bias"], R, items % 4 == 0 and len(shape) == 2)
    sw = twalk.dag_walk_stagewise(low.stages, low.operands, low.values, rows, low.tile)
    for k in got:
        assert torch.equal(sw[k], got[k]), k


def _plant_ties(R, rng, n_rows):
    """Rows 0 .. n_rows - 1 each get 2 or 3 columns of their own, 1.0 in
    that row and 0 elsewhere: the columns' norms are 1, so their scores tie
    at the row's maximum. Returns each planted row's first such column."""
    cols = rng.permutation(R.shape[1])[:3 * n_rows].reshape(n_rows, 3)
    R[:, cols.ravel()] = 0.0
    first = []
    for r, c in enumerate(cols):
        c = c[:2 + r % 2]
        R[r, c] = 1.0
        first.append(int(c.min()))
    return np.array(first)


@pytest.mark.parametrize("items", [260, 2048])
def test_scores_take_the_first_index_on_planted_ties(cuda, items):
    """Rows whose maximum two or three columns share (in one 16-byte
    vector, one lane's later vectors, other lanes): the lowest index wins,
    fused and stagewise."""
    low = _rec_lowering(cuda, 37 * 64, items)
    R = low.values["R"].cpu().numpy()
    n = min(200, items // 3)
    first = _plant_ties(R, np.random.default_rng(items), n)
    low.values["R"] = torch.from_numpy(R).to(cuda)
    rows = _rows(low, "GSS")[0]
    got = twalk.dag_walk(low.stages, low.operands, low.values, rows, low.tile)
    assert np.array_equal(got["scores"][:n].cpu().numpy(), first)
    assert torch.equal(got["scores"], tapps.scores_plain(
        low.values["R"], got["item_norms"], got["user_bias"]))
    sw = twalk.dag_walk_stagewise(low.stages, low.operands, low.values, rows, low.tile)
    assert torch.equal(sw["scores"], got["scores"])


def test_user_bias_within_the_smokes_limit(cuda):
    """A batched member's size, 8,192 x 2,048: every row within the
    smoke's limit and in the emulated order."""
    low = _rec_lowering(cuda, 8192, 2048, seed=3)
    got, _ = tapps.run_device_dag(low)
    _user_bias_checks(got["user_bias"], low.values["R"], True)


def test_recommendation_batch_of_eight_bitwise_its_singles(cuda):
    """Eight members (odd widths: 37 tiles, 260 items) in one launch: each
    member's rows land on other warps than in its single walk, and every
    output stays bitwise."""
    lows = [_rec_lowering(cuda, 37 * 64, 260, seed=s) for s in range(1, 9)]
    singles = [tapps.run_device_dag(low, "GSS")[0] for low in lows]
    merged = tapps.merge_device_lowerings(lows)
    before = _build.DAG_WALK.launches["walk_recommendation"]
    vals, _ = tapps.run_device_dag(merged, "GSS")
    assert _build.DAG_WALK.launches["walk_recommendation"] == before + 1
    for j, member in enumerate(tapps.split_device_values(vals, len(lows))):
        for k in singles[j]:
            assert torch.equal(member[k], singles[j][k]), (j, k)


@pytest.mark.parametrize("cut", [10, 2 * 37 + 5])
def test_seeded_remainder_bitwise_the_migrated_entry_point(cuda, cut):
    """K3: the remainder walk of a host checkpoint repeats the migrated
    entry point's bits on every row it walks, with item_norms seeded (cut
    10: den from its fold) or finished on the host (cut 79: den from the
    launch-start pass); its scores are the plain body's on those rows."""
    users, items = 37 * 64, 260
    low = _rec_lowering(cuda, users, items)
    plan = _seeded_remainder(low, cut)
    assert ("item_norms" in [s.name for s in plan.stages]) == (cut == 10)
    got = plan.walk()
    top, vals, _ = tapps.recommendation_migrated(users, items, cut,
                                                 direction="host_to_device", device=cuda)
    for s in plan.stages:
        if s.combine == "sum":
            assert torch.equal(got[s.name], vals[s.name]), s.name
            continue
        rows = torch.from_numpy(np.concatenate(
            [np.arange(t * 64, (t + 1) * 64) for t in sorted(plan.need[s.name])])).to(cuda)
        assert torch.equal(got[s.name][rows], vals[s.name][rows]), s.name
    rows = torch.from_numpy(np.concatenate(
        [np.arange(t * 64, (t + 1) * 64) for t in sorted(plan.need["scores"])])).to(cuda)
    want = tapps.scores_plain(low.values["R"], vals["item_norms"], vals["user_bias"])
    assert torch.equal(top[rows], want[rows])


def test_model_prefill_on_card_matches_cpu(cuda):
    """A reduced Granite prefill of 1,088 tokens (the chunked impl: K4 on
    the card, its plain version on the CPU). bf16 activations round at
    different places in cuBLAS and on the CPU, so logits and caches agree
    to 4% of their largest magnitude (about ten bf16 steps there)."""
    from repro_torch.models import Model

    cfg = get_config("granite-8b").reduced()
    model = Model(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init_params(gen, "cpu")

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_card(v) for v in tree]
        return tree.to(cuda)

    on_card = to_card(params)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 1088)))
    before = _build.FLASH_ATTENTION.launches["flash_attention"]
    lg, cg = model.prefill(on_card, {"tokens": toks.to(cuda)},
                           model.init_cache(2, 1092, device=cuda))
    assert _build.FLASH_ATTENTION.launches["flash_attention"] == before + cfg.n_layers
    lc, cc = model.prefill(params, {"tokens": toks}, model.init_cache(2, 1092))
    for got, want in ((lg, lc), (cg["k"], cc["k"]), (cg["v"], cc["v"])):
        scale = float(want.float().abs().max())
        torch.testing.assert_close(got.cpu().float(), want.float(), rtol=0,
                                   atol=0.04 * scale)


def _tensors(tree, path=()):
    """path -> tensor of a tree of dicts."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, path + (k,))
    else:
        yield "/".join(path), tree


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-26b"])
def test_frontend_family_prefill_on_card_matches_plain_k4(cuda, arch):
    """A reduced Whisper (its encoder at 1,500 frames, blocks 512 / 1,024 as
    the full config's) and a reduced InternVL2 (8 patch embeddings), each
    with a 1,088-token prompt, prefilled on the card through K4 (Whisper:
    2 encoder, 2 self and 2 cross-attention launches; InternVL2: 2) against
    the same prefill on the card with K4's plain version in its place. A
    30-frame encoder and a short prompt take "full" and never reach K4.
    The two attentions round in fp32 apart, which moves bf16 roundings
    downstream: logits and caches within 4% of their largest magnitude, as
    ``test_model_prefill_on_card_matches_cpu`` holds them."""
    from unittest import mock

    from repro_torch.configs.base import EncDecConfig
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models import Model
    from repro_torch.models import attention as attention_module
    from repro_torch.models.model import FRONTEND_DIM

    cfg = get_config(arch).reduced()
    if cfg.encdec is not None:
        cfg = dataclasses.replace(cfg, encdec=EncDecConfig(2, 1500), attn_chunk_q=512,
                                  attn_chunk_kv=1024)
    model = Model(cfg)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    params = model.init_params(gen, cuda)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 1088), generator=gen,
                                     device=cuda)}
    if cfg.encdec is not None:
        batch["frames"] = torch.randn((2, cfg.encdec.n_enc_positions, FRONTEND_DIM["audio"]),
                                      generator=gen, device=cuda)
        launches = cfg.encdec.n_enc_layers + 2 * cfg.n_layers
    else:
        batch["patch_embeds"] = torch.randn((2, cfg.n_frontend_tokens,
                                             FRONTEND_DIM["vision"]), generator=gen,
                                            device=cuda)
        launches = cfg.n_layers
    before = _build.FLASH_ATTENTION.launches["flash_attention"]
    lg, cg = model.prefill(params, batch, model.init_cache(2, 1092, device=cuda))
    torch.cuda.synchronize()
    assert _build.FLASH_ATTENTION.launches["flash_attention"] == before + launches
    with mock.patch.object(attention_module, "flash_attention", flash_attention_plain):
        lp, cp = model.prefill(params, batch, model.init_cache(2, 1092, device=cuda))
    pairs = [("logits", lg, lp)] + [(p, t, dict(_tensors(cp))[p]) for p, t in _tensors(cg)]
    for what, got, want in pairs:
        scale = float(want.float().abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=0.04 * scale,
                                   msg=what)


# ---------------------------------------------------------------------------
# K5 (ssm_scan) and K6 (rwkv6_scan)
# ---------------------------------------------------------------------------

# The kernels and their plain versions compute the same fp32 chunk
# recurrence from the same inputs (bf16 inputs convert exactly), summing in
# other orders, and the float64 oracles compute it step by step. Outputs
# and states agree to the reference's kernel-test tolerances, taken of the
# largest magnitude: 2e-3 for K6 (the fp32 cumsum's resolution under fast
# decay), 2e-4 for K5.
K6_TOL, K5_TOL = 2e-3, 2e-4


def _close_scaled(got, want, tol, what):
    scale = float(want.abs().max())
    err = float((got.double() - want.double()).abs().max())
    assert err <= tol * scale, (what, err, tol * scale)


def _rwkv6_inputs(cuda, b, h, s, dtype, decay_scale, seed):
    """r, k, v as transposed head views of a (B, S, H*64) projection, as
    the model hands them over; logw likewise, float32."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    proj = torch.randn((b, s, 3 * h * 64), generator=gen, device=cuda).to(dtype)
    r, k, v = (proj[..., i * h * 64:(i + 1) * h * 64].reshape(b, s, h, 64).transpose(1, 2)
               for i in range(3))
    logw = torch.clamp(-torch.exp(torch.randn((b, s, h * 64), generator=gen, device=cuda)
                                  * decay_scale), min=-30.0)
    logw = logw.reshape(b, s, h, 64).transpose(1, 2)
    u = torch.randn((h, 64), generator=gen, device=cuda) * 0.1
    return r, k, v, logw, u


def _ssm_inputs(cuda, b, s, h, dtype, seed):
    """x, B, C as strided views of one conv output (B, S, H*64 + 2*64), as
    the model hands them over; dt and A float32."""
    import torch.nn.functional as F

    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    conv = torch.randn((b, s, h * 64 + 128), generator=gen, device=cuda).to(dtype)
    x = conv[..., :h * 64].reshape(b, s, h, 64)
    B, C = conv[..., h * 64:h * 64 + 64], conv[..., h * 64 + 64:]
    dt = F.softplus(torch.randn((b, s, h), generator=gen, device=cuda))
    A = -torch.exp(torch.randn((h,), generator=gen, device=cuda) * 0.5)
    return x, dt, A, B, C


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("decay_scale", [0.5, 4.0])
def test_rwkv6_scan_matches_plain_and_float64(cuda, dtype, chunk, decay_scale):
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain, rwkv6_scan_state

    r, k, v, logw, u = _rwkv6_inputs(cuda, 2, 3, 192, dtype, decay_scale, chunk)
    before = _build.RWKV6_SCAN.launches["rwkv6_scan"]
    y, state = rwkv6_scan_state(r, k, v, logw, u, chunk)
    torch.cuda.synchronize()
    assert _build.RWKV6_SCAN.launches["rwkv6_scan"] == before + 1
    py, pstate = rwkv6_scan_plain(r, k, v, logw, u, chunk)
    oy, ostate = tref.rwkv6_scan_ref(r, k, v, logw, u, dtype=torch.float64,
                                     return_state=True)
    for got, plain, oracle, what in ((y, py, oy, "y"), (state, pstate, ostate, "state")):
        assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
        _close_scaled(got, plain, K6_TOL, f"{what} vs plain")
        _close_scaled(got, oracle, K6_TOL, f"{what} vs float64")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [32, 64])
def test_ssm_scan_matches_plain_and_float64(cuda, dtype, chunk):
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain, ssm_scan_state

    x, dt, A, B, C = _ssm_inputs(cuda, 2, 192, 3, dtype, chunk)
    before = _build.SSM_SCAN.launches["ssm_scan"]
    y, state = ssm_scan_state(x, dt, A, B, C, chunk)
    torch.cuda.synchronize()
    assert _build.SSM_SCAN.launches["ssm_scan"] == before + 1
    py, pstate = ssm_scan_plain(x, dt, A, B, C, chunk)
    zero = torch.zeros_like(A)
    oy, ostate = tref.ssm_scan_ref(x, dt, A, B, C, zero, dtype=torch.float64,
                                   return_state=True)
    for got, plain, oracle, what in ((y, py, oy, "y"), (state, pstate, ostate, "state")):
        assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
        _close_scaled(got, plain, K5_TOL, f"{what} vs plain")
        _close_scaled(got, oracle, K5_TOL, f"{what} vs float64")
    D = torch.rand((3,), device=cuda) + 0.5
    torch.testing.assert_close(ssm_scan(x, dt, A, B, C, D, chunk),
                               y + D[None, None, :, None] * x.float(), rtol=0, atol=0)


def _ssm_mamba2_inputs(cuda, b, s, h, dtype, seed, pad=0):
    """x, B, C as strided views of one conv output (B, S, H*64 + 128 +
    ``pad``): with an odd ``pad`` in bfloat16 their rows do not start on 16
    bytes. dt and A drawn as Mamba2 initialises them (dt = softplus around
    a bias with softplus(bias) log-uniform in [1e-3, 0.1], A in [-16, -1]),
    whose small chunk cumsums keep the smoke's limit tight."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    conv = torch.randn((b, s, h * 64 + 128 + pad), generator=gen, device=cuda).to(dtype)
    x = conv[..., :h * 64].reshape(b, s, h, 64)
    B, C = conv[..., h * 64:h * 64 + 64], conv[..., h * 64 + 64:h * 64 + 128]
    dt0 = torch.exp(torch.empty(h, device=cuda).uniform_(math.log(1e-3), math.log(0.1),
                                                         generator=gen))
    bias = dt0 + torch.log(-torch.expm1(-dt0))
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device=cuda) * 0.5 + bias)
    A = -torch.empty(h, device=cuda).uniform_(1.0, 16.0, generator=gen)
    return x, dt, A, B, C


def _ssm_within_the_smokes_limit(x, dt, A, B, C, chunk):
    """K5 on the card against the float64 oracle within the smoke's limit
    (eps32 sqrt(3 Q) (1 + c) sum|terms|) and against the plain version
    within twice it, for y and the final state; one launch counted."""
    from repro_torch.kernels.ssm_scan import ssm_scan_plain, ssm_scan_state

    smoke = _smoke()
    before = _build.SSM_SCAN.launches["ssm_scan"]
    got = ssm_scan_state(x, dt, A, B, C, chunk)
    torch.cuda.synchronize()
    assert _build.SSM_SCAN.launches["ssm_scan"] == before + 1
    plain = ssm_scan_plain(x, dt, A, B, C, chunk)
    oracle, limits, _ = smoke.ssm_limits(x, dt, A, B, C, chunk)
    for g, p, o, lim, what in zip(got, plain, oracle, limits, ("y", "state")):
        assert g.dtype == torch.float32 and g.shape == o.shape and bool(torch.isfinite(g).all())
        bad, err, share = smoke.beyond(g, o, lim)
        assert bad == 0, (what, "vs float64", bad, err, share)
        bad, err, share = smoke.beyond(g, p, 2 * lim)
        assert bad == 0, (what, "vs plain", bad, err, share)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [8, 16, 32, 64])
def test_ssm_scan_split_tf32_within_the_smokes_limit(cuda, dtype, chunk):
    """Split TF32 on the tensor cores at each chunk the kernel takes, y and
    the final state, in bfloat16 (x, B, C exact in TF32) and float32 (every
    operand split)."""
    _ssm_within_the_smokes_limit(*_ssm_mamba2_inputs(cuda, 2, 256, 3, dtype, chunk), chunk)


@pytest.mark.parametrize("bt,h", [(1, 3), (3, 113), (2, 8)])
def test_ssm_scan_grids_that_do_not_fill_evenly(cuda, bt, h):
    """(batch, head) counts off the kernels' grids: one head group short
    of 8 heads (113 = 14 x 8 + 1, and 3), a single batch, and chunk 48
    (rows past 48 of the 64-row tiles, and a partial 8-step tile)."""
    for chunk in (64, 48):
        _ssm_within_the_smokes_limit(*_ssm_mamba2_inputs(cuda, bt, 192, h, torch.bfloat16, h),
                                     chunk)


@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_reads_strided_views(cuda, pad, dtype):
    """x, B and C read in place as views of one conv output (rows 16-byte
    aligned, and, with ``pad`` 1 in bfloat16, not); x also as a head-major
    tensor transposed into (Bt, S, H, dh); the outputs bitwise one another
    where only the layout differs."""
    from repro_torch.kernels.ssm_scan import ssm_scan_state

    x, dt, A, B, C = _ssm_mamba2_inputs(cuda, 2, 256, 5, dtype, 11, pad=pad)
    assert not x.is_contiguous() and not B.is_contiguous()
    _ssm_within_the_smokes_limit(x, dt, A, B, C, 64)
    xt = x.transpose(1, 2).contiguous().transpose(1, 2)
    dtt = dt.transpose(1, 2).contiguous().transpose(1, 2)
    for got, want in zip(ssm_scan_state(xt, dtt, A, B.contiguous(), C.contiguous(), 64),
                         ssm_scan_state(x, dt, A, B, C, 64)):
        assert torch.equal(got, want)


def test_ssm_scan_runs_on_tensor_cores(cuda):
    """Both of K5's kernels, in both input types, issue tensor-core
    products (HMMA: mma.sync) by ``cuobjdump -sass``."""
    from repro_torch.kernels.ssm_scan import ssm_scan_state

    ssm_scan_state(*_ssm_mamba2_inputs(cuda, 1, 64, 2, torch.bfloat16, 0), 64)
    torch.cuda.synchronize()
    sass = _smoke().scan_sass_has("ssm_scan", ("HMMA",))
    assert len(sass) == 4 and all(sass.values()), sass


def _rwkv6_draw_inputs(cuda, b, h, s, dtype, draw, seed, pad=0):
    """r, k, v as transposed head views of one (B, S, 3 H 64 + ``pad``)
    projection (with an odd ``pad`` in bfloat16 their rows do not start on
    16 bytes); logw drawn as ``tests/test_torch_rwkv6_tf32.py`` draws it:
    ``model``, Finch's decay at the model's initial bias (-0.6) spread by
    0.5 randn, whose small chunk cumsums keep the smoke's limit tight, or
    ``fast``, the smoke's max(-exp(4 randn), -30)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    proj = torch.randn((b, s, 3 * h * 64 + pad), generator=gen, device=cuda).to(dtype)
    r, k, v = (proj[..., i * h * 64:(i + 1) * h * 64].reshape(b, s, h, 64).transpose(1, 2)
               for i in range(3))
    z = torch.randn((b, s, h * 64), generator=gen, device=cuda)
    logw = (-torch.exp(torch.clamp(-0.6 + 0.5 * z, max=3.4)) if draw == "model"
            else torch.clamp(-torch.exp(4.0 * z), min=-30.0))
    u = torch.randn((h, 64), generator=gen, device=cuda) * 0.1
    return r, k, v, logw.reshape(b, s, h, 64).transpose(1, 2), u


def _rwkv6_within_the_smokes_limit(inputs, chunk):
    """K6 on the card against the float64 oracle within the smoke's limit
    (``rwkv6_limits``: eps32 sqrt(3 Q) (1 + c) sum|terms|) and against its
    CPU emulation (``rwkv6_scan_split_ref``, at the chunk the kernel runs)
    within twice it, for y and the final state; one launch counted."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_state

    smoke = _smoke()
    q = _build.kernel_chunk(_build.seq_chunk(inputs[0].shape[2], chunk), 64)
    before = _build.RWKV6_SCAN.launches["rwkv6_scan"]
    got = rwkv6_scan_state(*inputs, chunk)
    torch.cuda.synchronize()
    assert _build.RWKV6_SCAN.launches["rwkv6_scan"] == before + 1
    emulated = tref.rwkv6_scan_split_ref(*(t.cpu() for t in inputs), q)
    oracle, limits, _ = smoke.rwkv6_limits(*inputs, q)
    for g, e, o, lim, what in zip(got, emulated, oracle, limits, ("y", "state")):
        assert g.dtype == torch.float32 and g.shape == o.shape and bool(torch.isfinite(g).all())
        bad, err, share = smoke.beyond(g, o, lim)
        assert bad == 0, (what, "vs float64", bad, err, share)
        bad, err, share = smoke.beyond(g, e.to(g.device), 2 * lim)
        assert bad == 0, (what, "vs the emulation", bad, err, share)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [8, 16, 24, 64, 128])
def test_rwkv6_scan_split_tf32_within_the_smokes_limit(cuda, dtype, chunk):
    """The sub-chunk gate and split TF32 at each chunk the kernel takes
    (8 and 24 padded to 16 and 32 steps, 128 run as 64), y and the final
    state, in bfloat16 (v exact in TF32) and float32 (every operand
    split), on strided head views."""
    _rwkv6_within_the_smokes_limit(
        _rwkv6_draw_inputs(cuda, 2, 3, 384, dtype, "model", chunk), chunk)


@pytest.mark.parametrize("b,h,draw", [(1, 1, "fast"), (3, 41, "model"), (2, 5, "fast")])
def test_rwkv6_scan_grids_and_fast_decay(cuda, b, h, draw):
    """(batch, head) counts off the states launch's pairs of CTAs and the
    output launch's grid, under both draws (fast decay: chunk cumsums to
    about 900, where a factor with its reference point at the chunk's end
    overflows)."""
    for chunk in (64, 24):
        _rwkv6_within_the_smokes_limit(
            _rwkv6_draw_inputs(cuda, b, h, 192, torch.bfloat16, draw, h), chunk)


@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_reads_strided_views(cuda, pad, dtype):
    """r, k, v and logw read in place as transposed head views (rows on 16
    bytes, and, with ``pad`` 1 in bfloat16, not); the outputs bitwise those
    of contiguous copies, where only the staging differs."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_state

    inputs = _rwkv6_draw_inputs(cuda, 2, 3, 256, dtype, "model", 11, pad=pad)
    assert not inputs[0].is_contiguous()
    got = _rwkv6_within_the_smokes_limit(inputs, 64)
    for g, want in zip(got, rwkv6_scan_state(*(t.contiguous() for t in inputs), 64)):
        assert torch.equal(g, want)


def test_rwkv6_scan_is_two_launches_counted_once(cuda):
    """One call: one count in ``RWKV6_SCAN.launches``, the smoke's limit
    held, and the profiler records two device launches, rwkv6_states and
    rwkv6_outputs."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_state

    smoke = _smoke()
    inputs = _rwkv6_draw_inputs(cuda, 2, 4, 256, torch.bfloat16, "model", 3)
    _rwkv6_within_the_smokes_limit(inputs, 64)
    before = _build.RWKV6_SCAN.launches["rwkv6_scan"]
    device = smoke.kernel_device_ms(lambda: rwkv6_scan_state(*inputs, 64),
                                    smoke.SCAN_KERNELS["rwkv6_scan"])
    assert device["device_launches_per_call"] == 2, device
    assert isinstance(device["device_ms"], float), device
    # kernel_device_ms calls it once to warm up, then five times
    assert _build.RWKV6_SCAN.launches["rwkv6_scan"] == before + 6


def test_rwkv6_scan_runs_on_tensor_cores(cuda):
    """Both of K6's kernels, in both input types, issue tensor-core
    products (HMMA: mma.sync) by ``cuobjdump -sass``."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_state

    rwkv6_scan_state(*_rwkv6_draw_inputs(cuda, 1, 2, 64, torch.bfloat16, "model", 0), 64)
    torch.cuda.synchronize()
    sass = _smoke().scan_sass_has("rwkv6_scan", ("HMMA",))
    assert len(sass) == 4 and all(sass.values()), sass


def test_scans_at_the_serving_shapes(cuda):
    """RWKV6-3B's (4, 40, 2,048, 64) and Zamba2-7B's (4, 2,048, 112, 64)
    prefill shapes, bf16 views, against the plain versions."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain, rwkv6_scan_state
    from repro_torch.kernels.ssm_scan import ssm_scan_plain, ssm_scan_state

    inputs = _rwkv6_inputs(cuda, 4, 40, 2048, torch.bfloat16, 0.5, 1)
    for got, want in zip(rwkv6_scan_state(*inputs, 64), rwkv6_scan_plain(*inputs, 64)):
        _close_scaled(got, want, K6_TOL, "K6")
    inputs = _ssm_inputs(cuda, 4, 2048, 112, torch.bfloat16, 2)
    for got, want in zip(ssm_scan_state(*inputs, 64), ssm_scan_plain(*inputs, 64)):
        _close_scaled(got, want, K5_TOL, "K5")


def test_scan_kernels_refuse_what_they_were_not_built_for(cuda):
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_state
    from repro_torch.kernels.ssm_scan import ssm_scan_state

    r, k, v, logw, u = _rwkv6_inputs(cuda, 1, 2, 128, torch.float32, 0.5, 3)
    x, dt, A, B, C = _ssm_inputs(cuda, 1, 128, 2, torch.float32, 4)
    k6, k5 = (_build.RWKV6_SCAN.launches["rwkv6_scan"],
              _build.SSM_SCAN.launches["ssm_scan"])
    with pytest.raises(ValueError, match="dh 64"):
        rwkv6_scan_state(r[..., :32], k[..., :32], v[..., :32], logw[..., :32],
                         u[:, :32], 64)
    with pytest.raises(ValueError, match="divide"):
        rwkv6_scan_state(r, k, v, logw, u, 96)
    with pytest.raises(ValueError, match="float32 logw"):
        rwkv6_scan_state(r, k, v, logw.bfloat16(), u, 64)
    with pytest.raises(ValueError, match="contiguous last axis"):
        rwkv6_scan_state(r.transpose(2, 3).contiguous().transpose(2, 3), k, v, logw, u, 64)
    with pytest.raises(ValueError, match="dh 64 and N 64"):
        ssm_scan_state(x[..., :16], dt, A, B, C, 64)
    with pytest.raises(ValueError, match="one dtype"):
        ssm_scan_state(x, dt, A, B.bfloat16(), C, 64)
    with pytest.raises(ValueError, match="divide"):
        ssm_scan_state(x, dt, A, B, C, 96)
    assert (_build.RWKV6_SCAN.launches["rwkv6_scan"],
            _build.SSM_SCAN.launches["ssm_scan"]) == (k6, k5)


def test_scan_kernels_run_a_chunk_above_64_as_sub_chunks(cuda):
    """The public ops' default chunks (``ssm_scan``'s 128, the Pallas
    wrapper's) and a chunk of 128 for K6 run in one launch each, as chunks
    of 64, against the plain versions at the chunk asked for."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain, rwkv6_scan_state
    from repro_torch.kernels.ssm_scan import ssm_scan_plain

    x, dt, A, B, C = _ssm_inputs(cuda, 2, 256, 3, torch.bfloat16, 5)
    D = torch.rand((3,), device=cuda) + 0.5
    before = _build.SSM_SCAN.launches["ssm_scan"]
    got = ops.mamba2_chunk_scan(x, dt, A, B, C, D)
    torch.cuda.synchronize()
    assert _build.SSM_SCAN.launches["ssm_scan"] == before + 1
    want = ssm_scan_plain(x, dt, A, B, C, 128)[0] + D[None, None, :, None] * x.float()
    _close_scaled(got, want, K5_TOL, "K5 at the default chunk")
    r, k, v, logw, u = _rwkv6_inputs(cuda, 1, 2, 256, torch.bfloat16, 4.0, 6)
    before = _build.RWKV6_SCAN.launches["rwkv6_scan"]
    got = rwkv6_scan_state(r, k, v, logw, u, 128)
    torch.cuda.synchronize()
    assert _build.RWKV6_SCAN.launches["rwkv6_scan"] == before + 1
    for g, w, what in zip(got, rwkv6_scan_plain(r, k, v, logw, u, 128), ("y", "state")):
        _close_scaled(g, w, K6_TOL, f"K6 {what} at chunk 128")


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b"])
def test_recurrent_model_on_card_matches_cpu(cuda, arch):
    """A small RWKV6 / Zamba2 (head and state widths 64, the kernels'; two
    Zamba2 super-blocks through the shared attention) with float32
    activations and caches: a 1,088-token prefill (K5 / K6, and K4 at the
    chunked impl) and two decode steps on the card, against the same
    model on the CPU (the plain versions), to 1e-3 of the largest
    magnitude (fp32 sum orders only)."""
    from repro_torch.models import Model
    from repro_torch.models.layers import embed
    from repro_torch.models.model import _leaves

    class Model32(Model):
        def _embed_inputs(self, params, batch_inputs):
            return embed(params["embed"], batch_inputs["tokens"]).float()

    cfg = get_config(arch).reduced()
    if cfg.rwkv is not None:
        cfg = dataclasses.replace(cfg, d_model=128, n_heads=2, n_kv_heads=2,
                                  rwkv=dataclasses.replace(cfg.rwkv, head_dim=64, chunk=64))
    else:
        cfg = dataclasses.replace(cfg, n_layers=5, ssm=dataclasses.replace(
            cfg.ssm, head_dim=64, d_state=64, chunk=64, attn_every=2))
    model = Model32(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init_params(gen, "cpu")

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_card(v) for v in tree]
        return tree.to(cuda)

    on_card = to_card(params)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 1088)))
    before = sum(sum(k.launches.values()) for k in _build.KERNELS)
    lg, cg = model.prefill(on_card, {"tokens": toks.to(cuda)},
                           model.init_cache(2, 1091, torch.float32, device=cuda))
    lc, cc = model.prefill(params, {"tokens": toks}, model.init_cache(2, 1091, torch.float32))
    launched = sum(sum(k.launches.values()) for k in _build.KERNELS) - before
    # one scan a layer; Zamba2 adds one K4 call for each of its 2 super-blocks
    assert launched == (cfg.n_layers if cfg.rwkv is not None else 5 + 2)
    _close_scaled(lg.cpu(), lc, 1e-3, "prefill logits")
    for step in range(2):
        tok = lc[:, -1].argmax(-1)[:, None]
        lg, cg = model.decode_step(on_card, tok.to(cuda), cg, 1088 + step)
        lc, cc = model.decode_step(params, tok, cc, 1088 + step)
        _close_scaled(lg.cpu(), lc, 1e-3, f"decode {step} logits")

    for got, want in zip(_leaves(cg), _leaves(cc)):
        if want.numel():
            _close_scaled(got.cpu(), want, 1e-3, "cache")


# ------------------------------------------- telemetry and co-execution

def test_device_walk_spans_from_the_card_equal_the_plain_walks(cuda):
    """The CUDA walk's stamp buffer folds into the same device spans as the
    plain walk's, on a GSS table with padding slots."""
    from repro_torch.core import Tracer, device_walk_spans, validate_chrome_trace

    low = tapps.linreg_device_lowering(4096, 33, tile=64, device=cuda)
    rows = build_dag_tables(low.dag, 1, "GSS", n_shards=1, n_workers=4,
                            max_slots=200).tables[0].copy()
    rows[:, 1:] *= low.tile
    _, got = twalk.dag_walk(low.stages, low.operands, low.values, rows, low.tile,
                            stamp=True)
    _, want = twalk.dag_walk_plain(low.stages, low.operands, low.values, rows,
                                   low.tile, stamp=True)
    assert np.array_equal(got, want)
    names = [s.name for s in low.stages]
    costs = {n: np.full(4096, 1e-6 * (k + 1)) for k, n in enumerate(names)}
    traces = []
    for stamps in (got, want):
        tr = Tracer(job="walk")
        n = device_walk_spans(stamps, names, tr, row_costs=costs)
        assert n == int((rows[:, 2] > 0).sum())
        traces.append(tr.to_chrome_trace())
    assert traces[0] == traces[1]
    assert validate_chrome_trace(traces[0]) == []


def _close_linreg(got, want, what):
    """Walked and host float32 sums agree within 1e-5 of the stage's largest
    |entry| (the bar ``test_torch_apps.py`` holds the walker's sums to)."""
    got, want = got.double().cpu(), want.double().cpu()
    lim = 1e-5 * float(want.abs().max())
    assert float((got - want).abs().max()) <= lim, what


def _beta_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-2 * float(np.abs(want[:-1]).max()))


def test_linear_regression_hetero_on_a_cuda_lowering_is_its_host_run(cuda):
    """Co-executed on the card: the walker lane's sums differ from the
    host-only run's by rounding only, and every launch walks a run."""
    from repro_torch.core import PipelineExecutor

    before = _build.DAG_WALK.launches["walk_linreg"]
    beta, res, placement = tapps.linear_regression_hetero(
        4096, 33, SchedulerConfig(n_workers=4), n_device=1, device=cuda)
    launches = _build.DAG_WALK.launches["walk_linreg"] - before
    lane_chunks = res.per_worker_tasks[-1]
    assert (launches > 0) == (lane_chunks > 0) and launches <= lane_chunks
    low = tapps.linreg_device_lowering(4096, 33, tile=64, device=cuda)
    host = PipelineExecutor(low.dag, SchedulerConfig(
        technique="SS", queue_layout="CENTRALIZED", n_workers=1)).run()
    for k in host.values:
        _close_linreg(res.values[k], host.values[k], k)
    _beta_close(beta, low.finalize(host.values))
    walked, _ = tapps.run_device_dag(low)
    _beta_close(beta, low.finalize(walked))


def test_walker_lanes_launch_k1_for_their_runs(cuda):
    """With no host worker absorbing, the lane walks every device row of the
    cuda lowering through K1, a run a launch."""
    from repro_torch.core import HeteroExecutor, PipelineExecutor, Placement

    low = tapps.linreg_device_lowering(8192, 33, tile=64, device=cuda)
    before = _build.DAG_WALK.launches["walk_linreg"]
    het = HeteroExecutor(low.dag, SchedulerConfig(technique="SS", n_workers=2),
                         Placement.all_device(low.dag.stage_names), n_device=1,
                         rebalance=False, lowering=low).run()
    launches = _build.DAG_WALK.launches["walk_linreg"] - before
    assert het.per_worker_tasks == [0, 0, 256]
    # each stage's 128 tiles in runs of half what is left: 64, 32, ..., 1, 1
    assert launches == 2 * 8
    host = PipelineExecutor(low.dag, SchedulerConfig(
        technique="SS", queue_layout="CENTRALIZED", n_workers=1)).run()
    for k in host.values:
        _close_linreg(het.values[k], host.values[k], k)


def test_server_all_device_job_is_its_solo_hetero_run(cuda):
    """A placed job that carries its cuda lowering is walked on the card by
    the server's lane as by a solo ``HeteroExecutor``: the two differ by
    the walker's rounding only (run boundaries follow thread timing)."""
    from repro_torch.core import (HeteroExecutor, Placement, PipelineServer,
                                  Submission)

    low = tapps.linreg_device_lowering(4096, 33, tile=64, device=cuda)
    names = low.dag.stage_names
    pl = Placement.all_device(names)
    ss = {n: ("SS", "CENTRALIZED", "SEQ") for n in names}
    other = tapps.recommendation_device_lowering(1024, 64, tile=64, device=cuda)
    before = _build.DAG_WALK.launches["walk_linreg"]
    res = PipelineServer(SchedulerConfig(technique="GSS", queue_layout="PERCORE",
                                         n_workers=4), n_device=1).serve(
        [Submission(dag=low.dag, name="placed", placement=pl, per_stage=ss,
                    lowering=low),
         Submission(dag=other.dag, name="other", tenant="b")])
    lane = sum(1 for e in res.events if e.worker >= 4 and e.job == "placed")
    launches = _build.DAG_WALK.launches["walk_linreg"] - before
    assert (launches > 0) == (lane > 0) and launches <= lane
    solo = HeteroExecutor(low.dag, SchedulerConfig(technique="SS", n_workers=4),
                          pl, n_device=1, lowering=low).run()
    for k in names:
        _close_linreg(res.jobs["placed"].values[k], solo.values[k], k)
    _beta_close(low.finalize(res.jobs["placed"].values), low.finalize(solo.values))

def test_front_door_placed_job_walks_k1(cuda):
    """A placed submission with its cuda lowering goes through the front
    door unbatched; the server's lane walks its rows on K1, beta within the
    smoke's 1e-2 of the walk's, while the same-shape host members beside
    it coalesce and stay bitwise their one-worker SS runs."""
    from repro_torch.core import (AdmissionController, BatchPolicy, FrontDoor,
                                  PipelineExecutor, Placement, Submission, Tracer)

    low = tapps.linreg_device_lowering(8192, 33, tile=64, device=cuda)
    names = low.dag.stage_names
    placed = Submission(dag=low.dag, name="placed", tenant="ml",
                        placement=Placement.all_device(names),
                        per_stage={n: ("SS", "CENTRALIZED", "SEQ") for n in names},
                        lowering=low)
    members = [Submission(dag=tapps.recommendation_dag(512, 32, seed=s), name=f"rec{s}",
                          tenant="interactive", arrival_s=1e-4 * s) for s in (1, 2, 3)]
    tracer = Tracer()
    before = _build.DAG_WALK.launches["walk_linreg"]
    res = FrontDoor(SchedulerConfig(technique="SS", n_workers=4),
                    admission=AdmissionController(), batching=BatchPolicy(5e-3, 8),
                    tracer=tracer).serve(members + [placed])
    launches = _build.DAG_WALK.launches["walk_linreg"] - before
    srv = res.server_result
    assert sorted(srv.jobs) == ["batch1(rec1x3)", "placed"] and res.n_batches == 1
    lane = {(e.job, e.stage, e.task_id) for e in srv.events
            if e.worker >= 4 and e.job == "placed"}
    assert lane and 1 <= launches <= len(lane)
    assert {(s.job, s.stage, s.chunk) for s in tracer.spans()
            if s.kind == "exec" and s.device} == lane
    walked, _ = tapps.run_device_dag(low)
    _beta_close(low.finalize(res.jobs["placed"].values), low.finalize(walked))
    for m in members:
        solo = PipelineExecutor(m.dag, SchedulerConfig(technique="SS", n_workers=1)).run()
        for k, want in solo.values.items():
            assert np.array_equal(np.asarray(res.jobs[m.name].values[k]),
                                  np.asarray(want)), (m.name, k)


def test_serving_pair_on_the_card_is_its_direct_composition(cuda):
    """Both models' steps run their per-row functions on the card, on the
    shared pool's threads and lanes: the logits are bitwise the direct
    composition of the same functions on the same rows."""
    results, subs, placements, lows = tml.serving_pair(device=cuda)
    for arch, low in zip(results, lows):
        assert low.meta["device"].type == "cuda"
        assert np.isfinite(results[arch]).all()
        assert np.array_equal(results[arch], low.run_direct()), arch


# ---------------------------------------------------------------- MoE and MLA

def test_route_on_the_card_is_the_cpus_on_ties(cuda):
    """The router's top k on the card, on bf16 inputs whose logits are
    exact in any summation order (quarter-integer router, integer tokens)
    and tie often: the expert indices are bitwise the CPU's, the lower
    index first among equal probabilities on both."""
    from repro_torch.models import moe as tmoe

    moe = get_config("qwen2-moe-a2.7b").reduced().moe
    rng = np.random.default_rng(1)
    router = torch.from_numpy(rng.integers(-1, 2, (64, moe.n_routed)).astype(np.float32) * 0.25)
    x = torch.from_numpy(rng.integers(-2, 3, (2 * 1088, 64)).astype(np.float32)).bfloat16()
    idx, w, probs = tmoe._route(router, x, moe)
    idx_g, w_g, probs_g = tmoe._route(router.to(cuda), x.to(cuda), moe)
    assert torch.equal(idx_g.cpu(), idx)
    torch.testing.assert_close(w_g.cpu(), w, rtol=0, atol=1e-6)
    tied = (probs[:, :, None] == probs[:, None, :]).sum((1, 2)) > moe.n_routed
    assert int(tied.sum()) > 0


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b"])
def test_moe_model_prefill_on_card_through_k4(cuda, arch):
    """A reduced Qwen1.5-MoE / DeepSeek-V2-Lite prefill of 1,088 tokens on
    the card (the chunked impl: one K4 launch a layer; DeepSeek's MLA at
    its full head widths, q and k 192, v 128, the widths K4 is compiled
    for), against the same prefill on the card through K4's plain version:
    last-position logits within the smoke's LOGIT_TOL, 10% of the largest
    (the two attentions round differently in fp32, which can flip a bf16
    rounding and, on a near tie, an expert downstream)."""
    from unittest import mock

    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models import Model
    from repro_torch.models import attention as tattention

    cfg = get_config(arch).reduced()
    if cfg.mla is not None:
        cfg = dataclasses.replace(cfg, mla=dataclasses.replace(
            cfg.mla, nope_head_dim=128, rope_head_dim=64, v_head_dim=128))
    model = Model(cfg)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    params = model.init_params(gen)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 1088))).to(cuda)
    before = _build.FLASH_ATTENTION.launches["flash_attention"]
    lg, cache = model.prefill(params, {"tokens": toks}, model.init_cache(2, 1092, device=cuda))
    torch.cuda.synchronize()
    assert _build.FLASH_ATTENTION.launches["flash_attention"] == before + cfg.n_layers
    with mock.patch.object(tattention, "flash_attention", flash_attention_plain):
        lp, _ = model.prefill(params, {"tokens": toks}, model.init_cache(2, 1092, device=cuda))
    assert _build.FLASH_ATTENTION.launches["flash_attention"] == before + cfg.n_layers
    assert bool(torch.isfinite(lg).all())
    scale = float(lp.float().abs().max())
    assert float((lg.float() - lp.float()).abs().max()) <= 0.10 * scale


# ------------------------------------------------------ K4's gradient (A12.1)

def _k4_grad_inputs(cuda, dtype, dh, dv, s, seed, b=1, kv=2, group=7):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    q = torch.randn((b, kv * group, s, dh), generator=gen, device=cuda).to(dtype)
    k = torch.randn((b, kv, s, dh), generator=gen, device=cuda).to(dtype)
    v = torch.randn((b, kv, s, dv), generator=gen, device=cuda).to(dtype)
    dout = torch.randn((b, kv * group, s, dv), generator=gen, device=cuda).to(dtype)
    return q, k, v, dout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh,dv", FLASH_WIDTHS + PADDED_WIDTHS)
@pytest.mark.parametrize("group", [1, 7])
def test_flash_attention_bwd_against_float64_and_plain(cuda, dtype, causal, dh, dv, group):
    """K4's backward kernels (bf16 on wgmma, fp32 on FMA), GQA group 7 and
    1 over 1,100 keys (the last 32-, 64- and 128-key tiles partial), at
    every compiled pair and at two widths off them (padded), on the
    forward kernel's own output and LSE: within ``chip_smoke.
    k4_grad_oracle``'s per-entry limit of a float64 gradient of the same
    inputs (in bf16 with the term for P and dS rounded as operands); within
    its limit against the plain backward on the same output and LSE; the
    same bits on a second call; and the control, the kernel without the D
    term (a zero output), beyond the float64 limit somewhere."""
    from repro_torch.kernels.flash_attention import (_forward, flash_attention_bwd,
                                                     flash_attention_bwd_plain)

    smoke = _smoke()
    q, k, v, dout = _k4_grad_inputs(cuda, dtype, dh, dv, 1100, dh + dv + int(causal),
                                    group=group)
    out, lse = _forward(q, k, v, causal, with_lse=True)
    before = _build.FLASH_ATTENTION_BWD.launches["flash_attention_bwd"]
    got = flash_attention_bwd(q, k, v, out, dout, lse, causal)
    again = flash_attention_bwd(q, k, v, out, dout, lse, causal)
    torch.cuda.synchronize()
    assert _build.FLASH_ATTENTION_BWD.launches["flash_attention_bwd"] == before + 2
    plain = flash_attention_bwd_plain(q, k, v, out, dout, lse, causal, tile_k=128)
    oracle = smoke.k4_grad_oracle(q, k, v, dout, causal)
    for name, g, a, p in zip(("dq", "dk", "dv"), got, again, plain):
        exact, lim, lim_plain = oracle[name]
        assert g.dtype == dtype and g.shape == exact.shape and g.is_contiguous(), name
        assert torch.equal(g, a), f"{name} differs between two calls"
        assert smoke.beyond(g, exact, lim)[0] == 0, f"{name} vs float64"
        assert smoke.beyond(g, p, lim_plain)[0] == 0, f"{name} vs plain"
    no_d = flash_attention_bwd(q, k, v, torch.zeros_like(out), dout, lse, causal)
    assert sum(smoke.beyond(g, oracle[n][0], oracle[n][1])[0]
               for n, g in zip(("dq", "dk"), no_d)) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh,dv", PADDED_WIDTHS)
def test_flash_attention_padded_route_launches_the_kernels(cuda, dtype, causal, dh, dv):
    """Off the compiled pairs (ROADMAP B0) K4 and K4' launch their kernels
    once a call each, on q, k and v zero-padded to the pair covering them
    (``compiled_widths``), the copies counted in ``PAD_COPIES``, never a
    plain fallback; the output, sliced back to dv and contiguous, within
    ``chip_smoke.k4_check``'s float64 limit at the true width's scale
    (the gradients: ``test_flash_attention_bwd_against_float64_and_plain``)."""
    from repro_torch.kernels import flash_attention as tfa

    smoke = _smoke()
    q, k, v, dout = _k4_grad_inputs(cuda, dtype, dh, dv, 1100, dh + dv + int(causal))
    f0 = _build.FLASH_ATTENTION.launches["flash_attention"]
    b0 = _build.FLASH_ATTENTION_BWD.launches["flash_attention_bwd"]
    pads = tfa.PAD_COPIES["q"]
    out, lse = tfa._forward(q, k, v, causal, with_lse=True)
    grads = tfa.flash_attention_bwd(q, k, v, out, dout, lse, causal)
    torch.cuda.synchronize()
    assert _build.FLASH_ATTENTION.launches["flash_attention"] == f0 + 1
    assert _build.FLASH_ATTENTION_BWD.launches["flash_attention_bwd"] == b0 + 1
    assert tfa.PAD_COPIES["q"] == pads + 2
    assert out.shape == (*q.shape[:3], dv) and out.is_contiguous()
    assert all(g.is_contiguous() for g in grads)
    mask = (torch.arange(1100, device=cuda)[:, None]
            >= torch.arange(1100, device=cuda)[None, :]) if causal else None
    g = q.shape[1] // k.shape[1]
    k64 = k[0].double().repeat_interleave(g, dim=0)
    v64 = v[0].double().repeat_interleave(g, dim=0)
    s = (q[0].double() @ k64.transpose(1, 2)) / math.sqrt(dh)
    w = torch.softmax(s if mask is None else s.masked_fill(~mask, -1e30), dim=-1)
    o, wv = w @ v64, w @ v64.abs()
    u = smoke.K4_ULP if dtype == torch.bfloat16 else 2.0 ** -24
    assert smoke.beyond(out[0], o, u * (o.abs() + wv) + smoke.K4_FP32 * wv)[0] == 0


@pytest.mark.parametrize("sq,skv", [(1500, 1500), (2048, 1500)])
def test_flash_attention_bwd_encoder_and_cross_shapes(cuda, sq, skv):
    """K4' non-causal at Whisper-small's training shapes, bf16, 12 heads of
    64: the encoder's 1,500 frames against themselves and the cross
    attention's 2,048 queries against 1,500 keys; within
    ``k4_grad_oracle``'s float64 limit and its limit against the plain
    backward, the same bits twice, and the no-D control beyond the float64
    limit somewhere."""
    from repro_torch.kernels.flash_attention import (_forward, flash_attention_bwd,
                                                     flash_attention_bwd_plain)

    smoke = _smoke()
    gen = torch.Generator(device=cuda)
    gen.manual_seed(sq + skv)
    q, k, v, dout = (torch.randn(shape, generator=gen, device=cuda).bfloat16()
                     for shape in ((1, 12, sq, 64), (1, 12, skv, 64), (1, 12, skv, 64),
                                   (1, 12, sq, 64)))
    out, lse = _forward(q, k, v, False, with_lse=True)
    got = flash_attention_bwd(q, k, v, out, dout, lse, False)
    again = flash_attention_bwd(q, k, v, out, dout, lse, False)
    plain = flash_attention_bwd_plain(q, k, v, out, dout, lse, False, tile_k=750)
    oracle = smoke.k4_grad_oracle(q, k, v, dout, False)
    for name, g, a, p in zip(("dq", "dk", "dv"), got, again, plain):
        exact, lim, lim_plain = oracle[name]
        assert g.shape == exact.shape, name
        assert torch.equal(g, a), f"{name} differs between two calls"
        assert smoke.beyond(g, exact, lim)[0] == 0, f"{name} vs float64"
        assert smoke.beyond(g, p, lim_plain)[0] == 0, f"{name} vs plain"
    no_d = flash_attention_bwd(q, k, v, torch.zeros_like(out), dout, lse, False)
    assert sum(smoke.beyond(g, oracle[n][0], oracle[n][1])[0]
               for n, g in zip(("dq", "dk"), no_d)) > 0


def test_flash_attention_forward_bits_without_and_with_lse(cuda):
    """The serving forward's bits do not move when the call needs a
    gradient (LSE written, one forward launch either way), and the LSE is
    the plain version's within 1e-4 (it sums p from ex2.approx)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_lse_plain)

    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, _ = _k4_grad_inputs(cuda, dtype, 64, 64, 1100, 3)
        before = _build.FLASH_ATTENTION.launches["flash_attention"]
        serve = flash_attention(q, k, v, causal=True)
        qg = q.clone().requires_grad_(True)
        train = flash_attention(qg, k, v, causal=True)
        torch.cuda.synchronize()
        assert _build.FLASH_ATTENTION.launches["flash_attention"] == before + 2
        assert serve.grad_fn is None and train.grad_fn is not None
        assert torch.equal(serve, train.detach())
        _, lse_plain = flash_attention_lse_plain(q, k, v, True, 128)
        lse = train.grad_fn.saved_tensors[4]
        torch.testing.assert_close(lse, lse_plain, atol=1e-4, rtol=0)


def test_flash_attention_autograd_launches_the_backward_kernel(cuda):
    """``flash_attention`` under autograd on the card: one forward and one
    backward launch, gradients within the float64 limit; the same call
    through the plain pair launches nothing; a ``dout`` the kernel cannot
    read in place is copied once, counted in ``DOUT_COPIES``, with the
    same gradients."""
    from repro_torch.kernels import flash_attention as tfa

    smoke = _smoke()
    q, k, v, dout = _k4_grad_inputs(cuda, torch.bfloat16, 64, 64, 300, 4, b=2)
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    f0 = _build.FLASH_ATTENTION.launches["flash_attention"]
    b0 = _build.FLASH_ATTENTION_BWD.launches["flash_attention_bwd"]
    out = tfa.flash_attention(*qkv, causal=True)
    grads = torch.autograd.grad(out, qkv, dout, retain_graph=True)
    torch.cuda.synchronize()
    assert _build.FLASH_ATTENTION.launches["flash_attention"] == f0 + 1
    assert _build.FLASH_ATTENTION_BWD.launches["flash_attention_bwd"] == b0 + 1
    oracle = smoke.k4_grad_oracle(q, k, v, dout, True)
    for n, g in zip(("dq", "dk", "dv"), grads):
        assert smoke.beyond(g, oracle[n][0], oracle[n][1])[0] == 0, n
    pair = tfa.flash_attention_plain_pair(*qkv, causal=True, tile_k=128)
    torch.autograd.grad(pair, qkv, dout)
    assert _build.FLASH_ATTENTION.launches["flash_attention"] == f0 + 1
    assert _build.FLASH_ATTENTION_BWD.launches["flash_attention_bwd"] == b0 + 1
    # odd strides of a wider buffer: the kernel cannot read them in place
    wide = torch.zeros((2, 14, 300, 65), device=cuda, dtype=torch.bfloat16)
    wide[..., :64] = dout
    c0 = tfa.DOUT_COPIES["dout"]
    saved = out.grad_fn.saved_tensors
    got = tfa.flash_attention_bwd(*saved[:4], wide[..., :64], saved[4], True)
    assert tfa.DOUT_COPIES["dout"] == c0 + 1
    for g, h in zip(got, grads):
        assert torch.equal(g, h)


def _scan_cases(cuda):
    """One float32 K5 and K6 call's inputs over 64 steps, 64 wide heads and
    state: (wrapper, inputs, forward kernel, forward entry, backward
    kernel, backward entry)."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_state
    from repro_torch.kernels.ssm_scan import ssm_scan_state

    return [(ssm_scan_state, _ssm_mamba2_inputs(cuda, 1, 64, 2, torch.float32, 6),
             _build.SSM_SCAN, "ssm_scan", _build.SSM_SCAN_BWD, "ssm_scan_bwd"),
            (rwkv6_scan_state, _rwkv6_draw_inputs(cuda, 1, 2, 64, torch.float32, "model", 6),
             _build.RWKV6_SCAN, "rwkv6_scan", _build.RWKV6_SCAN_BWD, "rwkv6_scan_bwd")]


def test_scans_launch_forward_and_backward_once_under_autograd(cuda):
    """On the card a K5 or K6 call that needs a gradient (any one input
    requiring it) launches the forward kernel once, and its backward the
    backward kernel once, with finite gradients; without a gradient the
    forward alone runs, its outputs bitwise those of a call under
    autograd."""
    for fn, args, fwd, fwd_entry, bwd, bwd_entry in _scan_cases(cuda):
        with torch.no_grad():
            want = fn(*args, chunk=32)
        for i in range(len(args)):
            needs = [t.detach().clone().requires_grad_(j == i) for j, t in enumerate(args)]
            f0, b0 = fwd.launches[fwd_entry], bwd.launches[bwd_entry]
            y, state = fn(*needs, chunk=32)
            assert fwd.launches[fwd_entry] == f0 + 1 and bwd.launches[bwd_entry] == b0
            assert torch.equal(y, want[0]) and torch.equal(state, want[1])
            (g,) = torch.autograd.grad((y.square().sum() + state.sum()), needs[i])
            torch.cuda.synchronize()
            assert fwd.launches[fwd_entry] == f0 + 1 and bwd.launches[bwd_entry] == b0 + 1
            assert g.dtype == args[i].dtype and bool(torch.isfinite(g).all()), (fwd_entry, i)
        f0, b0 = fwd.launches[fwd_entry], bwd.launches[bwd_entry]
        with torch.no_grad():
            again = fn(*needs, chunk=32)
        torch.cuda.synchronize()
        assert fwd.launches[fwd_entry] == f0 + 1 and bwd.launches[bwd_entry] == b0
        assert all(torch.equal(a, w) for a, w in zip(again, want))


def _scan_bwd_checked(kind, args, chunk, q, cuda):
    """K5' or K6' on ``args`` (through the Function, one forward and one
    backward launch) against the float64 gradient within the smoke's limit
    (``scan_bwd_limits``), against the plain backward within twice it, the
    same bits on a second call, and the control, the backward kernel with
    the state carried between chunks dropped (the forward's entering
    states zeroed), beyond the limit. y's and the final state's gradients
    both randn."""
    from repro_torch.kernels import rwkv6_scan as trw
    from repro_torch.kernels import ssm_scan as tss

    smoke = _smoke()
    names = ("x", "dt", "A", "B", "C") if kind == "ssm" else ("r", "k", "v", "logw", "u")
    fn, bwd_plain, bwd, entry = ((tss.ssm_scan_state, tss.ssm_scan_bwd_plain, _build.SSM_SCAN_BWD,
                                  "ssm_scan_bwd") if kind == "ssm" else
                                 (trw.rwkv6_scan_state, trw.rwkv6_scan_bwd_plain,
                                  _build.RWKV6_SCAN_BWD, "rwkv6_scan_bwd"))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(chunk)

    cot = []

    def grads(inputs):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        y, state = fn(*leaves, chunk=chunk)
        if not cot:
            cot.extend((torch.randn(y.shape, generator=gen, device=cuda),
                        torch.randn(state.shape, generator=gen, device=cuda)))
        return torch.autograd.grad((y, state), leaves, cot)

    b0 = bwd.launches[entry]
    got = grads(args)
    again = grads(args)
    torch.cuda.synchronize()
    assert bwd.launches[entry] == b0 + 2
    dy, dstate = cot
    plain = bwd_plain(*args, dy, dstate, chunk)
    limits = smoke.scan_bwd_limits(kind, dict(zip(names, args)), dy, dstate, q)
    control = smoke.scan_bwd_dropped_carry(kind, args, chunk, dy, dstate)
    beyond_control = 0
    for name, g, a, p in zip(limits, got, again, plain):
        exact, lim, lim_p = limits[name]
        assert torch.equal(g, a), f"{name}: two calls differ"
        bad, err, _ = smoke.beyond(g, exact, lim)
        assert bad == 0, f"{name} vs float64: {bad} entries beyond, max abs err {err:.3g}"
        bad, err, _ = smoke.beyond(g, p, lim_p)
        assert bad == 0, f"{name} vs plain: {bad} entries beyond, max abs err {err:.3g}"
    for name, c in zip(limits, control):
        beyond_control += smoke.beyond(c, limits[name][0], limits[name][1])[0]
    assert beyond_control > 0, "the dropped-carry control passes the limit"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [32, 64])
def test_ssm_scan_bwd_against_plain_and_float64(cuda, dtype, chunk):
    """K5' on strided views of one conv output (the model's), Mamba2's dt
    and A draws and randn ones, 160 steps at chunk 32 (five chunks) or
    192 at 64 (three)."""
    s = 160 if chunk == 32 else 192
    _scan_bwd_checked("ssm", _ssm_mamba2_inputs(cuda, 2, s, 3, dtype, chunk), chunk, chunk, cuda)
    _scan_bwd_checked("ssm", _ssm_inputs(cuda, 2, s, 3, dtype, chunk + 1), chunk, chunk, cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("draw", ["model", "fast"])
def test_rwkv6_scan_bwd_against_plain_and_float64(cuda, dtype, chunk, draw):
    """K6' on transposed head views of one projection (the model's), at the
    model's decay and at fast decay (logw down to -30), five chunks of 32
    or three of 64."""
    s = 160 if chunk == 32 else 192
    _scan_bwd_checked("rwkv6", _rwkv6_draw_inputs(cuda, 2, 3, s, dtype, draw, chunk), chunk,
                      chunk, cuda)


def test_scan_bwd_odd_chunk_and_unaligned_rows(cuda):
    """A chunk off the 16-step sub-chunk (24: K6' pads it) and bfloat16 rows
    that do not start on 16 bytes."""
    _scan_bwd_checked("rwkv6", _rwkv6_draw_inputs(cuda, 1, 2, 96, torch.bfloat16, "fast", 3,
                                                  pad=1), 24, 24, cuda)
    _scan_bwd_checked("ssm", _ssm_mamba2_inputs(cuda, 1, 96, 2, torch.bfloat16, 3, pad=1), 24,
                      24, cuda)


def _scan_bwd_against_emulation(kind, args, chunk, cuda):
    """K5' or K6' on ``args`` (the forward kernel's scratch, y's and the
    final state's gradients randn) against its CPU emulation
    (``kernels/ref.py:*_scan_bwd_split_ref``, the kernel's order of
    split-TF32 products) within twice ``scan_bwd_limits``, the limit the
    smoke holds it to against the plain backward, and against the float64
    gradient within the limit."""
    from repro_torch.kernels import rwkv6_scan as trw
    from repro_torch.kernels import ssm_scan as tss

    smoke = _smoke()
    gen = torch.Generator(device=cuda)
    gen.manual_seed(chunk + 1)
    if kind == "ssm":
        names, emulate = ("x", "dt", "A", "B", "C"), tref.ssm_scan_bwd_split_ref
        y, final, *scratch = tss._forward(*args, chunk)
    else:
        names, emulate = ("r", "k", "v", "logw", "u"), tref.rwkv6_scan_bwd_split_ref
        y, final, states = trw._forward(*args, chunk)
        scratch = [states, final]
    dy = torch.randn(y.shape, generator=gen, device=cuda)
    dstate = torch.randn(final.shape, generator=gen, device=cuda)
    bwd = tss.ssm_scan_bwd if kind == "ssm" else trw.rwkv6_scan_bwd
    got = bwd(*args, *scratch, dy, dstate)
    torch.cuda.synchronize()
    emulated = emulate(*(t.cpu() for t in args), dy.cpu(), dstate.cpu(), chunk)
    limits = smoke.scan_bwd_limits(kind, dict(zip(names, args)), dy, dstate, chunk)
    for name, g, e in zip(limits, got, emulated):
        exact, lim, lim_p = limits[name]
        assert g.dtype == e.dtype and g.shape == e.shape, name
        bad, err, _ = smoke.beyond(g, exact, lim)
        assert bad == 0, f"{name} vs float64: {bad} entries beyond, max abs err {err:.3g}"
        bad, err, _ = smoke.beyond(g, e.to(cuda), lim_p)
        assert bad == 0, f"{name} vs the emulation: {bad} entries beyond, max abs err {err:.3g}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_bwd_against_its_split_tf32_emulation(cuda, dtype):
    """K5' over 2 x 256 steps at chunk 64 and 11 heads (a head group of 8
    and one of 3 in the chunk kernel, folded in order), Mamba2's draws."""
    _scan_bwd_against_emulation("ssm", _ssm_mamba2_inputs(cuda, 2, 256, 11, dtype, 5), 64, cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("draw,chunk", [("model", 64), ("fast", 24)])
def test_rwkv6_scan_bwd_against_its_split_tf32_emulation(cuda, dtype, draw, chunk):
    """K6' over 2 x 3 heads x 192 steps on transposed head views, at the
    model's decay in chunks of 64 and at fast decay in chunks of 24 (padded
    to 32: two sub-chunks)."""
    _scan_bwd_against_emulation("rwkv6", _rwkv6_draw_inputs(cuda, 2, 3, 192, dtype, draw, 7),
                                chunk, cuda)


def test_scan_bwd_runs_on_tensor_cores(cuda):
    """K5''s and K6''s kernels that issue products (the reverse pass and the
    chunk kernel, both input types) hold HMMA (mma.sync) in their SASS, and
    none has a stack frame or local memory (``cuobjdump -res-usage``)."""
    _scan_bwd_against_emulation("ssm", _ssm_mamba2_inputs(cuda, 1, 64, 2, torch.bfloat16, 0), 64,
                                cuda)
    _scan_bwd_against_emulation("rwkv6", _rwkv6_draw_inputs(cuda, 1, 1, 64, torch.bfloat16,
                                                            "model", 0), 64, cuda)
    for scan in ("ssm_scan_bwd", "rwkv6_scan_bwd"):
        kernels = _smoke().scan_bwd_kernels(scan)
        assert len(kernels) == 4 and all(k[3] and k[1] == 0 and k[2] == 0
                                         for k in kernels.values()), (scan, kernels)


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-3b"])
def test_reduced_recurrent_train_step_on_the_card(cuda, arch):
    """One ``build_train_step`` step of the reduced Zamba2 (3 layers, the
    shared block after every 2nd) or RWKV6 (2 layers) over 2 x 256 tokens,
    its heads and state widened to 64 (the kernels' widths): each scan
    layer launches its forward twice (the forward and the remat recompute)
    and its backward once; the new params are finite; the loss and every
    gradient leaf within TRAIN_GRAD_TOL of the same step through the
    scans' plain pairs, which launch no scan kernel."""
    from unittest import mock

    from repro_torch.kernels import rwkv6_scan as trw
    from repro_torch.kernels import ssm_scan as tss
    from repro_torch.models import Model
    from repro_torch.models import rwkv as trwkv
    from repro_torch.models import ssm as tssm
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import build_train_step, init_train_state, loss_and_grads

    smoke = _smoke()
    cfg = get_config(arch).reduced()
    if cfg.ssm is not None:
        cfg = dataclasses.replace(cfg, n_layers=3, d_model=128, ssm=dataclasses.replace(
            cfg.ssm, head_dim=64, d_state=64, chunk=64, attn_every=2))
        module, name, pair = tssm, "ssm_scan_state", tss.ssm_scan_plain_pair
        fwd, fwd_entry, bwd, bwd_entry = (_build.SSM_SCAN, "ssm_scan", _build.SSM_SCAN_BWD,
                                          "ssm_scan_bwd")
        layers = 3
    else:
        cfg = dataclasses.replace(cfg, d_model=128, n_heads=2,
                                  rwkv=dataclasses.replace(cfg.rwkv, head_dim=64, chunk=64))
        module, name, pair = trwkv, "rwkv6_scan_state", trw.rwkv6_scan_plain_pair
        fwd, fwd_entry, bwd, bwd_entry = (_build.RWKV6_SCAN, "rwkv6_scan",
                                          _build.RWKV6_SCAN_BWD, "rwkv6_scan_bwd")
        layers = cfg.n_layers
    model = Model(cfg)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    state = init_train_state(model, gen, AdamWConfig())
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 257), dtype=np.int32)).to(cuda)
    f0, b0 = fwd.launches[fwd_entry], bwd.launches[bwd_entry]
    new, metrics = build_train_step(model, AdamWConfig())(state, {"tokens": toks})
    torch.cuda.synchronize()
    assert fwd.launches[fwd_entry] == f0 + 2 * layers
    assert bwd.launches[bwd_entry] == b0 + layers
    assert all(bool(torch.isfinite(t).all()) for t in smoke.tree_paths(new.params).values())
    loss_k, _, g_k = loss_and_grads(model, state.params, {"tokens": toks})
    f0, b0 = fwd.launches[fwd_entry], bwd.launches[bwd_entry]
    with mock.patch.object(module, name, pair):
        loss_p, _, g_p = loss_and_grads(model, state.params, {"tokens": toks})
    assert fwd.launches[fwd_entry] == f0 and bwd.launches[bwd_entry] == b0
    assert abs(float(loss_k) - float(loss_p)) <= 1e-2 * abs(float(loss_p))
    shares = smoke.grad_shares(g_k, g_p)
    assert max(shares.values()) <= 1.0, max(shares.items(), key=lambda kv: kv[1])


def test_reduced_dense_train_step_on_the_card_through_k4(cuda):
    """One ``build_train_step`` step of the reduced Qwen2-0.5B over 1,088
    tokens on the card (the chunked impl: K4 forward twice a layer, the
    forward and the remat recompute, and its backward once) against the
    same step through K4's plain forward and backward: the loss within
    1e-2, each gradient leaf within the smoke's TRAIN_GRAD_TOL (10% of its
    largest, a k bias of its wk's), the new params finite."""
    from unittest import mock

    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models import Model
    from repro_torch.models import attention as tattention
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import build_train_step, init_train_state, loss_and_grads

    smoke = _smoke()
    cfg = get_config("qwen2-0.5b").reduced()
    model = Model(cfg)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    state = init_train_state(model, gen, AdamWConfig())
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 1089), dtype=np.int32)).to(cuda)
    f0 = _build.FLASH_ATTENTION.launches["flash_attention"]
    b0 = _build.FLASH_ATTENTION_BWD.launches["flash_attention_bwd"]
    new, metrics = build_train_step(model, AdamWConfig())(state, {"tokens": toks})
    torch.cuda.synchronize()
    assert _build.FLASH_ATTENTION.launches["flash_attention"] == f0 + 2 * cfg.n_layers
    assert _build.FLASH_ATTENTION_BWD.launches["flash_attention_bwd"] == b0 + cfg.n_layers
    assert all(bool(torch.isfinite(t).all()) for t in smoke.tree_paths(new.params).values())
    loss_k, _, g_k = loss_and_grads(model, state.params, {"tokens": toks})
    with mock.patch.object(tattention, "flash_attention", tfa.flash_attention_plain_pair):
        loss_p, _, g_p = loss_and_grads(model, state.params, {"tokens": toks})
    assert abs(float(loss_k) - float(loss_p)) <= 1e-2 * abs(float(loss_p))
    assert float(metrics["loss"]) == float(loss_k)
    shares = smoke.grad_shares(g_k, g_p)
    assert max(shares.values()) <= 1.0, max(shares.items(), key=lambda kv: kv[1])


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b",
                                  "whisper-small", "internvl2-26b"])
def test_reduced_frontier_train_step_on_the_card_through_k4(cuda, arch):
    """One ``build_train_step`` step of the reduced Qwen1.5-MoE,
    DeepSeek-V2-Lite (MLA at its reduced widths, (24, 16), through K4's
    padded route), Whisper-small (encoder over 1,500 frames, so K4 runs
    there too) or InternVL2-26B (8 patch embeddings, group 4) over 2 x
    1,088 tokens on the card: K4 twice and K4' once a K4 call of a forward
    (``chip_smoke.attention_calls``), the new params finite; then the
    smoke's first-step check (``first_step_grad_check``): the loss within
    1e-2 and each gradient leaf within TRAIN_GRAD_TOL of the same step
    through K4's plain pair, the MoE models' plain run replaying the K4
    run's routing, and the detached-attention control beyond the limit."""
    from repro_torch.configs.base import EncDecConfig
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models import Model
    from repro_torch.models.model import FRONTEND_DIM
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import build_train_step, init_train_state

    smoke = _smoke()
    cfg = get_config(arch).reduced()
    if cfg.encdec is not None:
        cfg = dataclasses.replace(cfg, encdec=EncDecConfig(n_enc_layers=2,
                                                           n_enc_positions=1500))
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 1089), dtype=np.int32)).to(cuda)}
    if cfg.frontend == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, 1500, FRONTEND_DIM["audio"]), dtype=np.float32)).to(cuda)
    elif cfg.frontend == "vision":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_frontend_tokens, FRONTEND_DIM["vision"]), dtype=np.float32)).to(cuda)
    model = Model(cfg)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    state = init_train_state(model, gen, AdamWConfig())
    n = smoke.attention_calls(cfg)
    f0 = _build.FLASH_ATTENTION.launches["flash_attention"]
    b0 = _build.FLASH_ATTENTION_BWD.launches["flash_attention_bwd"]
    pads = tfa.PAD_COPIES["q"]
    new, metrics = build_train_step(model, AdamWConfig())(state, batch)
    torch.cuda.synchronize()
    assert _build.FLASH_ATTENTION.launches["flash_attention"] == f0 + 2 * n
    assert _build.FLASH_ATTENTION_BWD.launches["flash_attention_bwd"] == b0 + n
    assert (tfa.PAD_COPIES["q"] > pads) == (cfg.mla is not None)
    assert math.isfinite(float(metrics["loss"]))
    assert all(bool(torch.isfinite(t).all()) for t in smoke.tree_paths(new.params).values())
    del new, state
    grad, _ = smoke.first_step_grad_check(cuda, cfg, batch, smoke.k4_checked())
    assert grad["launches"] == {"flash_attention": 2 * n, "flash_attention_bwd": n}
    assert grad["worst"][1] <= 1.0 and grad["detached_control_worst"][1] > 1.0


# ---------------------------------------------------------------------------
# the examples (repro_torch.examples) on the card, at the CPU tests' sizes,
# against the same example's plain run on the CPU
# ---------------------------------------------------------------------------

EXAMPLE_NAMES = ("train_lm", "serve_lm", "moe_pipeline", "ida_pipeline",
                 "preemptive_serving", "hetero_pipeline", "serve_pipelines", "quickstart")
#: train_lm's gradient stage on the card against the CPU: float32
#: activations, so sum orders only (K4's FMA path, cuBLAS, the pool's
#: completion order): the loss to 1e-5, each leaf to 1e-3 of its largest
EXAMPLE_F32_TOL = 1e-3


def _example(name: str):
    import importlib

    return importlib.import_module(f"repro_torch.examples.{name}")


def _example_model32():
    """The examples' models with float32 activations (a test-only view, as
    ``tests/test_torch_rwkv.py``'s ``_T32``)."""
    from repro_torch.models import Model
    from repro_torch.models.layers import embed

    class Model32(Model):
        def _embed_inputs(self, params, batch_inputs):
            return embed(params["embed"], batch_inputs["tokens"]).float()

    return Model32


def _same(a, b) -> bool:
    """Equal, arrays bitwise, dicts and lists entry by entry."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def test_examples_refuse_cuda_without_a_card(cuda, monkeypatch, capsys):
    """``--torch-device cuda`` where no card is found (``is_available``
    false) raises in every example before it does anything: nothing
    printed, nothing launched, nothing run on the CPU instead."""
    before = {e: n for k in _build.KERNELS for e, n in k.launches.items()}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in EXAMPLE_NAMES:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _example(name).main(["--torch-device", "cuda"])
    assert capsys.readouterr().out == ""
    assert {e: n for k in _build.KERNELS for e, n in k.launches.items()} == before


@pytest.mark.parametrize("name,kw,keys", [
    ("quickstart", dict(scale=10, linreg_rows=4_000),
     ("labels", "beta", "simulated_makespans", "auto_selected", "auto_selected_makespan")),
    ("serve_pipelines", dict(scale=10, linreg_rows=2_000, rec_users=512),
     ("search", "assign", "tuned_p99", "isolated_p99", "drained_jobs")),
])
def test_examples_host_only_run_the_same_beside_the_card(cuda, name, kw, keys):
    card = _example(name).run(**kw, torch_device="cuda")
    plain = _example(name).run(**kw, torch_device="cpu")
    for key in keys:
        assert _same(card[key], plain[key]), key


def test_examples_ida_pipeline_runs_k2_bitwise(cuda):
    kw = dict(scale=10, linreg_rows=3_000, linreg_cols=33, rec_users=400, rec_items=24,
              dense_n=256)
    card = _example("ida_pipeline").run(**kw, torch_device="cuda")
    plain = _example("ida_pipeline").run(**kw, torch_device="cpu")
    assert card["device"] == {t: "bitwise" for t in ("STATIC", "MFSC", "GSS")}
    assert card["launches"] == {"cc_propagate": 3} and plain["launches"] == {}
    for key in ("labels", "cc_iterations", "offline_assign", "offline_makespan",
                "coordinator_partials"):
        assert _same(card[key], plain[key]), key


def test_examples_moe_pipeline_walks_k1_within_its_limits(cuda):
    """The same weights (drawn on the CPU) on both runs: the host's direct
    and scheduled runs bitwise the CPU run's, the walked combine within
    its float64-derived limits of direct (the example raises past them)."""
    from repro_torch.models.moe import init_moe

    cfg = get_config("qwen2-moe-a2.7b").reduced()
    moe = dataclasses.replace(cfg.moe, n_routed=8, capacity_factor=6.0)
    params = init_moe(torch.Generator().manual_seed(0), cfg.d_model, moe)
    kw = dict(tokens=96, experts=8, skew=1.6, capacity_factor=6.0, workers=2, device=True)
    card = _example("moe_pipeline").run(**kw, torch_device="cuda", params=params)
    plain = _example("moe_pipeline").run(**kw, torch_device="cpu", params=params)
    assert np.array_equal(card["direct"], plain["direct"])
    assert set(card["scheduled"].values()) == {"bitwise"}
    assert card["device"]["launches"] == {"walk_moe": 1}
    for key in ("slabs_vs_float64", "slabs_vs_float64_rss", "combine_vs_direct"):
        assert 0.0 <= card["device"][key] <= 1.0, key
    assert plain["device"]["combine_vs_direct"] == "bitwise"
    for key in ("offline_experts", "offline_makespan", "online_makespan", "resizes"):
        assert _same(card[key], plain[key]), key


def test_examples_preemptive_serving_migrates_through_k3(cuda):
    card = _example("preemptive_serving").run(jobs=120, torch_device="cuda")
    plain = _example("preemptive_serving").run(jobs=120, torch_device="cpu")
    one = {"walk_linreg": 1}
    assert card["launches"] == {"unmigrated_walk": one, "host_to_device": one,
                                "device_prefix": one}
    assert card["host_resume"] == {"moments": "bitwise", "syrk_gemv": "bitwise"}
    for part in ("host_to_device", "device_to_host"):
        assert all(0.0 <= v <= 1.0 for v in card[part].values()), part
    for key in ("checkpoint", "fair_hit_rate", "preemptive_hit_rate", "preemption_events",
                "first_preemption"):
        assert _same(card[key], plain[key]), key


def test_examples_hetero_pipeline_walks_on_the_lane(cuda):
    """Step 4 (rebalancing off) walks every device-placed chunk on the
    lane: K1, each run continuing a sum's fold from its prefix."""
    card = _example("hetero_pipeline").run(affinity_rows=512, rounds=40, torch_device="cuda")
    plain = _example("hetero_pipeline").run(affinity_rows=512, rounds=40, torch_device="cpu")
    walks = card["launches"]["submission_placement"]
    assert set(walks) == {"walk_linreg"} and walks["walk_linreg"] > 0
    for part in ("co_execution", "submission_placement"):
        assert all(0.0 <= v <= 1.0 for v in card[part].values()), part
    assert card["beta_matches_oracle"]
    for key in ("placed_makespan", "placement", "transfers", "online_assign",
                "online_makespan"):
        assert _same(card[key], plain[key]), key


def test_examples_serve_lm_through_k4_is_its_plain_run(cuda):
    """1,088-token prompts (K4 in every prefill, float32 activations): the
    scheduled tokens bitwise the direct run's on the card (the example
    asserts it) and the CPU run's."""
    from repro_torch.optim.adamw import tree_map

    serve_lm = _example("serve_lm")
    cfg = serve_lm.config()
    model = _example_model32()(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    kw = dict(requests=5, slots=2, prompt_len=1088, gen_len=4)
    card = serve_lm.run(**kw, torch_device="cuda", model=model,
                        params=tree_map(lambda t: t.to(cuda), params))
    plain = serve_lm.run(**kw, torch_device="cpu", model=model, params=params)
    assert card["launches"] == {"flash_attention": cfg.n_layers * kw["requests"]}
    assert card["scheduled_vs_direct"] == "bitwise"
    assert np.array_equal(card["tokens"], plain["tokens"])


def test_examples_train_lm_through_k4_and_its_gradient(cuda, tmp_path):
    """The loop over 1,088 tokens on the card (K4 twice a layer and
    microbatch, K4' once), its loss decreasing; and one step's gradient
    stage (two pool threads) on the card against the CPU's, the same
    weights, float32 activations, within EXAMPLE_F32_TOL."""
    from repro_torch.core import make_config
    from repro_torch.data import DataPipeline, SyntheticCorpus
    from repro_torch.optim.adamw import tree_map

    train_lm = _example("train_lm")
    widths = dict(d_model=64, layers=2, heads=4, d_ff=128, vocab=512)
    kw = dict(widths, seq=1088, batch=4, microbatches=2, steps=4, lr=3e-3)
    out = train_lm.run(**kw, ckpt_dir=str(tmp_path), torch_device="cuda")
    assert out["launches"] == {"flash_attention": 2 * 2 * 2 * 4,
                               "flash_attention_bwd": 2 * 2 * 4}
    assert all(math.isfinite(x) for x in out["losses"])
    assert out["last_loss"] < out["first_loss"]

    cfg = train_lm.scaled_config(**widths)
    model = _example_model32()(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(DataPipeline(SyntheticCorpus(vocab_size=512, mean_len=544), 4,
                                         1088).assemble(0))
    pool = make_config("fac2", n_workers=2)
    got, _ = train_lm.scheduled_grads(model, tree_map(lambda t: t.to(cuda), params),
                                      toks.to(cuda), 2, pool)
    want, _ = train_lm.scheduled_grads(model, params, toks, 2, pool)
    got = got.cpu()
    assert abs(float(got[0]) - float(want[0])) <= 1e-5 * abs(float(want[0]))
    smoke = _smoke()
    g, w = (smoke.tree_paths(train_lm.unflatten(v[1:], params)) for v in (got, want))
    for p in w:
        err = float((g[p] - w[p]).abs().max())
        assert err <= EXAMPLE_F32_TOL * smoke.leaf_scale(w, p), (p, err)
