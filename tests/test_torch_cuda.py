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
import math

import numpy as np
import pytest
import torch

from repro_torch.core import (PipelineDAG, PreemptiveRunner, SchedulerConfig,
                              Stage, build_dag_tables)
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

SUM_RTOL = 1e-4

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


def test_moe_walk_against_float64(cuda):
    low = _moe_lowering(cuda, "ragged")
    dlow = tml.moe_device_lowering(low)
    got = tapps.run_device_dag(dlow)[0]["experts"]
    e, c, d = low.meta["n_experts"], dlow.tile, low.meta["d_model"]
    f = dlow.values["wo"].shape[1]
    x = dlow.values["xdisp"].view(e, c, d).double()
    h = torch.bmm(x, dlow.values["wi"].double())
    a = torch.nn.functional.silu(h[..., :f]) * h[..., f:]
    ref = torch.bmm(a, dlow.values["wo"].double()).reshape(e * c, d)
    # eps * sqrt(k) * sum|terms| of the second product, with the first
    # product's own limit carried through it (|silu'| <= 1.1)
    A = torch.bmm(x.abs(), dlow.values["wi"].double().abs())
    B = 1.1 * h[..., f:].abs() * A[..., :f] + h[..., :f].abs() * A[..., f:]
    wo = dlow.values["wo"].double().abs()
    lim = 2.0 ** -23 * ((math.sqrt(f) + 4) * torch.bmm(a.abs(), wo)
                        + math.sqrt(d) * torch.bmm(B, wo)).reshape(e * c, d)
    assert bool(((got.double() - ref).abs() <= lim).all())


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [16, 64, 128])
@pytest.mark.parametrize("group", [1, 4, 7])
def test_flash_attention_matches_plain(cuda, dtype, causal, dh, group):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    gen = torch.Generator(device=cuda)
    gen.manual_seed(dh * 10 + group)
    b, kv, s = 2, 2, 200  # 200 is no multiple of the 64-row tiles
    q = torch.randn((b, kv * group, s, dh), generator=gen, device=cuda).to(dtype)
    k = torch.randn((b, kv, s, dh), generator=gen, device=cuda).to(dtype)
    v = torch.randn((b, kv, s, dh), generator=gen, device=cuda).to(dtype)
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
    with pytest.raises(ValueError, match="dh in"):
        flash_attention(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="one dtype"):
        flash_attention(q, k.bfloat16(), v)


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
