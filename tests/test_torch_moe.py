"""The port's MoE expert dispatch and its supporting copies against the JAX
package's.

Covers the configs (all ten architectures, full and reduced), the
registry's ``make_config``, the lowering toolkit (``core/lower.py``), the
MoE routing and capacity semantics, the host pipeline under several
techniques and the walker lowering with the ``tile`` block index.

Both packages get the same inputs: tokens are numpy from a seed, and the
weights are the reference's ``init_moe`` arrays carried across by
``moe_params_from_reference``. Tolerances: the routing plan (expert
indices, positions, kept counts) and the tokens are exact; route weights
agree to 1e-6 (PyTorch's and XLA's softmax round differently); the
expert slabs and the combined ``(T, d)`` answer agree to 1e-5 of the
output's largest magnitude (the two frameworks sum a product's terms in
different orders; the measured gap is about 5e-7 of it). Inside the port
every host run is bitwise equal to ``run_direct``, and the plain walk to
the host ``experts`` stage, on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, list_configs as jlist_configs
from repro.core import lower as jlower
from repro.core.dag import PipelineExecutor as JExecutor
from repro.core.registry import make_config as jmake_config
from repro.models.moe import _dispatch_compute_combine as jdcc, _route as jroute
from repro.vee import ml_apps as jml
from repro.vee.apps import run_device_dag as jrun_device_dag
from repro_torch.configs import get_config, list_configs
from repro_torch.core import (PipelineExecutor, Lowered, chain_dag, costs_from_sizes,
                              fanout_stage, make_config, measure_stage_costs,
                              run_direct)
from repro_torch.kernels import dag_walk as twalk
from repro_torch.models.layers import he_init, init_mlp
from repro_torch.models.moe import _dispatch_compute_combine, _route, init_moe
from repro_torch.vee import ml_apps as tml
from repro_torch.vee.apps import run_device_dag

ARCHS = jlist_configs()
FLOAT_RTOL = 1e-5
WEIGHT_ATOL = 1e-6
N_TOKENS = 48


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL,
                               atol=FLOAT_RTOL * float(np.abs(want).max()),
                               err_msg=what)


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_parity(arch):
    got, want = get_config(arch), jget_config(arch)
    for g, w in ((got, want), (got.reduced(), want.reduced())):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
        assert (g.head_dim, g.padded_vocab, g.is_attention_free,
                g.supports_long_context) == (w.head_dim, w.padded_vocab,
                                             w.is_attention_free,
                                             w.supports_long_context)
        gm, wm = g.moe_padded(16), w.moe_padded(16)
        assert (gm is None and wm is None) or dataclasses.asdict(gm) == dataclasses.asdict(wm)
    assert got.param_count() == want.param_count()
    assert got.reduced().param_count() == want.reduced().param_count()


def test_registry_lists_the_same_architectures():
    assert list_configs() == jlist_configs()
    for getter in (get_config, jget_config):
        with pytest.raises(ValueError, match="unknown arch 'nope'"):
            getter("nope")


@pytest.mark.parametrize("spec", ["gss", "fac2/percore", "tss/pergroup/rnd",
                                  "SS", ("mfsc", "percore", "seqpri"), " static / "])
def test_make_config_matches_reference(spec):
    got = make_config(spec, n_workers=3)
    want = jmake_config(spec, n_workers=3)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert make_config(got) is got
    assert make_config(got, n_workers=5).n_workers == 5


@pytest.mark.parametrize("spec", ["", "gss/percore/seq/extra", "nope",
                                  "gss/sideways", "gss/percore/never"])
def test_make_config_errors(spec):
    with pytest.raises(ValueError) as want:
        jmake_config(spec)
    with pytest.raises(ValueError) as got:
        make_config(spec)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the lowering toolkit
# ---------------------------------------------------------------------------

def _steps():
    return [("a", lambda _p, r: np.float64(r)),
            ("b", lambda p, _r: p + 1.0),
            ("c", lambda p, _r: p * 2.0)]


@pytest.mark.parametrize("spec", ["ss", "gss", "fac2/percore"])
def test_chain_dag_matches_reference(spec):
    tdag, jdag = chain_dag(10, _steps()), jlower.chain_dag(10, _steps())
    assert tdag.stage_names == jdag.stage_names
    for n in tdag.stage_names:
        assert [(d.producer, d.kind) for d in tdag.stages[n].deps] == \
            [(d.producer, d.kind) for d in jdag.stages[n].deps]
    direct, jdirect = run_direct(tdag), jlower.run_direct(jdag)
    for n in tdag.stage_names:
        assert np.array_equal(direct[n], jdirect[n])
    res = PipelineExecutor(tdag, make_config(spec, n_workers=2)).run()
    jres = JExecutor(jdag, jmake_config(spec, n_workers=2)).run()
    for n in tdag.stage_names:
        assert np.array_equal(res.values[n], direct[n])
        assert np.array_equal(res.values[n], jres.values[n])
    with pytest.raises(ValueError, match="at least one step"):
        chain_dag(4, [])


def test_fanout_costs_and_lowered_match_reference():
    sizes = [5, 1, 9, 2]
    st = fanout_stage("f", lambda _i, g: np.full(3, float(g)), sizes)
    jst = jlower.fanout_stage("f", lambda _i, g: np.full(3, float(g)), sizes)
    for s, z in [(0, 4), (2, 1), (1, 2)]:
        assert st.cost_of_range(s, z) == jst.cost_of_range(s, z)
    assert np.array_equal(costs_from_sizes(sizes, 2.0, 0.5),
                          jlower.costs_from_sizes(sizes, 2.0, 0.5))
    dag = chain_dag(6, _steps())
    costs = measure_stage_costs(dag, sample=2)
    assert {n: v.shape for n, v in costs.items()} == {n: (6,) for n in dag.stage_names}
    assert all((v > 0).all() for v in costs.values())
    low = Lowered(dag, {"a": np.ones(6)}, lambda v: v["c"])
    sub = low.submission(name="x", tenant="t0", weight=2.0)
    assert sub.dag is dag and sub.tenant == "t0" and sub.weight == 2.0
    value, res = low.run("gss", n_workers=2)
    assert np.array_equal(value, low.run_direct())
    assert set(res.values) == set(dag.stage_names)
    assert set(Lowered(dag).run_direct()) == set(dag.stage_names)


# ---------------------------------------------------------------------------
# MoE: weights, routing, capacity
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """The reference's and the port's lowering of one MoE layer, same weights."""
    jlow = jml.moe_dispatch_lowering(n_tokens=N_TOKENS, skew=1.2, seed=0)
    params = tml.moe_params_from_reference(jlow.meta["params"], device="cpu")
    tlow = tml.moe_dispatch_lowering(n_tokens=N_TOKENS, skew=1.2, seed=0,
                                     params=params, device="cpu")
    return jlow, tlow


def test_init_moe_shapes_and_seed():
    moe = get_config("qwen2-moe-a2.7b").reduced().moe
    gen = torch.Generator().manual_seed(3)
    p = init_moe(gen, 64, moe)
    e, f = moe.n_routed, moe.d_ff_expert
    assert p["router"].shape == (64, e)
    assert p["experts"]["wi"].shape == (e, 64, 2 * f)
    assert p["experts"]["wo"].shape == (e, f, 64)
    assert p["shared"]["wi"].shape == (64, 2 * moe.n_shared * f)
    q = init_moe(torch.Generator().manual_seed(3), 64, moe)
    assert torch.equal(p["experts"]["wi"], q["experts"]["wi"])
    # He scaling: std 1/sqrt(fan_in)
    assert abs(float(p["experts"]["wi"].std()) - 64 ** -0.5) < 0.01
    w = he_init(torch.Generator().manual_seed(0), (4096, 16), 256)
    assert abs(float(w.std()) - 1 / 16) < 0.005
    m = init_mlp(torch.Generator().manual_seed(0), 8, 4, gated=False, bias=True)
    assert m["wi"].shape == (8, 4) and m["bo"].shape == (8,)


def test_params_from_reference_are_the_reference_arrays(pair):
    jlow, tlow = pair
    jp, tp = jlow.meta["params"], tlow.meta["params"]
    assert np.array_equal(tp["router"].numpy(), np.asarray(jp["router"]))
    for k in ("wi", "wo"):
        assert np.array_equal(tp["experts"][k].numpy(), np.asarray(jp["experts"][k]))
        assert np.array_equal(tp["shared"][k].numpy(), np.asarray(jp["shared"][k]))


def test_routing_plan_matches_reference(pair):
    jlow, tlow = pair
    jm, tm = jlow.meta, tlow.meta
    assert np.array_equal(tm["x_flat"], jm["x_flat"])      # bitwise
    assert (tm["capacity"], tm["n_experts"], tm["d_model"]) == \
        (jm["capacity"], jm["n_experts"], jm["d_model"])
    k = jm["moe"].top_k
    jr, tr = np.asarray(jm["route_build"]), tm["route_build"]
    assert np.array_equal(tr[:, :k], jr[:, :k])              # expert indices
    np.testing.assert_allclose(tr[:, k:], jr[:, k:], atol=WEIGHT_ATOL, rtol=0)
    assert np.array_equal(tm["expert_tokens"], jm["expert_tokens"])
    jplan = jml._dispatch_plan(jr, jm["n_experts"], jm["capacity"])
    tplan = tml._dispatch_plan(tr, tm["n_experts"], tm["capacity"])
    for name, a, b in zip(("idx", "w", "pos", "kept"), tplan, jplan):
        if name == "w":
            np.testing.assert_allclose(a, b, atol=WEIGHT_ATOL, rtol=0)
        else:
            assert np.array_equal(a, b), name
    assert tlow.dag.stage_names == jlow.dag.stage_names
    for n in tlow.dag.stage_names:
        assert np.array_equal(tlow.stage_costs[n], jlow.stage_costs[n])
    e = tm["n_experts"]
    stage = tlow.dag.stages["experts"]
    assert stage.cost_of_range(0, e) == pytest.approx(float(tm["expert_tokens"].sum() + e))


def test_skewed_tokens_bitwise_and_skewed():
    rng = np.random.default_rng(0)
    router = rng.standard_normal((32, 8)).astype(np.float32)
    x = tml.skewed_tokens(router, 256, skew=1.6, seed=1)
    assert np.array_equal(x, jml.skewed_tokens(router, 256, skew=1.6, seed=1))
    hist = np.bincount((x @ router).argmax(axis=1), minlength=8)
    assert hist[0] == hist.max() and hist[0] > 256 // 8


def test_capacity_semantics_match_reference(pair):
    """The lowering tracks models/moe.py, in both packages."""
    jlow, tlow = pair
    meta = tlow.meta
    x = torch.from_numpy(meta["x_flat"])
    idx, w, probs = _route(meta["params"]["router"], x, meta["moe"])
    jidx, jw, jprobs = jroute(jlow.meta["params"]["router"], meta["x_flat"],
                              jlow.meta["moe"])
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=WEIGHT_ATOL, rtol=0)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=WEIGHT_ATOL, rtol=0)
    y_dcc = _dispatch_compute_combine(meta["params"], x, idx, w, meta["capacity"],
                                      meta["moe"])
    jy_dcc = jdcc(jlow.meta["params"], meta["x_flat"], jidx, jw,
                  meta["capacity"], jlow.meta["moe"])
    _close(y_dcc.numpy(), np.asarray(jy_dcc), "_dispatch_compute_combine")
    # the lowering (mul-reduce router logits) against the block's semantics
    plan_idx, _, _, kept = tml._dispatch_plan(meta["route_build"],
                                              meta["n_experts"], meta["capacity"])
    match = (idx.numpy() == plan_idx).all(axis=1)
    assert match.mean() > 0.9
    y = tlow.run_direct()
    np.testing.assert_allclose(y[match], y_dcc.numpy()[match], rtol=2e-4, atol=2e-4)
    assert kept.sum() <= N_TOKENS * meta["moe"].top_k


def test_moe_padding_experts_never_routed():
    low = tml.moe_dispatch_lowering(n_tokens=16, seed=2, device="cpu")
    padded = dataclasses.replace(low.meta["moe"], n_routed_padded=8)
    x = torch.from_numpy(low.meta["x_flat"])
    router = torch.cat([low.meta["params"]["router"],
                        torch.ones(64, 2) * 100.0], dim=1)   # loud padding columns
    idx, _, probs = _route(router, x, padded)
    assert int(idx.max()) < padded.n_routed
    assert float(probs[:, padded.n_routed:].max()) == 0.0


def test_moe_lowering_rejects_dense_arch():
    with pytest.raises(ValueError, match="has no MoE config"):
        tml.moe_dispatch_lowering("qwen2-0.5b", n_tokens=4, device="cpu")
    bad = {"router": torch.zeros(64, 3), "experts": {"wi": torch.zeros(1),
                                                     "wo": torch.zeros(1)}}
    with pytest.raises(ValueError, match="params 'router'"):
        tml.moe_dispatch_lowering(n_tokens=4, params=bad, device="cpu")


def test_moe_lowering_for_a_config_is_the_public_function():
    a = tml.moe_dispatch_lowering(n_tokens=12, seed=1, device="cpu")
    b = tml.moe_dispatch_lowering_for(get_config("qwen2-moe-a2.7b").reduced(),
                                      n_tokens=12, seed=1, device="cpu")
    assert np.array_equal(a.meta["route_build"], b.meta["route_build"])
    assert np.array_equal(a.run_direct(), b.run_direct())
    assert str(a.meta["params"]["router"].device) == "cpu"


# ---------------------------------------------------------------------------
# MoE: host runs and the walker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tech", ["STATIC", "GSS", "TSS", "FAC2"])
def test_moe_host_runs_bitwise_and_near_reference(pair, tech):
    jlow, tlow = pair
    direct = tlow.run_direct()
    sched, res = tlow.run(tech, n_workers=3)
    assert np.array_equal(sched, direct)
    assert set(res.values) == {"route", "experts", "combine"}
    _close(sched, np.asarray(jlow.run_direct()), f"{tech} vs reference")


def test_moe_tile_index_selects_the_repeated_slab(pair):
    """On the reference's own inputs, the ``tile`` block index picks the
    slab that the reference's repeated weights pick with ``row``."""
    jlow, tlow = pair
    jd = jml.moe_device_lowering(jlow)
    td = tml.moe_device_lowering(tlow)
    cap, e = td.tile, tlow.meta["n_experts"]
    assert jd.tile == cap
    jops = {o.name: o for o in jd.operands}
    tops = {o.name: o for o in td.operands}
    for name in ("wi", "wo"):
        rep = torch.from_numpy(np.array(jd.values[name]))
        for g in range(e):
            for start in (g * cap, g * cap + cap - 1):
                want = twalk._block(rep, jops[name].block, jops[name].index,
                                    start, 0, cap)[0]
                got = twalk._block(td.values[name], tops[name].block,
                                   tops[name].index, start, 0, cap)[0]
                assert torch.equal(got, want), (name, g, start)
    assert np.array_equal(td.values["xdisp"].numpy(), np.asarray(jd.values["xdisp"]))


@pytest.mark.parametrize("tech", ["STATIC", "GSS", "TSS"])
def test_moe_plain_walk_equals_host_stage(pair, tech):
    jlow, tlow = pair
    e, cap, d = (tlow.meta[k] for k in ("n_experts", "capacity", "d_model"))
    dlow = tml.moe_device_lowering(tlow)
    host = PipelineExecutor(dlow.dag, make_config(tech, n_workers=2)).run()
    vals, ddt = run_device_dag(dlow, tech)
    assert ddt.tables.shape[1] == e                      # one slot an expert
    walked = vals["experts"]
    assert walked.shape == (e * cap, d)
    assert torch.equal(walked, torch.as_tensor(host.values["experts"]).reshape(e * cap, d))
    direct = run_direct(tlow.dag)["experts"]                 # the lowering's own stage
    assert np.array_equal(walked.reshape(e, cap, d).numpy(), direct)
    assert np.array_equal(dlow.finalize(vals).numpy(), tlow.run_direct())
    # against the reference's walk (Pallas, interpret mode)
    jvals, _ = jrun_device_dag(jml.moe_device_lowering(jlow), tech)
    _close(walked.numpy(), np.asarray(jvals["experts"]), "experts walk")
