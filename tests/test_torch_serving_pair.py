"""The port's dense-LM step lowering and two-model serving pair against the
JAX package's.

Weights and prompts are the reference's own (``meta["params"]`` through
``model_params_from_reference``, ``meta["tokens"]``). The port's logits
are held to the reference's within ``MODEL_TOL`` (4% of the largest
|logit|), the bar ``tests/test_torch_models.py`` holds the dense decoder
to: bfloat16 activations, summed in other orders by XLA and PyTorch. Within
the port the contract is exact: the scheduled chain and the served pair
call the same per-row functions on the same rows as the direct
composition, so their logits are bitwise ``run_direct``'s under any
technique and on the shared pool. The placement is solved on virtual costs
in both packages and must be the reference's.
"""

import jax
import numpy as np
import pytest

from repro.vee import ml_apps as jml
from repro_torch.core.online import OnlineScheduler
from repro_torch.models import model_params_from_reference
from repro_torch.vee import ml_apps as tml

MODEL_TOL = 0.04
ARCHS = ("qwen2-0.5b", "granite-8b")


def _params(low):
    return model_params_from_reference(jax.tree.map(np.asarray, low.meta["params"]),
                                       "cpu")


def _close(got, want):
    scale = float(np.abs(want).max())
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= MODEL_TOL * scale


@pytest.fixture(scope="module")
def pair():
    """The reference's serving pair and the port's on the same weights."""
    jres, jsubs, jpl, jlows = jml.serving_pair(ARCHS, batch=3, seq=6, n_workers=2)
    got = tml.serving_pair(
        ARCHS, batch=3, seq=6, n_workers=2,
        params={a: _params(low) for a, low in zip(ARCHS, jlows)},
        tokens={a: low.meta["tokens"] for a, low in zip(ARCHS, jlows)},
        device="cpu")
    return got, (jres, jsubs, jpl, jlows)


@pytest.mark.parametrize("spec", ["gss", "fac2/percore", "ss"])
def test_transformer_step_equals_reference_and_is_exact(pair, spec):
    jlow = pair[1][3][0]
    low = tml.transformer_step_lowering(ARCHS[0], batch=3, seq=6, params=_params(jlow),
                                        tokens=jlow.meta["tokens"], device="cpu")
    assert low.dag.stage_names == jlow.dag.stage_names
    assert {k: v.tolist() for k, v in low.stage_costs.items()} == {
        k: v.tolist() for k, v in jlow.stage_costs.items()}
    direct = low.run_direct()
    assert direct.dtype == np.float32
    _close(direct, jlow.run_direct())
    sched, res = low.run(spec, n_workers=3)
    assert np.array_equal(sched, direct)
    assert set(res.values) == set(low.dag.stage_names)


def test_transformer_step_under_online_resizing(pair):
    jlow = pair[1][3][1]
    low = tml.transformer_step_lowering(ARCHS[1], batch=3, seq=6, params=_params(jlow),
                                        tokens=jlow.meta["tokens"], device="cpu")
    sched, _ = low.run("ss", n_workers=2, online=OnlineScheduler(seed=0, min_observe=2))
    assert np.array_equal(sched, low.run_direct())


def test_transformer_step_draws_its_own_weights_by_seed():
    a, b, c = (tml.transformer_step_lowering(batch=2, seq=4, seed=s, device="cpu")
               for s in (1, 1, 2))
    assert np.array_equal(a.meta["tokens"], b.meta["tokens"])
    assert np.array_equal(a.run_direct(), b.run_direct())
    assert not np.array_equal(a.run_direct(), c.run_direct())
    assert a.meta["device"].type == "cpu" and a.meta["tokens"].shape == (2, 4)


def test_transformer_step_refusals():
    with pytest.raises(ValueError, match="dense"):
        tml.transformer_step_lowering("qwen2-moe-a2.7b", batch=2, seq=4, device="cpu")
    with pytest.raises(ValueError, match="tokens of shape"):
        tml.transformer_step_lowering(batch=2, seq=4, tokens=np.zeros((3, 4), np.int32),
                                      device="cpu")


def test_serving_pair_equals_reference_and_its_direct_composition(pair):
    (res, subs, placements, lows), (jres, jsubs, jpl, _) = pair
    assert list(res) == list(ARCHS)
    assert {a: p.describe() for a, p in placements.items()} == {
        a: p.describe() for a, p in jpl.items()}
    for arch, low in zip(ARCHS, lows):
        assert np.array_equal(res[arch], low.run_direct()), arch
        _close(res[arch], np.asarray(jres[arch]))
    assert [s.name for s in subs] == [s.name for s in jsubs]
    for sub, jsub in zip(subs, jsubs):
        assert sub.placement is not None and sub.lowering is None
        assert {k: v.tolist() for k, v in sub.stage_costs.items()} == {
            k: v.tolist() for k, v in jsub.stage_costs.items()}
