"""The port's device pipelines end to end against the JAX package's.

Both packages make their data with numpy from the same seed, so the port's
arrays must be bit-identical to the JAX lowering's; ``values_from_reference``
drives the port from the JAX arrays directly. Float sums are held to a
relative tolerance of 1e-5 (PyTorch and XLA sum a tile in different orders);
tables, top items and the solve inputs' shapes must match exactly.
"""

import numpy as np
import pytest
import torch

from repro.vee import apps as japps
from repro_torch.core import clear_dag_table_cache, dag_table_cache_stats
from repro_torch.kernels import dag_walk as twalk
from repro_torch.vee import apps as tapps

FLOAT_RTOL = 1e-5


def test_linear_regression_device_matches_jax_and_oracle():
    techs = {"moments": "GSS", "syrk_gemv": "FAC2"}
    jbeta, jvals, jddt = japps.linear_regression_device(512, 9, tile=64,
                                                        stage_techniques=techs)
    tbeta, tvals, tddt = tapps.linear_regression_device(512, 9, tile=64,
                                                        stage_techniques=techs,
                                                        device="cpu")
    assert np.array_equal(tddt.tables, jddt.tables)
    for k in ("moments", "syrk_gemv"):
        jv = np.asarray(jvals[k])
        np.testing.assert_allclose(tvals[k].numpy(), jv, rtol=FLOAT_RTOL,
                                   atol=FLOAT_RTOL * np.abs(jv).max())
    np.testing.assert_allclose(tbeta, jbeta, atol=1e-6)
    np.testing.assert_allclose(tbeta, tapps.linear_regression_oracle(512, 9), atol=1e-4)
    sw_beta, _, _ = tapps.linear_regression_device(512, 9, tile=64,
                                                   stage_techniques=techs,
                                                   stagewise=True, device="cpu")
    assert np.array_equal(sw_beta, tbeta)


@pytest.mark.parametrize("tech", ["STATIC", "MFSC", "TSS"])
def test_recommendation_device_matches_jax_and_oracle(tech):
    jtop, jvals, _ = japps.recommendation_device(256, 32, tile=32, stage_techniques=tech)
    ttop, tvals, _ = tapps.recommendation_device(256, 32, tile=32, stage_techniques=tech,
                                                 device="cpu")
    assert np.array_equal(ttop.numpy(), np.asarray(jtop))
    assert np.array_equal(ttop.numpy(), tapps.recommendation_oracle(256, 32))
    for k in ("item_norms", "user_bias"):
        np.testing.assert_allclose(tvals[k].numpy(), np.asarray(jvals[k]),
                                   rtol=FLOAT_RTOL)


def test_oracles_match_jax():
    assert np.array_equal(tapps.linear_regression_oracle(300, 7, seed=3),
                          japps.linear_regression_oracle(300, 7, seed=3))
    assert np.array_equal(tapps.recommendation_oracle(128, 16, seed=2),
                          japps.recommendation_oracle(128, 16, seed=2))


@pytest.mark.parametrize("which", ["linreg", "recommendation"])
def test_values_from_reference_bit_identical(which):
    if which == "linreg":
        jlow = japps.linreg_device_lowering(256, 7, tile=64, seed=4)
        tlow = tapps.linreg_device_lowering(256, 7, tile=64, seed=4, device="cpu")
    else:
        jlow = japps.recommendation_device_lowering(128, 16, tile=32, seed=5)
        tlow = tapps.recommendation_device_lowering(128, 16, tile=32, seed=5,
                                                    device="cpu")
    ref = tapps.values_from_reference(
        {k: np.asarray(v) for k, v in jlow.values.items()}, device="cpu")
    assert set(ref) == set(tlow.values)
    for k, v in ref.items():
        assert v.dtype == tlow.values[k].dtype and torch.equal(v, tlow.values[k]), k
    # the port walks the reference's arrays to the same result
    a, _ = tapps.run_device_dag(tlow, "GSS")
    tlow.values = ref
    b, _ = tapps.run_device_dag(tlow, "GSS")
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_host_ops_match_plain_walker():
    """Each host op over the whole tile range equals the plain walker."""
    low = tapps.linreg_device_lowering(256, 6, tile=64, device="cpu")
    walked, _ = tapps.run_device_dag(low)
    units = low.dag.stages["moments"].n_rows
    # ascending tile order from zero: the walker's fold, bit for bit
    mom = low.dag.stages["moments"].op({}, 0, units)
    assert torch.equal(mom, walked["moments"])
    syrk = low.dag.stages["syrk_gemv"].op({"moments": walked["moments"]}, 0, units)
    assert torch.equal(syrk, walked["syrk_gemv"])

    low = tapps.recommendation_device_lowering(128, 16, tile=32, device="cpu")
    walked, _ = tapps.run_device_dag(low)
    units = low.dag.stages["scores"].n_rows
    norms = low.dag.stages["item_norms"].op({}, 0, units)
    assert torch.equal(norms, walked["item_norms"])
    bias = low.dag.stages["user_bias"].op({}, 0, units)
    assert torch.equal(bias.reshape(-1), walked["user_bias"])
    scores = low.dag.stages["scores"].op(
        {"item_norms": walked["item_norms"], "user_bias": bias}, 0, units)
    assert torch.equal(scores.reshape(-1), walked["scores"])


def test_repeat_jobs_hit_both_caches():
    clear_dag_table_cache()
    twalk.clear_device_table_cache()
    low = tapps.recommendation_device_lowering(128, 16, tile=32, device="cpu")
    first, _ = tapps.run_device_dag(low, "GSS")
    second, _ = tapps.run_device_dag(low, "GSS")
    for k in first:
        assert torch.equal(first[k], second[k])
    assert dag_table_cache_stats()["hits"] == 1
    assert twalk.device_table_cache_stats() == {"hits": 1, "misses": 1, "size": 1}


def test_barrier_edges_require_one_shard():
    low = tapps.linreg_device_lowering(128, 5, device="cpu")
    with pytest.raises(ValueError, match="n_shards=1"):
        tapps.run_device_dag(low, n_shards=2)


def test_entry_points_default_to_cuda():
    import inspect

    for fn in (tapps.linear_regression_device, tapps.recommendation_device,
               tapps.linreg_device_lowering, tapps.recommendation_device_lowering):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_smoke_recommendation_tie_band_counts_near_ties_and_fails_a_wrong_sum():
    """``chip_smoke.py``'s recommendation agreement on a small oracle. The
    oracle's best is the numpy oracle's; the port's walk agrees; a pick
    whose float64 score lies within the tie band of the best counts, one
    twice the band below does not; and the scores on item norms that miss
    one 64-row tile (the control) fail ``REC_AGREEMENT``."""
    from test_torch_rwkv import chip_smoke

    smoke = chip_smoke()
    users, items = 8192, 256
    oracle = smoke.RecOracle(users, items, "cpu")
    assert np.array_equal(oracle.best.numpy(), tapps.recommendation_oracle(users, items))
    assert oracle.agreement(oracle.best) == (1.0, 1.0)

    low = tapps.recommendation_device_lowering(users, items, device="cpu")
    walked, _ = tapps.run_device_dag(low)
    assert oracle.agreement(walked["scores"])[0] >= smoke.REC_AGREEMENT

    pick = oracle.best.clone()
    near, far = torch.tensor([0]), torch.tensor([1])
    for u, factor in ((near, 0.5), (far, 2.0)):
        other = (oracle.best[u] + 1) % items
        pick[u] = other
        oracle.s[u, other] = oracle.s[u, oracle.best[u]] - factor * oracle.tie_band(u, other)
    assert oracle.agreement(pick) == (1.0 - 1 / users, 1.0 - 2 / users)

    oracle = smoke.RecOracle(users, items, "cpu")
    control = smoke.dropped_tile_scores(low.values["R"], walked["item_norms"],
                                        walked["user_bias"])
    assert oracle.agreement(control)[0] < smoke.REC_AGREEMENT
