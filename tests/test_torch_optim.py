"""The port's AdamW (``optim/adamw.py``): copies of the reference's
``tests/test_optim.py`` on the port, and the schedule and the int8
quantizer against the reference's functions.

Tolerances: ``lr_schedule`` bitwise in the warmup; after it, within what
one ulp of the cosine moves it by (XLA's and PyTorch's float32 ``cos``
round apart by one ulp) plus two ulps of the rate for the roundings after
the cosine (seen: two ulps); ``_quantize_int8`` bitwise
(the same float32 operations: add, max, divide, round half to even, clip,
multiply); the per-stacked-tensor scale bitwise the reference's on a
stacked leaf.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw as jadamw
from repro_torch.optim import AdamWConfig, apply_updates, init_opt_state, lr_schedule
from repro_torch.optim import adamw as tadamw


def _quadratic_losses(cfg, steps=200, compress=False):
    """Optimize ||W - target||^2; return the loss trajectory."""
    rng = np.random.default_rng(0)
    W = torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32) * 0.5)
    target = torch.from_numpy(np.random.default_rng(1).standard_normal((16, 16))
                              .astype(np.float32))
    params = {"w": W}
    ocfg = AdamWConfig(lr=5e-2, weight_decay=0.0, warmup_steps=10,
                       total_steps=steps, compress=compress)
    state = init_opt_state(params, ocfg)
    losses = []
    for _ in range(steps):
        w = params["w"].clone().requires_grad_(True)
        loss = torch.mean((w - target) ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        params, state, _ = apply_updates(params, {"w": g}, state, ocfg)
        losses.append(float(loss.detach()))
    return losses


def test_adamw_converges():
    losses = _quadratic_losses(AdamWConfig())
    assert losses[-1] < losses[0] * 0.01


def test_compressed_adamw_converges():
    """int8 error-feedback compression must not break convergence."""
    plain = _quadratic_losses(AdamWConfig(), compress=False)
    comp = _quadratic_losses(AdamWConfig(), compress=True)
    assert comp[-1] < comp[0] * 0.02
    assert comp[-1] < plain[0] * 0.05


def test_lr_schedule_shape():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=100, total_steps=1000, min_lr_ratio=0.1)
    assert float(lr_schedule(cfg, 0)) == 0.0
    assert abs(float(lr_schedule(cfg, 100)) - 1e-3) < 1e-9
    assert float(lr_schedule(cfg, 50)) == pytest.approx(5e-4)
    assert float(lr_schedule(cfg, 1000)) == pytest.approx(1e-4, rel=1e-3)


def test_grad_clipping():
    params = {"w": torch.ones(4)}
    cfg = AdamWConfig(clip_norm=1.0, lr=0.0, weight_decay=0.0)
    state = init_opt_state(params, cfg)
    _, _, m = apply_updates(params, {"w": torch.full((4,), 1e6)}, state, cfg)
    assert float(m["grad_norm"]) > 1e6  # reported pre-clip


def test_error_feedback_accumulates():
    """Tiny gradients below int8 resolution must not be silently lost."""
    params = {"w": torch.zeros(8)}
    cfg = AdamWConfig(lr=1e-2, weight_decay=0.0, compress=True, clip_norm=1e9,
                      warmup_steps=0)
    state = init_opt_state(params, cfg)
    g = {"w": torch.tensor([1.0] + [1e-4] * 7)}
    for _ in range(300):
        params, state, _ = apply_updates(params, g, state, cfg)
    assert abs(float(params["w"][3])) > 1e-4


def test_apply_updates_is_pure():
    """The arguments are left as they were (the reference's arrays are
    immutable; the port's tensors are not written in place)."""
    params = {"layers": [{"w": torch.ones(3)}, {"w": torch.full((3,), 2.0)}]}
    cfg = AdamWConfig(compress=True)
    state = init_opt_state(params, cfg)
    grads = {"layers": [{"w": torch.full((3,), 0.5)}, {"w": torch.full((3,), -0.25)}]}
    copies = [t.clone() for t in tadamw.tree_leaves([params, state, grads])]
    new_p, new_s, _ = apply_updates(params, grads, state, cfg)
    for a, b in zip(tadamw.tree_leaves([params, state, grads]), copies):
        assert torch.equal(a, b)
    assert int(new_s["step"]) == 1 and not torch.equal(new_p["layers"][0]["w"], torch.ones(3))


@pytest.mark.parametrize("kw", [dict(), dict(lr=1e-3, warmup_steps=7, total_steps=333,
                                              min_lr_ratio=0.05),
                                dict(warmup_steps=0, total_steps=50)])
def test_lr_schedule_matches_reference(kw):
    jcfg, tcfg = JAdamWConfig(**kw), AdamWConfig(**kw)
    steps = list(range(0, tcfg.total_steps + 20, max(1, tcfg.total_steps // 97)))
    for s in steps:
        want = np.float32(jadamw.lr_schedule(jcfg, jnp.int32(s)))
        got = np.float32(lr_schedule(tcfg, torch.tensor(s, dtype=torch.int32)))
        assert got.dtype == want.dtype
        if s < tcfg.warmup_steps:
            assert got == want, s
            continue
        prog = np.float32(min(max((s - tcfg.warmup_steps)
                                  / max(1, tcfg.total_steps - tcfg.warmup_steps), 0), 1))
        cos_ulp = np.spacing(np.abs(np.cos(np.float32(np.pi) * prog)))
        tol = 2 * np.spacing(np.abs(want)) + tcfg.lr * (1 - tcfg.min_lr_ratio) * 0.5 * cos_ulp
        assert abs(got - want) <= tol, (s, got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_int8_matches_reference(seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((64, 33)) * 10.0 ** rng.uniform(-6, 2)).astype(np.float32)
    err = (rng.standard_normal((64, 33)) * 1e-3).astype(np.float32)
    jdeq, jerr = jadamw._quantize_int8(jnp.asarray(g), jnp.asarray(err))
    tdeq, terr = tadamw._quantize_int8(torch.from_numpy(g), torch.from_numpy(err))
    assert np.array_equal(tdeq.numpy(), np.asarray(jdeq))
    assert np.array_equal(terr.numpy(), np.asarray(jerr))


def test_compressed_scale_is_the_stacked_tensors():
    """The port keeps a leaf per layer where the reference stacks them: one
    compressed step on two layers' leaves equals the reference's on the
    stacked leaf, bitwise (the int8 scale is the stacked tensor's)."""
    rng = np.random.default_rng(4)
    p = rng.standard_normal((2, 5, 3)).astype(np.float32)
    g = rng.standard_normal((2, 5, 3)).astype(np.float32) * np.array([1.0, 0.01],
                                                                     np.float32)[:, None, None]
    kw = dict(compress=True, clip_norm=1e9, warmup_steps=0)
    jcfg, tcfg = JAdamWConfig(**kw), AdamWConfig(**kw)
    jp = {"layers": {"w": jnp.asarray(p)}}
    jnew, jstate, _ = jadamw.apply_updates(jp, {"layers": {"w": jnp.asarray(g)}},
                                           jadamw.init_opt_state(jp, jcfg), jcfg)
    tp = {"layers": [{"w": torch.from_numpy(p[i])} for i in range(2)]}
    tg = {"layers": [{"w": torch.from_numpy(g[i])} for i in range(2)]}
    tnew, tstate, _ = apply_updates(tp, tg, init_opt_state(tp, tcfg), tcfg)
    for i in range(2):
        assert np.array_equal(tstate["err"]["layers"][i]["w"].numpy(),
                              np.asarray(jstate["err"]["layers"]["w"])[i])
        assert np.allclose(tnew["layers"][i]["w"].numpy(),
                           np.asarray(jnew["layers"]["w"])[i], rtol=0, atol=1e-6)
