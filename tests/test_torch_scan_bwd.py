"""The scans' gradients (K5' and K6') in plain PyTorch against the JAX
package's, on the CPU.

``ssm_scan_bwd_plain`` and ``rwkv6_scan_bwd_plain`` walk the recurrences of
the backward kernels (``csrc/ssm_scan_bwd.cu``, ``csrc/rwkv6_scan_bwd.cu``):
the reverse pass of the state's gradient, each chunk's terms and the
reverse cumsum of the decay's gradient. They are held to ``jax.vjp`` of the
reference's own functions (``repro.kernels.ref.ssm_scan_ref`` with D = 0;
``repro.models.rwkv._wkv_chunked``, the RWKV6 model's chunk recurrence,
with its final state) and to autograd through the port's forward plain
versions. Inputs are drawn with numpy from a seed; dh and N are 16.

Tolerances, with their reasons:

* float64 plain backward against float32 references: ``GRAD_TOL`` = 1e-4
  of each gradient's largest |entry|: the references' float32 sums and
  cumsums in another order (the differences seen were under 1e-6 of the
  largest at these sizes, 1e-5 under fast decay).
* fast decay (logw down to -30, where ``_wkv_chunked``'s own gradient
  overflows in its masked gate and gives NaN): the float32 plain backward
  is held to the float64 gradient of the sequential oracle within
  ``chip_smoke.py``'s K6' limit (``scan_bwd_limits``), and the same backward
  on bfloat16-rounded decays must fail it.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import rwkv as jrwkv
from repro_torch.kernels import _build
from repro_torch.kernels import ref as tref
from repro_torch.kernels.rwkv6_scan import (rwkv6_scan_bwd_plain, rwkv6_scan_plain,
                                            rwkv6_scan_plain_pair, rwkv6_scan_state)
from repro_torch.kernels.ssm_scan import (ssm_scan_bwd_plain, ssm_scan_plain,
                                          ssm_scan_plain_pair, ssm_scan_state)
from test_torch_train import one_thread  # noqa: F401  (autouse: one intra-op thread)

ROOT = Path(__file__).resolve().parents[1]
GRAD_TOL = 1e-4
PAIR_TOL = 0.05


def chip_smoke():
    """``chip_smoke.py`` as a module: its K5' and K6' limits."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _close(got: torch.Tensor, want, what: str, tol: float = GRAD_TOL) -> None:
    want = torch.as_tensor(np.array(want), dtype=torch.float64)
    got = got.double()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert bool(torch.isfinite(got).all()), what
    assert err <= tol * scale, f"{what}: max abs err {err:.3g} > {tol} x {scale:.3g}"


def ssm_inputs(seed: int, bt=2, s=32, h=3, dh=16, n=16):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(x=rng.standard_normal((bt, s, h, dh)).astype(f32),
                dt=np.log1p(np.exp(rng.standard_normal((bt, s, h)))).astype(f32) * f32(0.5),
                A=-np.exp(rng.standard_normal(h) * 0.5).astype(f32),
                B=rng.standard_normal((bt, s, n)).astype(f32),
                C=rng.standard_normal((bt, s, n)).astype(f32))


def rwkv6_inputs(seed: int, b=2, h=3, s=32, dh=16, fast: bool = False):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    r, k, v = (rng.standard_normal((b, h, s, dh)).astype(f32) for _ in range(3))
    if fast:   # the model's clamp: logw in [-30, 0], a share at -30 exactly
        logw = np.maximum(-np.exp(rng.standard_normal((b, h, s, dh)) * 4.0), -30.0)
    else:      # moderate decay: the masked gate of _wkv_chunked stays finite
        logw = -np.exp(rng.standard_normal((b, h, s, dh)) * 0.5 - 1.0)
    return dict(r=r, k=k, v=v, logw=logw.astype(f32),
                u=(rng.standard_normal((h, dh)) * 0.5).astype(f32))


def torch_of(inputs: dict) -> dict:
    return {n: torch.from_numpy(a) for n, a in inputs.items()}


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_ssm_bwd_plain_matches_reference_vjp(chunk):
    """dx, ddt, dA, dB, dC against ``jax.vjp`` of the reference's
    sequential SSD oracle (D = 0), whose y is the scan's."""
    inp = ssm_inputs(chunk)
    dy = np.random.default_rng(100 + chunk).standard_normal(inp["x"].shape).astype(np.float32)
    zero = jnp.zeros(inp["A"].shape, jnp.float32)
    _, vjp = jax.vjp(lambda x, dt, A, B, C: jref.ssm_scan_ref(x, dt, A, B, C, zero),
                     *(jnp.asarray(inp[n]) for n in ("x", "dt", "A", "B", "C")))
    want = vjp(jnp.asarray(dy))
    t = torch_of(inp)
    got = ssm_scan_bwd_plain(t["x"], t["dt"], t["A"], t["B"], t["C"], torch.from_numpy(dy),
                             None, chunk, dtype=torch.float64)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        _close(g, w, name)


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssm_bwd_plain_matches_autograd_with_state_gradient(chunk):
    """Against autograd through ``ssm_scan_plain``, y's and the final
    state's gradients both nonzero."""
    t = {n: a.requires_grad_(True) for n, a in torch_of(ssm_inputs(7 + chunk)).items()}
    args = [t[n] for n in ("x", "dt", "A", "B", "C")]
    y, state = ssm_scan_plain(*args, chunk)
    rng = np.random.default_rng(chunk)
    dy = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    dstate = torch.from_numpy(rng.standard_normal(state.shape).astype(np.float32))
    want = torch.autograd.grad((y, state), args, (dy, dstate))
    got = ssm_scan_bwd_plain(*(a.detach() for a in args), dy, dstate, chunk,
                             dtype=torch.float64)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        _close(g, w.numpy(), name)


@pytest.mark.parametrize("chunk,state_grad", [(8, False), (16, True), (32, True)])
def test_rwkv6_bwd_plain_matches_reference_vjp(chunk, state_grad):
    """dr, dk, dv, dlogw, du against ``jax.vjp`` of the model's
    ``_wkv_chunked`` (its y and final state), the final state's gradient
    nonzero where ``state_grad``."""
    inp = rwkv6_inputs(chunk)
    rng = np.random.default_rng(200 + chunk)
    dy = rng.standard_normal(inp["r"].shape).astype(np.float32)
    b, h, s, dh = inp["r"].shape
    dstate = (rng.standard_normal((b, h, dh, dh)) if state_grad
              else np.zeros((b, h, dh, dh))).astype(np.float32)
    _, vjp = jax.vjp(lambda r, k, v, logw, u: jrwkv._wkv_chunked(r, k, v, logw, u, chunk),
                     *(jnp.asarray(inp[n]) for n in ("r", "k", "v", "logw", "u")))
    want = vjp((jnp.asarray(dy), jnp.asarray(dstate)))
    t = torch_of(inp)
    got = rwkv6_scan_bwd_plain(*(t[n] for n in ("r", "k", "v", "logw", "u")),
                               torch.from_numpy(dy),
                               torch.from_numpy(dstate) if state_grad else None, chunk,
                               dtype=torch.float64)
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du"), got, want):
        _close(g, w, name)


def test_rwkv6_bwd_plain_matches_autograd():
    """Against autograd through ``rwkv6_scan_plain`` (moderate decay: its
    masked gate stays finite), both output gradients nonzero."""
    t = {n: a.requires_grad_(True) for n, a in torch_of(rwkv6_inputs(3)).items()}
    args = [t[n] for n in ("r", "k", "v", "logw", "u")]
    y, state = rwkv6_scan_plain(*args, 16)
    rng = np.random.default_rng(3)
    dy = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    dstate = torch.from_numpy(rng.standard_normal(state.shape).astype(np.float32))
    want = torch.autograd.grad((y, state), args, (dy, dstate))
    got = rwkv6_scan_bwd_plain(*(a.detach() for a in args), dy, dstate, 16,
                               dtype=torch.float64)
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du"), got, want):
        _close(g, w.numpy(), name)


@pytest.mark.parametrize("chunk", [16, 64])
def test_rwkv6_bwd_plain_fast_decay_within_the_smokes_limit(chunk):
    """Fast decay, logw down to -30 a step: the float32 plain backward
    stays finite and within ``scan_bwd_limits`` of the float64 gradient of
    the sequential oracle (``kernels/ref.py:rwkv6_scan_ref``, which never
    forms a gate); the limit's own float64 gradient agrees with that
    oracle's to 1e-9 of its largest; the same backward on bfloat16-rounded
    decays fails the limit."""
    smoke = chip_smoke()
    t = torch_of(rwkv6_inputs(11, s=64, fast=True))
    args64 = [t[n].double().requires_grad_(True) for n in ("r", "k", "v", "logw", "u")]
    y, state = tref.rwkv6_scan_ref(*args64, dtype=torch.float64, return_state=True)
    rng = np.random.default_rng(chunk)
    dy = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    dstate = torch.from_numpy(rng.standard_normal(state.shape).astype(np.float32))
    oracle = torch.autograd.grad((y, state), args64, (dy.double(), dstate.double()))
    limits = smoke.scan_bwd_limits("rwkv6", t, dy, dstate, chunk)
    args = [t[n] for n in ("r", "k", "v", "logw", "u")]
    got = rwkv6_scan_bwd_plain(*args, dy, dstate, chunk)
    rounded = list(args)
    rounded[3] = args[3].bfloat16().float()
    control = rwkv6_scan_bwd_plain(*rounded, dy, dstate, chunk)
    control_beyond = 0
    for name, g, o, c in zip(("dr", "dk", "dv", "dlogw", "du"), got, oracle, control):
        exact, lim, _ = limits[name]
        assert bool(torch.isfinite(g).all()), name
        assert float((exact - o).abs().max()) <= 1e-9 * float(o.abs().max()), name
        bad, err, share = smoke.beyond(g, exact, lim)
        assert bad == 0, f"{name}: {bad} entries beyond the limit, max abs err {err:.3g}"
        control_beyond += smoke.beyond(c, exact, lim)[0]
    assert control_beyond > 0


def test_ssm_bwd_plain_within_the_smokes_limit():
    """The float32 plain K5' within ``scan_bwd_limits`` of its float64 run,
    the magnitudes bounding every exact entry, and the backward on
    bfloat16-rounded dt beyond the limit."""
    smoke = chip_smoke()
    t = torch_of(ssm_inputs(5, s=64))
    rng = np.random.default_rng(5)
    dy = torch.from_numpy(rng.standard_normal(t["x"].shape).astype(np.float32))
    dstate = torch.from_numpy(rng.standard_normal((2, 3, 16, 16)).astype(np.float32))
    limits = smoke.scan_bwd_limits("ssm", t, dy, dstate, 32)
    args = [t[n] for n in ("x", "dt", "A", "B", "C")]
    got = ssm_scan_bwd_plain(*args, dy, dstate, 32)
    terms = ssm_scan_bwd_plain(*args, dy, dstate, 32, dtype=torch.float64, magnitude=True)
    rounded = list(args)
    rounded[1] = args[1].bfloat16().float()
    control = ssm_scan_bwd_plain(*rounded, dy, dstate, 32)
    control_beyond = 0
    for name, g, tm, c in zip(("dx", "ddt", "dA", "dB", "dC"), got, terms, control):
        exact, lim, _ = limits[name]
        assert bool((exact.abs() <= tm * (1 + 1e-12)).all()), name
        assert smoke.beyond(g, exact, lim)[0] == 0, name
        control_beyond += smoke.beyond(c, exact, lim)[0]
    assert control_beyond > 0


def test_plain_pairs_route_through_the_functions():
    """On the CPU the wrappers run the plain forward under autograd; the
    plain pairs go through ``_SsmScan`` / ``_Rwkv6Scan`` where a gradient is
    needed, their gradients the plain backward's, and are the plain
    forward, bitwise, where none is. No kernel is launched."""
    before = {k.source.name: dict(k.launches) for k in _build.KERNELS}
    cases = [
        (ssm_scan_state, ssm_scan_plain_pair, ssm_scan_plain, ssm_scan_bwd_plain,
         [torch_of(ssm_inputs(9))[n] for n in ("x", "dt", "A", "B", "C")], "_SsmScan"),
        (rwkv6_scan_state, rwkv6_scan_plain_pair, rwkv6_scan_plain, rwkv6_scan_bwd_plain,
         [torch_of(rwkv6_inputs(9))[n] for n in ("r", "k", "v", "logw", "u")], "_Rwkv6Scan"),
    ]
    for wrapper, pair, plain, bwd, args, fn_name in cases:
        with torch.no_grad():
            for got, want in zip(pair(*args, chunk=16), plain(*args, chunk=16)):
                assert torch.equal(got, want)
        leaves = [a.clone().requires_grad_(True) for a in args]
        y, state = pair(*leaves, chunk=16)
        assert type(y.grad_fn).__name__.startswith(fn_name)
        assert not type(wrapper(*leaves, chunk=16)[0].grad_fn).__name__.startswith(fn_name)
        rng = np.random.default_rng(1)
        dy = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
        grads = torch.autograd.grad(y, leaves, dy)
        for g, w in zip(grads, bwd(*args, dy, None, 16)):
            assert torch.equal(g, w)
        y_w, _ = wrapper(*leaves, chunk=16)
        for g, w in zip(grads, torch.autograd.grad(y_w, leaves, dy)):
            _close(g, w.numpy(), fn_name)
    assert before == {k.source.name: dict(k.launches) for k in _build.KERNELS}


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-3b"])
def test_reduced_train_gradients_through_the_plain_pairs(arch):
    """A reduced model's train loss and gradients with its scan patched to
    the plain pair (the Function a train step on the card takes, with the
    plain versions in the kernels' places) against autograd through the
    plain forward: strided head views and bfloat16 activations go through
    the Function as the card's step sends them."""
    import dataclasses
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models import rwkv as trwkv
    from repro_torch.models import ssm as tssm
    from repro_torch.runtime import loss_and_grads

    cfg = get_config(arch).reduced()
    if cfg.ssm is not None:
        cfg = dataclasses.replace(cfg, n_layers=3, ssm=dataclasses.replace(cfg.ssm, attn_every=2))
    model = Model(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init_params(gen)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 33), dtype=np.int32))
    loss_a, _, g_a = loss_and_grads(model, params, {"tokens": toks})
    module, name, pair = ((tssm, "ssm_scan_state", ssm_scan_plain_pair) if cfg.ssm is not None
                          else (trwkv, "rwkv6_scan_state", rwkv6_scan_plain_pair))
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return pair(*a, **kw)

    with mock.patch.object(module, name, counted):
        loss_p, _, g_p = loss_and_grads(model, params, {"tokens": toks})
    assert calls and float(loss_p) == float(loss_a)
    smoke = chip_smoke()
    shares = smoke.grad_shares(g_p, g_a)
    assert max(shares.values()) <= PAIR_TOL / smoke.TRAIN_GRAD_TOL, \
        max(shares.items(), key=lambda kv: kv[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_float64_pair_is_the_float64_oracle_and_its_gradient(dtype):
    """``chip_smoke.py:rwkv6_float64_pair``, the truth RWKV6's first-step
    check reads its steps against: y and the final state are the
    sequential oracle's in float64 rounded to float32 (bitwise), and its
    gradient, the state's gradient nonzero, is autograd's through that
    oracle in float64 rounded to the inputs' dtypes: float64 sums in two
    orders, each rounded once, so an entry may differ by one unit of its
    dtype's last place (plus 1e-9 of the gradient's largest |entry|)."""
    smoke = chip_smoke()
    t = torch_of(rwkv6_inputs(21))
    names = ("r", "k", "v", "logw", "u")
    ins = [(t[n].to(dtype) if n in "rkv" else t[n]).requires_grad_() for n in names]
    y, state = smoke.rwkv6_float64_pair(*ins, chunk=8)
    y64, state64 = tref.rwkv6_scan_ref(*(x.detach() for x in ins), dtype=torch.float64,
                                       return_state=True)
    assert torch.equal(y, y64.float()) and torch.equal(state, state64.float())
    rng = np.random.default_rng(22)
    dy, ds = (torch.from_numpy(rng.standard_normal(a.shape).astype(np.float32))
              for a in (y, state))
    got = torch.autograd.grad((y * dy).sum() + (state * ds).sum(), ins)
    leaves = [x.detach().double().requires_grad_() for x in ins]
    y64, state64 = tref.rwkv6_scan_ref(*leaves, dtype=torch.float64, return_state=True)
    want = torch.autograd.grad((y64 * dy.double()).sum() + (state64 * ds.double()).sum(),
                               leaves)
    for name, g, w, x in zip(names, got, want, ins):
        assert g.dtype == x.dtype, name
        lim = torch.finfo(x.dtype).eps * w.abs() + 1e-9 * float(w.abs().max())
        bad = int(((g.double() - w.to(x.dtype).double()).abs() > lim).sum())
        assert bad == 0, (name, bad)


# ---------------------------------------------------------------------------
# the train step in place, and the launcher's resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["rwkv6-3b", "qwen2-0.5b"])
def test_train_step_in_place_is_bitwise_the_pure_step(arch):
    """``build_train_step(in_place=True)`` gives the pure step's params,
    moments and metrics bitwise, two steps running, and writes them over
    the state it is given."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import build_train_step, init_train_state

    smoke = chip_smoke()
    model = Model(get_config(arch).reduced())
    gen = torch.Generator()
    gen.manual_seed(0)
    cfg = AdamWConfig(warmup_steps=1)
    pure = init_train_state(model, gen, cfg)
    mine = type(pure)(params=_clone(pure.params), opt=_clone(pure.opt),
                      step=pure.step.clone())
    rng = np.random.default_rng(4)
    pure_step = build_train_step(model, cfg)
    mine_step = build_train_step(model, cfg, in_place=True)
    for _ in range(2):
        toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (2, 33), dtype=np.int32))
        given = smoke.tree_paths(mine.params)
        pure, m_pure = pure_step(pure, {"tokens": toks})
        mine, m_mine = mine_step(mine, {"tokens": toks})
        assert all(smoke.tree_paths(mine.params)[p] is t for p, t in given.items())
        for p, t in smoke.tree_paths(pure.params).items():
            assert torch.equal(smoke.tree_paths(mine.params)[p], t), p
        for p, t in smoke.tree_paths(pure.opt).items():
            assert torch.equal(smoke.tree_paths(mine.opt)[p], t), p
        assert {k: float(v) for k, v in m_pure.items()} == {k: float(v) for k, v in m_mine.items()}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


@pytest.mark.parametrize("fault_leaf", ["first", "later"])
def test_in_place_step_is_not_retried_once_it_has_written(fault_leaf, monkeypatch):
    """A fault injected into AdamW's per-leaf body of an in-place step
    under ``run_loop``: at the first leaf, before anything is written, the
    step is retried and the state comes out bitwise a run without the
    fault; at a later leaf, after earlier leaves were written, it raises
    ``PartialUpdateError`` at once (a retry would apply their update
    twice), chained from the fault."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, PartialUpdateError, tree_leaves
    from repro_torch.runtime import build_train_step, init_train_state
    from repro_torch.runtime import steps as tsteps
    from repro_torch.runtime.fault import FaultConfig, run_loop

    smoke = chip_smoke()
    model = Model(get_config("qwen2-0.5b").reduced())
    gen = torch.Generator()
    gen.manual_seed(0)
    cfg = AdamWConfig(warmup_steps=1)
    clean = init_train_state(model, gen, cfg)
    faulted = type(clean)(params=_clone(clean.params), opt=_clone(clean.opt),
                          step=clean.step.clone())
    rng = np.random.default_rng(5)
    batches = [{"tokens": torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (2, 33),
                                                        dtype=np.int32))} for _ in range(2)]
    config = FaultConfig(max_retries=3, async_checkpoint=False)
    clean, _ = run_loop(build_train_step(model, cfg, in_place=True), clean, batches,
                        config=config)

    # the fault: torch.sqrt of AdamW's nhat for one leaf, once, in the first step
    shapes = [tuple(t.shape) for t in tree_leaves(faulted.params)]
    at = 0 if fault_leaf == "first" else next(i for i in range(1, len(shapes))
                                              if shapes[i] not in shapes[:i])
    armed, left, attempts = [False], [1], []
    real_sqrt, real_apply = torch.sqrt, tsteps.apply_updates

    def sqrt(t, *a, **kw):
        if armed[0] and left[0] and tuple(t.shape) == shapes[at]:
            left[0] -= 1
            raise RuntimeError("injected fault")
        return real_sqrt(t, *a, **kw)

    def apply(*a, **kw):
        attempts.append(1)
        armed[0] = True
        try:
            return real_apply(*a, **kw)
        finally:
            armed[0] = False

    monkeypatch.setattr(torch, "sqrt", sqrt)
    monkeypatch.setattr(tsteps, "apply_updates", apply)
    step = build_train_step(model, cfg, in_place=True)
    if fault_leaf == "first":
        faulted, report = run_loop(step, faulted, batches, config=config)
        assert report.retries == 1 and len(attempts) == 3 and not left[0]
        for tree in ("params", "opt"):
            want = smoke.tree_paths(getattr(clean, tree))
            got = smoke.tree_paths(getattr(faulted, tree))
            assert set(got) == set(want)
            for p, t in want.items():
                assert torch.equal(got[p], t), (tree, p)
    else:
        with pytest.raises(PartialUpdateError) as raised:
            run_loop(step, faulted, batches, config=config)
        assert len(attempts) == 1 and not left[0]
        assert str(raised.value.__cause__) == "injected fault"


def test_launcher_resume_draws_no_state(tmp_path, monkeypatch):
    """``launch.train.main`` resuming from a checkpoint restores its state
    and draws none (so one state is held on the device); a fresh run draws
    one. The resumed run goes on from the checkpoint's step."""
    from repro_torch.launch import train as ttrain
    from repro_torch.runtime import steps as tsteps

    drawn = []
    draw = tsteps.init_train_state

    def counted(*a, **kw):
        drawn.append(1)
        return draw(*a, **kw)

    monkeypatch.setattr(tsteps, "init_train_state", counted)
    monkeypatch.setattr("repro_torch.runtime.init_train_state", counted)
    argv = ["--smoke", "--device", "cpu", "--arch", "rwkv6-3b", "--seq", "32",
            "--global-batch", "2", "--ckpt-dir", str(tmp_path), "--checkpoint-every", "2"]
    first = ttrain.main(argv + ["--steps", "2"])
    assert len(drawn) == 1 and first.report.resumed_from is None
    resumed = ttrain.main(argv + ["--steps", "1"])
    assert len(drawn) == 1 and resumed.report.resumed_from == 1
    assert resumed.report.steps_run == 1 and np.isfinite(resumed.metrics[0]["loss"])


# ---------------------------------------------------------------------------
# the import guard and the sources
# ---------------------------------------------------------------------------

_GUARD = """
import sys
import torch
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_bwd_plain, rwkv6_scan_plain_pair
from repro_torch.kernels.ssm_scan import ssm_scan_bwd_plain, ssm_scan_plain_pair
x = torch.ones(1, 8, 2, 16, requires_grad=True)
y, s = ssm_scan_plain_pair(x, torch.ones(1, 8, 2), -torch.ones(2), x[:, :, 0].detach(),
                           x[:, :, 0].detach(), chunk=4)
y.sum().backward()
assert x.grad.shape == x.shape
assert len(ssm_scan_bwd_plain(x.detach(), torch.ones(1, 8, 2), -torch.ones(2),
                              x[:, :, 0].detach(), x[:, :, 0].detach(), y.detach())) == 5
r = torch.ones(1, 2, 8, 16, requires_grad=True)
y, s = rwkv6_scan_plain_pair(r, r.detach(), r.detach(), -torch.ones(1, 2, 8, 16),
                             torch.ones(2, 16), chunk=4)
y.sum().backward()
assert r.grad.shape == r.shape
assert len(rwkv6_scan_bwd_plain(r.detach(), r.detach(), r.detach(), -torch.ones(1, 2, 8, 16),
                                torch.ones(2, 16), y.detach())) == 5
import repro_torch.kernels._build as b
assert {k.source.name for k in b.KERNELS} >= {"ssm_scan_bwd.cu", "rwkv6_scan_bwd.cu"}
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not bad, bad
print("ok")
"""


def test_scan_gradients_import_and_run_without_jax_or_repro():
    """The scans' gradients (plain versions, pairs, the kernels' build
    entries) import and run with no jax and nothing of ``repro``."""
    import os
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-c", _GUARD], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("source", ["ssm_scan_bwd.cu", "rwkv6_scan_bwd.cu"])
def test_scan_bwd_sources_call_no_library(source):
    """K5' and K6' are written by hand: their sources name no library, and
    no atomic operation (two calls give the same bits)."""
    import re

    src = (ROOT / "src" / "repro_torch" / "csrc" / source).read_text()
    for word in ("cudnn", "cublas", "cutlass", "torch", "triton"):
        assert word not in src.lower(), word
    assert not re.search(r"atomic[A-Z]\w*\s*\(|\batom\.|\bred\.", src)
