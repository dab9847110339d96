"""The port's training (``Model.train_loss``, ``runtime/steps.py``) against
the JAX package's ``jax.value_and_grad(Model.train_loss)`` and jitted train
step, and the dense decoder's end to end.

Weights are the reference's own (``Model.init_params``, jax key 0), carried
across by ``model_params_from_reference``; token matrices are numpy draws
from a seed. ``tests/test_torch_train_moe.py`` and
``tests/test_torch_train_recurrent.py`` run the other families through the
helpers here.

Tolerances, per gradient leaf, against the largest magnitude of the
reference's gradient of that leaf (``assert_grads_close``):

* bfloat16 activations, the models' own (``GRAD_TOL`` = 8%): twice the
  forward's ``MODEL_TOL``. A gradient passes through the forward's
  roundings and as many again in the backward's bf16 products, each of
  which XLA and PyTorch may round a step apart. Seen: under 3% (dense),
  5% (Zamba2's tail). The k bias's exact gradient is 0 (softmax is
  invariant to a shift shared by a query's keys), so both stacks give
  rounding there: it is held to the scale of its layer's ``wk`` gradient.
* RWKV6 in bfloat16 (``RWKV_GRAD_TOL`` = 25%): the reduced RWKV6's
  gradients are steep (its embedding gradient's largest entry is 193
  where the dense decoder's is 0.14), so a bf16 step moves them further;
  seen 19%. Its float32 run below holds the arithmetic to 1e-3.
* float32 activations (``F32_GRAD_TOL`` = 1e-3, the test-only views
  ``_J32`` / ``_T32``): the same function with no bf16 rounding, where the
  stacks differ only in the order of fp32 sums (seen: 1e-4 for RWKV6,
  1e-5 elsewhere).
* The loss within 1e-3 of its value in bfloat16 (seen 1.4e-4), 1e-5 in
  float32.

The port's gradients under remat "dots" are bitwise its gradients under
"full": the recompute repeats the same operations on the same inputs.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as jblocks
from repro.models import moe as jmoe
from repro.optim import AdamWConfig as JAdamWConfig
from repro.runtime.steps import TrainState as JTrainState
from repro.runtime.steps import build_train_step as jbuild_train_step
from repro.optim import init_opt_state as jinit_opt_state
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as tattention
from repro_torch.models import model_params_from_reference
from repro_torch.models import moe as tmoe
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.runtime import TrainState, build_train_step, loss_and_grads
from test_torch_models import _models
from test_torch_rwkv import _J32, _T32, chip_smoke

GRAD_TOL = 0.08
RWKV_GRAD_TOL = 0.25
F32_GRAD_TOL = 1e-3
LOSS_RTOL = {torch.bfloat16: 1e-3, torch.float32: 1e-5}
SMOKE = chip_smoke()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: these tests run many small ops,
    which gain nothing from torch's thread pool alone (44 s against 48 on
    8 cores) and lose to oversubscription under the suite's 6 workers.
    The other train test files take it too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# helpers (the other train test files import them)
# ---------------------------------------------------------------------------

def pair(arch: str, dtype=torch.bfloat16, remat_policy: str = "full"):
    """The reference and port models of ``arch``'s reduced config, with
    float32 activations (``_J32`` / ``_T32``) when ``dtype`` is float32,
    and the reference's weights on both."""
    jm, jp, tm, tp = _models(arch)
    cfg_j = dataclasses.replace(jm.cfg, remat_policy=remat_policy)
    cfg_t = dataclasses.replace(tm.cfg, remat_policy=remat_policy)
    if dtype == torch.float32:
        return _J32(cfg_j), jp, _T32(cfg_t), tp
    return type(jm)(cfg_j), jp, type(tm)(cfg_t), tp


def tokens(cfg, seq: int, batch: int | None = None, seed: int = 1) -> np.ndarray:
    """A seeded token matrix ``(batch, seq + 1)``: by default two rows, one
    over 1,024 tokens (the chunked impl), to keep the suite's time."""
    batch = batch or (1 if seq > 1024 else 2)
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq + 1),
                                                dtype=np.int32)


def _moe_layers(params) -> list:
    return [lp for lp in params.get("layers", []) if isinstance(lp, dict) and "moe" in lp]


def reference_routing(jm, jp, toks) -> list[dict]:
    """Each MoE layer's routing in the reference's jitted ``train_loss``
    forward: its router input ``x`` (float32 copy), float32 ``logits``,
    ``idx`` and ``router``, in layer order (``routing_flips``' ``ref``)."""
    calls = []
    route = jmoe._route

    def logged(router_w, x_flat, moe):
        out = route(router_w, x_flat, moe)
        logits = (x_flat @ router_w.astype(x_flat.dtype)).astype(jnp.float32)
        jax.debug.callback(lambda *a: calls.append([np.array(t) for t in a]),
                           x_flat.astype(jnp.float32), logits, out[0], router_w,
                           ordered=True)
        return out

    with mock.patch.object(jmoe, "_route", logged):
        jax.jit(jm.train_loss)(jp, {"tokens": jnp.asarray(toks)})
    jax.effects_barrier()
    return [dict(x=x, logits=lg, idx=idx, router=r) for x, lg, idx, r in calls]


def reference_value_and_grad(jm, jp, toks, forced: list | None = None):
    """``jax.value_and_grad(train_loss, has_aux=True)`` under ``jit``: (loss,
    aux dict, grads as numpy). ``forced``: each MoE layer's expert indices,
    which the layers take in place of their own top-k (the weights are
    their router's probabilities at those experts, renormalised)."""
    batch = {"tokens": jnp.asarray(toks)}
    if forced is None:
        fn = lambda p: jm.train_loss(p, batch)  # noqa: E731
        (loss, aux), g = jax.jit(jax.value_and_grad(fn, has_aux=True))(jp)
        return float(loss), {k: float(v) for k, v in aux.items()}, jax.tree.map(np.asarray, g)
    stacked = jnp.asarray(np.stack(forced))
    block, route = jmoe.moe_block, jmoe._route

    def forced_block(p, x, cfg):
        idx = p["forced_idx"]
        p = {k: v for k, v in p.items() if k != "forced_idx"}

        def forced_route(router_w, x_flat, moe):
            _, _, probs = route(router_w, x_flat, moe)
            w = jnp.take_along_axis(probs, idx, axis=1)
            return idx, w / jnp.maximum(w.sum(-1, keepdims=True), 1e-9), probs

        with mock.patch.object(jmoe, "_route", forced_route):
            return block(p, x, cfg)

    def fn(params):
        layers = {**params["layers"], "moe": {**params["layers"]["moe"],
                                              "forced_idx": stacked}}
        return jm.train_loss({**params, "layers": layers}, batch)

    with mock.patch.object(jblocks, "moe_block", forced_block):
        (loss, aux), g = jax.jit(jax.value_and_grad(fn, has_aux=True))(jp)
    return float(loss), {k: float(v) for k, v in aux.items()}, jax.tree.map(np.asarray, g)


def port_routing(tm, tp, toks) -> list:
    """The port's ``route_log`` entries of one ``train_loss`` forward (no
    gradient, so no recompute): one per MoE layer, in layer order."""
    with SMOKE.route_log() as calls, torch.no_grad():
        tm.train_loss(tp, {"tokens": torch.from_numpy(toks)})
    return list(calls)


def port_value_and_grad(tm, tp, toks, forced: list | None = None):
    """``loss_and_grads`` of the port: (loss, aux dict, grads). ``forced``
    as ``reference_value_and_grad``'s; the forward and its recompute find
    a layer's indices by its router's storage."""
    batch = {"tokens": torch.from_numpy(toks)}
    if forced is None:
        loss, metrics, grads = loss_and_grads(tm, tp, batch)
    else:
        by_router = {lp["moe"]["router"].data_ptr(): torch.from_numpy(np.asarray(i)).long()
                     for lp, i in zip(_moe_layers(tp), forced, strict=True)}
        route = tmoe._route

        def forced_route(router_w, x_flat, moe):
            _, _, probs = route(router_w, x_flat, moe)
            idx = by_router[router_w.data_ptr()]
            w = probs.gather(1, idx)
            return idx, w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), probs

        with mock.patch.object(tmoe, "_route", forced_route):
            loss, metrics, grads = loss_and_grads(tm, tp, batch)
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def _leaf_pairs(got, want, path=()):
    if isinstance(got, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in got:
            yield from _leaf_pairs(got[k], want[k], path + (k,))
    elif isinstance(got, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            yield from _leaf_pairs(g, w, path + (str(i),))
    else:
        yield "/".join(path), got, want


def stacked_scale(leaves: dict, path: str) -> float:
    """``chip_smoke.leaf_scale`` over the reference's stacked leaf: the
    largest over every layer's leaf of ``path``'s name (indices dropped)."""
    name = [k for k in path.split("/") if not k.isdigit()]
    return max(SMOKE.leaf_scale(leaves, p) for p in leaves
               if [k for k in p.split("/") if not k.isdigit()] == name)


def grad_errors(got, ref_np) -> dict:
    """Per leaf path: (largest |got - want|, the scale it is held to): the
    leaf's largest |want|, or for a k bias its layer's ``wk`` gradient's."""
    want = model_params_from_reference(ref_np, "cpu")
    pairs = {p: (g.detach().float(), w.float()) for p, g, w in _leaf_pairs(got, want)}
    refs = {p: w for p, (_, w) in pairs.items()}
    out = {}
    for p, (g, w) in pairs.items():
        assert g.shape == w.shape, (p, g.shape, w.shape)
        out[p] = (float((g - w).abs().max()), SMOKE.leaf_scale(refs, p))
    return out


def assert_grads_close(got, ref_np, tol: float) -> dict:
    """Every leaf within ``tol`` of its scale (``grad_errors``); returns the
    worst share of ``tol`` per leaf."""
    errs = grad_errors(got, ref_np)
    bad = {p: (e, s) for p, (e, s) in errs.items() if not e <= tol * s}
    assert not bad, bad
    return {p: e / (tol * s) if s else 0.0 for p, (e, s) in errs.items()}


def check_family(arch: str, seq: int, dtype, tol: float, dots: bool = True) -> dict:
    """``train_loss`` and its gradients against the reference's; in an MoE
    family both stacks first route as the reference's jitted forward routes,
    after the port's own routing is held to it: in bfloat16 by
    ``routing_flips`` (a difference only on a near tie, at most
    ``FLIP_SHARE`` of the positions a layer), in float32 bitwise. With
    ``dots``, the port's gradients under remat "dots" are bitwise those
    under "full". Returns the flips per MoE layer."""
    from test_torch_moe_layer import LeftOut, routing_flips

    jm, jp, tm, tp = pair(arch, dtype)
    toks = tokens(tm.cfg, seq)
    forced, flips = None, {}
    if tm.cfg.moe is not None:
        ref_routes = reference_routing(jm, jp, toks)
        calls = port_routing(tm, tp, toks)
        assert len(ref_routes) == len(calls) == len(_moe_layers(tp))
        if dtype == torch.float32:  # no bf16 rounding to flip a near tie
            for i, (ref, call) in enumerate(zip(ref_routes, calls)):
                assert np.array_equal(ref["idx"], call[1].numpy()), f"layer {i}"
        else:
            left_out = LeftOut()
            for i, (ref, call) in enumerate(zip(ref_routes, calls)):
                left_out.add(i, routing_flips(ref, call, tm.cfg.moe, f"layer {i}").all)
            flips = left_out.check(toks.shape[0] * seq)
        forced = [r["idx"] for r in ref_routes]
    jl, jaux, jg = reference_value_and_grad(jm, jp, toks, forced)
    tl, taux, tg = port_value_and_grad(tm, tp, toks, forced)
    assert abs(tl - jl) <= LOSS_RTOL[dtype] * abs(jl), (tl, jl)
    assert abs(taux["aux"] - jaux["aux"]) <= LOSS_RTOL[dtype] * max(abs(jaux["aux"]), 1e-6)
    assert_grads_close(tg, jg, tol)
    if dots:
        _, _, tm_dots, _ = pair(arch, dtype, remat_policy="dots")
        _, _, dg = port_value_and_grad(tm_dots, tp, toks, forced)
        for p, g, d in _leaf_pairs(tg, dg):
            assert torch.equal(g, d), p
    return flips


# ---------------------------------------------------------------------------
# the dense decoder
# ---------------------------------------------------------------------------

DENSE = "qwen2-0.5b"


@pytest.mark.parametrize("seq,dtype", [(32, torch.bfloat16), (1088, torch.bfloat16),
                                       (32, torch.float32)])
def test_dense_train_loss_and_grads_match_reference(seq, dtype):
    """32 tokens take the full impl, 1,088 the chunked one (K4's plain
    version, differentiated by autograd on the CPU)."""
    check_family(DENSE, seq, dtype, GRAD_TOL if dtype == torch.bfloat16 else F32_GRAD_TOL)


@pytest.mark.parametrize("seq", [32, 1088])
def test_detached_attention_fails_the_gradient_check(seq):
    """The control: the port with its attention output detached (K4's plain
    version at 1,088 tokens, the full impl at 32) gives the loss but no
    gradient to q, k and v, and the gradient check catches it."""
    jm, jp, tm, tp = pair(DENSE)
    toks = tokens(tm.cfg, seq)
    _, _, jg = reference_value_and_grad(jm, jp, toks)
    name = "flash_attention" if seq > 1024 else "full_attention"
    fn = getattr(tattention, name)
    with mock.patch.object(tattention, name, lambda *a, **k: fn(*a, **k).detach()):
        _, _, tg = port_value_and_grad(tm, tp, toks)
    errs = grad_errors(tg, jg)
    assert all(errs[f"layers/{i}/attn/wq"][0] == errs[f"layers/{i}/attn/wq"][1]
               for i in range(tm.cfg.n_layers))
    with pytest.raises(AssertionError):
        assert_grads_close(tg, jg, GRAD_TOL)


def test_train_loss_metrics_and_plain_pair_on_the_cpu():
    """``train_loss`` returns ``(ce + aux, {'ce', 'aux'})``; K4's plain pair
    (the card's yardstick) on the CPU gives autograd's gradients of the
    plain forward within float32 rounding."""
    _, _, tm, tp = pair(DENSE, torch.float32)
    toks = tokens(tm.cfg, 1088)
    loss, metrics, grads = loss_and_grads(tm, tp, {"tokens": torch.from_numpy(toks)})
    assert float(loss) == float(metrics["ce"] + metrics["aux"])
    with mock.patch.object(tattention, "flash_attention", tfa.flash_attention_plain_pair):
        loss2, _, grads2 = loss_and_grads(tm, tp, {"tokens": torch.from_numpy(toks)})
    assert float(loss2) == float(loss)
    for p, g, h in _leaf_pairs(grads, grads2):
        scale = float(g.abs().max())
        assert float((g - h).abs().max()) <= 1e-4 * scale, p


# ---------------------------------------------------------------------------
# one train step against the reference's jitted step
# ---------------------------------------------------------------------------

def _step_pair(n_micro: int, compress: bool):
    jm, jp, tm, tp = pair(DENSE, torch.float32)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, compress=compress)
    jcfg, tcfg = JAdamWConfig(**kw), AdamWConfig(**kw)
    toks = tokens(tm.cfg, 32, batch=4)
    jstate = JTrainState(params=jp, opt=jinit_opt_state(jp, jcfg), step=jnp.zeros((), jnp.int32))
    jnew, jm_ = jax.jit(jbuild_train_step(jm, jcfg, n_microbatches=n_micro))(
        jstate, {"tokens": jnp.asarray(toks)})
    tstate = TrainState(params=tp, opt=init_opt_state(tp, tcfg),
                        step=torch.zeros((), dtype=torch.int32))
    tnew, tm_ = build_train_step(tm, tcfg, n_microbatches=n_micro)(
        tstate, {"tokens": torch.from_numpy(toks)})
    return jp, jnew, jm_, tp, tnew, tm_


@pytest.mark.parametrize("n_micro,compress", [(1, False), (2, False), (1, True), (2, True)])
def test_train_step_matches_reference_step(n_micro, compress):
    """One ``build_train_step`` step (float32 activations) against the
    reference's jitted step: loss and grad norm within 1e-4 (fp32 sums in
    other orders), lr bitwise, moments within 1e-3 of each leaf's largest
    (``F32_GRAD_TOL``: they are scaled gradients). Under ``compress`` an
    entry whose quantized value flips moves by a step of the int8 scale,
    1/127 of the largest gradient of the reference's stacked leaf (every
    layer's leaf of that name: one scale serves them all), so one step
    more. The new params: an entry's update is
    about ``lr * sign(g)`` at the first step (m / sqrt(v) with both bias
    corrected), so where the reference's |g| is under 1e-3 of its leaf's
    largest the sign may differ and the entry is held to 2 lr; elsewhere to
    1e-3 lr."""
    jp, jnew, jmet, tp, tnew, tmet = _step_pair(n_micro, compress)
    assert set(tmet) == set(jmet) == {"loss", "ce", "aux", "grad_norm", "lr"}
    for k in ("loss", "ce", "grad_norm"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= 1e-4 * abs(float(jmet[k])), k
    assert float(tmet["aux"]) == float(jmet["aux"]) == 0.0
    assert float(tmet["lr"]) == float(jmet["lr"])
    assert int(tnew.step) == int(jnew.step) == 1 and int(tnew.opt["step"]) == 1
    tol = 1.0 / 127 + F32_GRAD_TOL if compress else F32_GRAD_TOL
    ref = {n: model_params_from_reference(jax.tree.map(np.asarray, t), "cpu")
           for n, t in jnew.opt.items() if n != "step"}
    clip = min(1.0, 1.0 / float(jmet["grad_norm"]))
    mus = {p: w for p, _, w in _leaf_pairs(ref["mu"], ref["mu"])}
    for name in ref:
        leaves = {p: w for p, _, w in _leaf_pairs(ref[name], ref[name])}
        for p, g, w in _leaf_pairs(tnew.opt[name], ref[name]):
            # err is in the unclipped gradient's units: its largest |g| is
            # the first moment's largest over (1 - beta1) and the clip
            scale = (stacked_scale if compress else SMOKE.leaf_scale)(
                mus if name == "err" else leaves, p)
            if name == "err":
                scale = scale / 0.1 / clip
            assert float((g - w).abs().max()) <= tol * scale + 1e-30, (name, p)
    lr = float(jmet["lr"])
    want = model_params_from_reference(jax.tree.map(np.asarray, jnew.params), "cpu")
    for p, g, w in _leaf_pairs(tnew.params, want):
        firm = mus[p].abs() > 1e-3 * SMOKE.leaf_scale(mus, p)
        err = (g - w).abs()
        assert not bool(firm.any()) or float(err[firm].max()) <= 1e-3 * lr, p
        assert float(err.max()) <= 2 * lr * (1 + 1e-3), p
