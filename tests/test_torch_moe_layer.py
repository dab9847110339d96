"""The port's MoE layer (``moe_block``, ``aux_load_balance_loss``, the MoE
decoder layer) and Qwen1.5-MoE against the JAX package's, with the
router's tie order (C4).

Weights are the reference's own (``init_moe`` / ``Model.init_params``, jax
key 0), carried across with ``model_params_from_reference``; tokens and
activations are numpy draws from a seed.

Tolerances:

* The router's expert indices are held bitwise wherever both stacks route
  the same bf16 input: the tie order included, lower index first among
  equal probabilities, as ``jax.lax.top_k`` gives it.
* ``moe_block`` in float32 (``FLOAT_RTOL``): y and the aux loss within
  1e-5 of the largest magnitude. An entry of y sums two products of d = 64
  and f = 32 terms; each sum rounds by at most about 64 eps32 = 3.8e-6 of
  its sum of |terms|.
* Layers and models in bfloat16 (``MODEL_TOL``, ``tests/test_torch_models.py``):
  4% of the compared tensor's largest magnitude.
* Routing between two bf16 stacks. The router's input in the port and in
  the reference differs by bf16 rounding (and, over 1,024 tokens, by the
  reference's chunked attention rounding each block's scores and p.v to
  bf16, where K4 keeps them in fp32), so where two router logits nearly
  tie the two stacks can pick different experts at a position, whose
  output then differs by a whole expert. ``chip_smoke.routing_flips``
  (the smoke holds K4 against its plain version on the card the same
  way) fails on any difference that rounding does not explain: every
  port logit within what the router inputs' difference explains, every
  differing expert set on a near tie (the reference's k-th and (k+1)-th
  logits within 2 bf16 ulps of the larger, or within those two logits'
  bounds), every capacity-only difference after such a flip. Those
  positions are left out of later comparisons, at most ``FLIP_SHARE``
  (2%) of them a layer, as a rate (``LeftOut.check``).
* The reference's model runs under ``jit``, where XLA folds the router's
  cast to float32 into its bf16 product and routes on unrounded logits;
  its ``_route`` run op by op rounds them to bf16 as the source writes,
  and so does the port: the port's routing is held bitwise to that.
"""

import argparse
import dataclasses
import math
from functools import partial
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import make_partitioner as jmake_partitioner
from repro.models import attention as jattention
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.vee import ml_apps as jml
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models import blocks as tblocks
from repro_torch.models import moe as tmoe
from repro_torch.vee import ml_apps as tml
from test_torch_models import MODEL_TOL, _models
from test_torch_rwkv import chip_smoke

FLOAT_RTOL = 1e-5
FLIP_SHARE = 0.02
QWEN = "qwen2-moe-a2.7b"


def _bf16(a) -> torch.Tensor:
    """A reference array as a bf16 tensor (exact for bf16 arrays)."""
    return torch.from_numpy(np.asarray(jnp.asarray(a).astype(jnp.float32)).copy()).bfloat16()


def _np(t) -> np.ndarray:
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t).astype(jnp.float32))


def _within(got, want, rel: float, what: str, rows=None) -> None:
    """``|got - want| <= rel * max|want|`` over the whole of ``want`` (or
    over the entries where ``rows`` is True, the scale still the whole's)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not want.size:
        return
    scale = float(np.abs(want).max())
    err = np.abs(got - want)
    if rows is not None:
        err = err[rows]
    worst = float(err.max()) if err.size else 0.0
    assert worst <= rel * scale, (what, worst, scale)


# ---------------------------------------------------------------------------
# C4: the router's tie order at both call sites
# ---------------------------------------------------------------------------

def _tied_router_inputs(kind: str, d: int, e: int):
    """(router (d, e) float32, tokens (2 * 1088, d) float32) whose bf16
    router logits tie exactly. ``grid``: small integers times a quarter,
    so every product and sum is exact in bf16 on any device; ``normal``:
    the reference's reduced Qwen router (``init_moe``, key 0) and normal
    tokens (numpy seed 1), ties as bf16 rounding makes them."""
    rng = np.random.default_rng(1)
    if kind == "grid":
        router = rng.integers(-1, 2, (d, e)).astype(np.float32) * 0.25
        x = rng.integers(-2, 3, (2 * 1088, d)).astype(np.float32)
        return router, x
    moe = jget_config(QWEN).reduced().moe
    router = np.array(jmoe.init_moe(jax.random.key(0), d, moe)["router"])
    return router, rng.standard_normal((2 * 1088, d)).astype(np.float32)


@pytest.mark.parametrize("kind", ["grid", "normal"])
def test_route_takes_lax_top_k_order_on_ties(kind):
    """``_route`` on bf16 inputs with exact ties: expert indices bitwise
    the reference's, order included; ``torch.topk`` on the same probs
    gives another order on some tokens, which the stable sort repairs."""
    cfg = jget_config(QWEN).reduced()
    router, x = _tied_router_inputs(kind, cfg.d_model, cfg.moe.n_routed)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jidx, jw, jprobs = jmoe._route(jnp.asarray(router), xb, cfg.moe)
    idx, w, probs = tmoe._route(torch.from_numpy(router), _bf16(xb), get_config(QWEN)
                                .reduced().moe)
    jidx = np.asarray(jidx)
    assert np.array_equal(idx.numpy(), jidx)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    probs_ref = torch.from_numpy(np.asarray(jprobs).copy())
    ties = (probs_ref[:, :, None] == probs_ref[:, None, :]).sum((1, 2)) > probs.shape[1]
    assert int(ties.sum()) > 0
    _, plain = torch.topk(probs, cfg.moe.top_k, dim=-1)
    assert int((plain.numpy() != jidx).any(1).sum()) > 0, "torch.topk kept the order here"


def test_dispatch_route_stage_takes_lax_top_k_order_on_ties():
    """The scheduler's MoE dispatch (``vee/ml_apps.py``) routes in the same
    order: on the grid inputs (its tokens in place of the skewed draw),
    whose mul-reduce logits are exact in any summation order, the route
    stage's indices are bitwise those of the reference's route body
    (``jax.lax.top_k`` over the same logits), where ``torch.topk`` on the
    same probs differs."""
    jlow = jml.moe_dispatch_lowering(n_tokens=96, skew=1.2, seed=0)
    params = tml.moe_params_from_reference(jlow.meta["params"], device="cpu")
    router, x = _tied_router_inputs("grid", *params["router"].shape)
    params["router"] = torch.from_numpy(router)
    with mock.patch.object(tml, "skewed_tokens", lambda *a, **kw: x):
        low = tml.moe_dispatch_lowering(n_tokens=len(x), skew=1.2, seed=0, params=params,
                                        device="cpu")
    k = low.meta["moe"].top_k
    logits = (jnp.asarray(x)[:, :, None] * jnp.asarray(router)[None]).sum(axis=1)
    probs = jax.nn.softmax(logits, axis=-1)
    _, jidx = jax.lax.top_k(probs, k)
    jidx = np.asarray(jidx)
    assert np.array_equal(low.meta["route_build"][:, :k].astype(np.int64), jidx)
    _, plain = torch.topk(torch.from_numpy(np.asarray(probs).copy()), k, dim=-1)
    assert (plain.numpy() != jidx).any(1).sum() > 0, "torch.topk kept the order"


# ---------------------------------------------------------------------------
# moe_block and aux_load_balance_loss in float32
# ---------------------------------------------------------------------------

VARIANTS = {"plain": {}, "padded": dict(n_routed_padded=8),
            "drops": dict(capacity_factor=0.5), "padded+drops": dict(n_routed_padded=8,
                                                                       capacity_factor=0.5)}


def _moe_pair(variant: str):
    jcfg = jget_config(QWEN).reduced()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **VARIANTS[variant]))
    tcfg = get_config(QWEN).reduced()
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, **VARIANTS[variant]))
    jp = jmoe.init_moe(jax.random.key(0), jcfg.d_model, jcfg.moe)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.default_rng(2).standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_moe_block_float32_matches_reference(variant):
    jcfg, tcfg, jp, tp, x = _moe_pair(variant)
    jy, jaux = jmoe.moe_block(jp, jnp.asarray(x), jcfg)
    seen = []
    route = tmoe._route

    def spy(*a):
        out = route(*a)
        seen.append(out[0])
        return out

    with mock.patch.object(tmoe, "_route", spy):
        y, aux = tmoe.moe_block(tp, torch.from_numpy(x), tcfg)
    jidx, _, _ = jmoe._route(jp["router"], jnp.asarray(x).reshape(-1, jcfg.d_model), jcfg.moe)
    assert np.array_equal(seen[0].numpy(), np.asarray(jidx))
    assert y.dtype == torch.float32 and y.shape == x.shape
    _within(y, jy, FLOAT_RTOL, "y")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=FLOAT_RTOL)
    moe = tcfg.moe
    cap = max(1, math.ceil(moe.top_k * 48 * moe.capacity_factor
                           / (moe.n_routed_padded or moe.n_routed)))
    dropped = (~_kept(np.asarray(jidx), cap)).sum()
    assert dropped > 0 or "drops" not in variant
    if "padded" in variant:
        assert tp["experts"]["wi"].shape[0] == 8 and int(seen[0].max()) < moe.n_routed


@pytest.mark.parametrize("variant", ["plain", "padded"])
def test_aux_load_balance_loss_matches_reference(variant):
    jcfg, tcfg, jp, tp, x = _moe_pair(variant)
    jidx, _, jprobs = jmoe._route(jp["router"], jnp.asarray(x).reshape(-1, 64), jcfg.moe)
    got = tmoe.aux_load_balance_loss(torch.from_numpy(np.asarray(jprobs).copy()),
                                     torch.from_numpy(np.asarray(jidx).astype(np.int64)),
                                     tcfg.moe)
    want = jmoe.aux_load_balance_loss(jprobs, jidx, jcfg.moe)
    np.testing.assert_allclose(float(got), float(want), rtol=FLOAT_RTOL)
    # in the probs' dtype: bf16 probs give a bf16 loss, as the reference's
    got16 = tmoe.aux_load_balance_loss(torch.from_numpy(np.asarray(jprobs).copy()).bfloat16(),
                                       torch.from_numpy(np.asarray(jidx).astype(np.int64)),
                                       tcfg.moe)
    want16 = jmoe.aux_load_balance_loss(jprobs.astype(jnp.bfloat16), jidx, jcfg.moe)
    assert got16.dtype == torch.bfloat16 and str(want16.dtype) == "bfloat16"
    np.testing.assert_allclose(float(got16), float(want16), rtol=2 ** -7)


# ---------------------------------------------------------------------------
# routing between the two stacks
# ---------------------------------------------------------------------------

SMOKE = chip_smoke()


def _kept(idx: np.ndarray, cap: int) -> np.ndarray:
    return SMOKE.kept_slots(torch.from_numpy(np.array(idx)), cap).numpy()


@dataclasses.dataclass
class Flips:
    """Positions (flattened ``b * S + s``) whose kept experts differ
    between the stacks in one MoE call: ``near_tie`` where the expert sets
    differ on a near tie, ``capacity`` where the sets agree and only drops
    differ."""

    near_tie: np.ndarray
    capacity: np.ndarray

    @property
    def all(self) -> np.ndarray:
        return np.union1d(self.near_tie, self.capacity).astype(np.int64)


def routing_flips(ref: dict, got: tuple, moe, what: str) -> Flips:
    """``chip_smoke.routing_flips`` on one MoE call, the reference's routing
    (``ref``: its router input ``x``, float32 ``logits``, ``idx`` and the
    ``router``) against the port's (a ``chip_smoke.route_log`` entry):
    fails on any difference that rounding does not explain."""
    out = SMOKE.routing_flips(
        tuple(torch.from_numpy(np.array(ref[k])) for k in ("x", "logits", "idx")),
        got[:2], torch.from_numpy(ref["router"]), moe)
    assert not out["unexplained"], (what, "routing differs beyond rounding at",
                                    out["unexplained"], out["worst_share"])
    return Flips(np.asarray(out["near_tie"], np.int64), np.asarray(out["capacity"], np.int64))


def test_routing_flips_catch_a_wrong_router():
    """The check fails where rounding cannot explain the routing: the port's
    router input against the reference's, once with the right router
    (explained) and once with one expert's column scaled by 1.5."""
    jm, jp, tm, tp = _models(QWEN)
    toks = np.random.default_rng(1).integers(0, tm.cfg.vocab_size, (2, 32), dtype=np.int32)
    run = RefStack(jm, jp).run(toks, jm.init_cache(2, 33))
    with SMOKE.route_log() as calls:
        tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tm.init_cache(2, 33, device="cpu"))
    ref, (x, _, router) = run["routes"][0], calls[0]
    routing_flips(ref, (x, tmoe._route(router, x, tm.cfg.moe)[0]), tm.cfg.moe, "right router")
    wrong = router.clone()
    wrong[:, 3] *= 1.5
    out = SMOKE.routing_flips(
        tuple(torch.from_numpy(np.array(ref[k])) for k in ("x", "logits", "idx")),
        (x, tmoe._route(wrong, x, tm.cfg.moe)[0]), wrong, tm.cfg.moe)
    assert out["unexplained"] and out["worst_share"] > 1


class LeftOut:
    """Positions left out of the comparisons, each counted at the MoE layer
    where its routing first differed. The share is per layer: a position
    whose routing differs at one layer differs at every later one, so a
    share over all layers would grow with depth."""

    def __init__(self):
        self.by_layer: dict[int, int] = {}
        self.positions: set = set()

    def add(self, layer: int, keys) -> None:
        new = set(keys) - self.positions
        self.by_layer[layer] = self.by_layer.get(layer, 0) + len(new)
        self.positions |= new

    def check(self, n_positions: int) -> dict:
        """At most ``FLIP_SHARE`` of the positions a layer, as a rate: n p
        plus three standard deviations of a binomial count at that rate
        (at 70 positions a share of 2% alone would allow one flip)."""
        p = FLIP_SHARE
        allowed = p * n_positions + 3 * math.sqrt(p * (1 - p) * n_positions)
        worst = max(self.by_layer.values(), default=0)
        assert worst <= allowed, (self.by_layer, n_positions, allowed)
        return dict(by_layer=self.by_layer, positions=n_positions, allowed=allowed)


# ---------------------------------------------------------------------------
# the reference, one layer at a time
# ---------------------------------------------------------------------------

class RefStack:
    """The reference model unrolled: ``blocks.apply_*_layer`` one layer at
    a time (each jitted), keeping each layer's input, its MoE block's input
    and its router's logits and indices."""

    def __init__(self, jm, jp):
        self.jm, self.jp, cfg = jm, jp, jm.cfg
        n = jax.tree.leaves(jp["layers"])[0].shape[0]
        self.layers = ([jp["layer0"]] if "layer0" in jp else []) + [
            jax.tree.map(lambda a, i=i: a[i], jp["layers"]) for i in range(n)]
        apply = jblocks.apply_mla_layer if cfg.mla is not None else jblocks.apply_moe_layer
        attend = jattention.mla_attention if cfg.mla is not None else jattention.gqa_attention

        @partial(jax.jit, static_argnames=("impl",))
        def layer(lp, x, c, positions, cache_index, impl):
            h, _ = attend(lp["attn"], jlayers.rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                          positions=positions, impl=impl, cache=c, cache_index=cache_index)
            moe_in = jlayers.rms_norm(x + h, lp["ln2"], cfg.norm_eps)
            y, nc, _ = apply(lp, x, cfg, positions=positions, impl=impl, cache=c,
                             cache_index=cache_index)
            return y, nc, moe_in

        @jax.jit
        def route(router, moe_in):
            x_flat = moe_in.reshape(-1, cfg.d_model)
            logits = (x_flat @ router.astype(x_flat.dtype)).astype(jnp.float32)
            return jmoe._route(router, x_flat, cfg.moe)[0], logits

        self._layer, self._route = layer, route

    def run(self, tokens: np.ndarray, cache, cache_index=None) -> dict:
        """Prefill (``cache_index`` None) or one decode step. Returns the
        last-position logits, the new cache and per layer its input, the
        MoE block's input, and its routing (``routing_flips``' ``ref``;
        None for a dense layer)."""
        jm, jp = self.jm, self.jp
        s = tokens.shape[1]
        positions = jnp.arange(s) if cache_index is None else jnp.full((1,), cache_index,
                                                                         jnp.int32)
        impl = jm._impl(s)
        x = jm._embed_inputs(jp, {"tokens": jnp.asarray(tokens)}, positions)
        out = dict(inputs=[], moe_inputs=[], routes=[], caches=[])
        ci = None if cache_index is None else jnp.int32(cache_index)
        for i, lp in enumerate(self.layers):
            c = jax.tree.map(lambda a, i=i: a[i], cache)
            out["inputs"].append(x)
            x, nc, moe_in = self._layer(lp, x, c, positions, ci, impl)
            out["caches"].append(nc)
            out["moe_inputs"].append(moe_in)
            route = None
            if "moe" in lp:
                idx, logits = self._route(lp["moe"]["router"], moe_in)
                route = dict(x=_np(moe_in).reshape(-1, jm.cfg.d_model), logits=_np(logits),
                             idx=np.asarray(idx), router=np.array(lp["moe"]["router"]))
            out["routes"].append(route)
        out["cache"] = jax.tree.map(lambda *a: jnp.stack(a), *out["caches"])
        out["logits_out"] = jm._logits(jp, x[:, -1:])
        return out


CACHE_AXES = {"k": (1, 3), "v": (1, 3), "ckv": (1, 2), "kpe": (1, 3)}


def _cache_rows(key: str, shape, layer: int, excluded: np.ndarray, seq: int) -> np.ndarray:
    """A mask over the cache array ``key`` of ``shape`` selecting ``layer``'s
    entries at prefill positions not in ``excluded`` (flattened b * seq + s)."""
    b_ax, s_ax = CACHE_AXES[key]
    keep = np.ones((shape[b_ax], shape[s_ax]), bool)
    keep[:, seq:] = False
    for p in excluded:
        keep[p // seq, p % seq] = False
    mask = np.broadcast_to(keep[tuple(slice(None) if a in (b_ax, s_ax) else None
                                      for a in range(len(shape)))], shape).copy()
    layer_mask = np.zeros(shape, bool)
    layer_mask[layer] = True
    return mask & layer_mask


def eager_route(lp, moe_in, cfg) -> np.ndarray:
    """The reference's ``_route`` run op by op on a layer's MoE input: its
    logits are the bf16 product the source writes. Under ``jit`` (the
    reference's model) XLA folds the cast to float32 into the product and
    routes on unrounded logits, which breaks the bf16 ties; the port keeps
    the source's rounding, so it is held bitwise to this."""
    with jax.disable_jit():
        idx, _, _ = jmoe._route(lp["moe"]["router"], moe_in.reshape(-1, cfg.d_model), cfg.moe)
    return np.asarray(idx)


def check_unrolled_reference(jm, jp, ref: RefStack, toks, s_max):
    """The unrolled reference gives ``Model.prefill``'s logits and cache."""
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(*toks.shape[:1],
                                                                                    s_max))
    run = ref.run(toks, jm.init_cache(toks.shape[0], s_max))
    assert np.array_equal(_np(run["logits_out"]), _np(jl))
    for key in jc:
        assert np.array_equal(_np(run["cache"][key]), _np(jc[key])), key
    return run


def teacher_forced(arch: str, prompt_len: int) -> dict:
    """Each port layer on the reference's own input to it (prefill), the
    MoE block on the reference's own input to it. Returns the flip counts."""
    jm, jp, tm, tp = _models(arch)
    cfg = tm.cfg
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, prompt_len), dtype=np.int32)
    s_max = prompt_len + 4
    ref = RefStack(jm, jp)
    run = check_unrolled_reference(jm, jp, ref, toks, s_max)
    stack = ([tp["layer0"]] if "layer0" in tp else []) + tp["layers"]
    apply = tblocks.apply_mla_layer if cfg.mla is not None else tblocks.apply_moe_layer
    positions = torch.arange(prompt_len)
    impl = tm._impl(prompt_len)
    cache = tm.init_cache(2, s_max, device="cpu")
    left_out = LeftOut()
    for i, lp in enumerate(stack):
        x_in = _bf16(run["inputs"][i])
        c = {key: t[i] for key, t in cache.items()}
        with SMOKE.route_log() as calls:
            y, _, aux = apply(lp, x_in, cfg, positions=positions, impl=impl, cache=c,
                              cache_index=None)
        want_y = run["inputs"][i + 1] if i + 1 < len(stack) else None
        for key in c:
            _within(c[key], run["caches"][i][key], MODEL_TOL, f"layer {i} cache {key}")
        if "moe" not in lp:
            assert not calls and aux == 0.0
            if want_y is not None:
                _within(y, want_y, MODEL_TOL, f"layer {i} output")
            continue
        # the MoE block on the reference's own input routes exactly as the
        # reference's _route does, op by op (see ``eager_route``)
        moe_in = _bf16(run["moe_inputs"][i])
        idx, _, _ = tmoe._route(lp["moe"]["router"], moe_in.reshape(-1, cfg.d_model), cfg.moe)
        assert np.array_equal(idx.numpy(), eager_route(ref.layers[i], run["moe_inputs"][i],
                                                       jm.cfg)), f"layer {i} routing"
        jy, jaux = jmoe.moe_block(ref.layers[i]["moe"], run["moe_inputs"][i], jm.cfg)
        ty, taux = tmoe.moe_block(lp["moe"], moe_in, cfg)
        _within(ty, jy, MODEL_TOL, f"layer {i} moe_block")
        np.testing.assert_allclose(float(taux), float(jaux), rtol=FLOAT_RTOL)
        # the whole layer: its own attention moves the router's input by
        # bf16 rounding, so a near tie may route otherwise
        flips = routing_flips(run["routes"][i], calls[0], cfg.moe, f"layer {i}")
        left_out.add(i, ((i, p) for p in flips.all))
        rows = np.ones((2, prompt_len), bool)
        for p in flips.all:
            rows[p // prompt_len, p % prompt_len] = False
        if want_y is not None:
            _within(y, want_y, MODEL_TOL, f"layer {i} output", rows=rows)
    return left_out.check(2 * prompt_len)


def end_to_end(arch: str, prompt_len: int, steps: int = 3) -> dict:
    """``Model.prefill`` and ``steps`` decode steps (on the reference's
    greedy tokens) against the unrolled reference: logits and caches within
    MODEL_TOL, positions whose routing flipped left out after their layer."""
    jm, jp, tm, tp = _models(arch)
    cfg = tm.cfg
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, prompt_len), dtype=np.int32)
    s_max = prompt_len + steps + 1
    ref = RefStack(jm, jp)
    run = check_unrolled_reference(jm, jp, ref, toks, s_max)
    cache = tm.init_cache(2, s_max, device="cpu")
    with SMOKE.route_log() as calls:
        logits, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache)
    moe_layers = [i for i, r in enumerate(run["routes"]) if r is not None]
    assert len(calls) == len(moe_layers)
    left_out = LeftOut()
    excluded = np.zeros(0, np.int64)
    excluded_before = {}
    for i, route in enumerate(run["routes"]):
        excluded_before[i] = excluded
        if route is not None:
            flips = routing_flips(route, calls[moe_layers.index(i)], cfg.moe,
                                  f"prefill layer {i}")
            left_out.add(i, ((p // prompt_len, p % prompt_len) for p in flips.all))
            excluded = np.union1d(excluded, flips.all)
    last = [b for b in range(2) if b * prompt_len + prompt_len - 1 not in excluded]
    _within(logits[last], np.asarray(run["logits_out"], np.float32)[last], MODEL_TOL,
            "prefill logits")
    for key, t in cache.items():
        want = np.asarray(run["cache"][key], np.float32)
        for i in range(t.shape[0]):
            rows = _cache_rows(key, t.shape, i, excluded_before[i], prompt_len)
            _within(t, want, MODEL_TOL, f"prefill cache {key} layer {i}", rows=rows)
    jc = run["cache"]
    jl = np.asarray(run["logits_out"], np.float32)
    for step in range(steps):
        tok = np.argmax(jl[:, -1], -1)[:, None].astype(np.int32)
        step_run = ref.run(tok, jc, prompt_len + step)
        jd, jc = jax.jit(jm.decode_step)(jp, jnp.asarray(tok), jc, jnp.int32(prompt_len + step))
        assert np.array_equal(_np(step_run["logits_out"]), _np(jd)), "unrolled decode"
        with SMOKE.route_log() as calls:
            tl, cache = tm.decode_step(tp, torch.from_numpy(tok), cache, prompt_len + step)
        flipped = set()
        for n, i in enumerate(moe_layers):
            flips = routing_flips(step_run["routes"][i], calls[n], cfg.moe,
                                  f"decode {step} layer {i}")
            flipped |= set(flips.all.tolist())
            left_out.add(i, ((b, prompt_len + step) for b in flips.all))
        rows = [b for b in range(2) if b not in flipped]
        jl = np.asarray(jd, np.float32)
        _within(tl[rows], jl[rows], MODEL_TOL, f"decode {step} logits")
    return left_out.check(2 * (prompt_len + steps))


# ---------------------------------------------------------------------------
# Qwen1.5-MoE: the layer, teacher forcing, end to end, serving, counts
# ---------------------------------------------------------------------------

def test_moe_layer_params_and_cache_layouts():
    jm, jp, tm, tp = _models(QWEN)
    made = tm.init_params(torch.Generator().manual_seed(0), "cpu")
    assert sorted(tp) == sorted(made) == ["embed", "final_norm", "head", "layers"]
    assert len(tp["layers"]) == len(made["layers"]) == tm.cfg.n_layers
    for got, mine in zip(tp["layers"], made["layers"]):
        assert got.keys() == mine.keys() == {"ln1", "attn", "ln2", "moe"}
        assert got["moe"].keys() == mine["moe"].keys() == {"router", "experts", "shared"}
        for k in ("wi", "wo"):
            assert got["moe"]["experts"][k].shape == mine["moe"]["experts"][k].shape
    np.testing.assert_array_equal(tp["layers"][1]["moe"]["experts"]["wo"].numpy(),
                                  np.asarray(jp["layers"]["moe"]["experts"]["wo"][1]))
    cache = tm.init_cache(2, 40, device="cpu")
    jc = jm.init_cache(2, 40)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}


@pytest.mark.parametrize("prompt_len", [32, 1088])
def test_qwen_moe_teacher_forced_layers_match_reference(prompt_len):
    teacher_forced(QWEN, prompt_len)


@pytest.mark.parametrize("prompt_len", [32, 1088])
def test_qwen_moe_prefill_and_decode_match_reference(prompt_len):
    end_to_end(QWEN, prompt_len)


def test_moe_layer_aux_is_the_blocks():
    """``apply_moe_layer`` returns its block's aux (times the weight) and
    ``Model._trunk`` sums the layers' aux."""
    jm, jp, tm, tp = _models(QWEN)
    toks = np.random.default_rng(3).integers(0, tm.cfg.vocab_size, (2, 16), dtype=np.int32)
    x = tm._embed_inputs(tp, {"tokens": torch.from_numpy(toks)})
    _, _, aux = tm._trunk(tp, x, torch.arange(16))
    jx = jm._embed_inputs(jp, {"tokens": jnp.asarray(toks)}, jnp.arange(16))
    _, _, jaux = jm._trunk(jp, jx, jnp.arange(16))
    assert 0 < float(aux) < 1
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0.05)


def serve_against_reference(arch: str, prompt_len: int, capsys) -> None:
    """``serve_lm`` on the CPU on the reference's weights: the reference's
    chunks and slot batches, each batch's greedy tokens its logits'
    argmax, and the prefill's and every decode step's logits within
    MODEL_TOL of the unrolled reference fed the port's tokens, rows whose
    routing flipped on a near tie left out (``routing_flips``)."""
    args = argparse.Namespace(arch=arch, smoke=True, requests=5, slots=2,
                              prompt_len=prompt_len, gen_len=4, technique="GSS", device="cpu")
    jm, jp, _, tp = _models(arch)
    with SMOKE.route_log() as calls:
        res = tserve.serve_lm(args, params=tp)
    assert "[serve] 5 requests x 4 tokens" in capsys.readouterr().out
    part = jmake_partitioner(args.technique, args.requests, args.slots)
    batches, served = [], 0
    while served < args.requests:
        n = min(part.next_chunk() or 1, args.requests - served)
        reqs = list(range(served, served + n))
        served += n
        reqs += [reqs[-1]] * ((-len(reqs)) % args.slots)
        batches += [reqs[i:i + args.slots] for i in range(0, len(reqs), args.slots)]
    assert res.requests == batches
    ref = RefStack(jm, jp)
    calls = iter(calls)
    moe = res.model.cfg.moe
    left_out = LeftOut()

    def flipped(run, what, key):
        out = np.zeros(0, np.int64)
        for i, route in enumerate(run["routes"]):
            if route is not None:
                flips = routing_flips(route, next(calls), moe, what).all
                left_out.add(i, (key(p) for p in flips))
                out = np.union1d(out, flips)
        return out

    for n, (rows, toks, logits) in enumerate(zip(res.requests, res.tokens, res.logits)):
        assert torch.equal(toks, logits.float().argmax(-1))
        run = ref.run(res.prompts[rows], jm.init_cache(len(rows), prompt_len + args.gen_len))
        excluded = flipped(run, "prefill", lambda p: (n, p // prompt_len, p % prompt_len))
        keep = [b for b in range(len(rows)) if b * prompt_len + prompt_len - 1 not in excluded]
        _within(logits[keep, 0], _np(run["logits_out"])[keep, -1], MODEL_TOL, "prefill")
        jc = run["cache"]
        for t in range(args.gen_len - 1):
            step = ref.run(toks[:, t:t + 1].numpy().astype(np.int32), jc, prompt_len + t)
            jc = step["cache"]
            out = flipped(step, f"decode {t}", lambda b: (n, b, prompt_len + t))
            keep = [b for b in range(len(rows)) if b not in out]
            _within(logits[keep, t + 1], _np(step["logits_out"])[keep, 0], MODEL_TOL,
                    f"decode {t}")
    assert next(calls, None) is None
    left_out.check(sum(len(r) for r in res.requests) * (prompt_len + args.gen_len - 1))
    assert res.prefill_seconds > 0 and res.decode_seconds > 0


@pytest.mark.parametrize("prompt_len", [32, 1088])
def test_serve_qwen_moe_matches_reference_loop(prompt_len, capsys):
    serve_against_reference(QWEN, prompt_len, capsys)
