"""The port's RWKV6 path (K6's plain version, the layer functions, the
model and ``serve_lm``) against the JAX package's.

Inputs are drawn with numpy from a seed and fed to both packages; model
weights are the reference's ``init_params(key 0)``, carried across by
``model_params_from_reference``.

Tolerances, with their reasons:

* K6's plain version against the Pallas K6 (``ops.wkv6``,
  ``interpret=True``) and the sequential oracle: ``SCAN_TOL`` = 2e-3, the
  reference's own kernel-test tolerance (``tests/test_kernels.py``): the
  fp32 cumsum's resolution at |cum| up to 30 x chunk under fast decay.
  The same holds the final state against ``_wkv_chunked``'s and the
  float64 oracle's.
* float32 layer functions and the float32 model: ``F32_TOL`` = 1e-4 of
  the largest magnitude (matmul, reduction and cumsum order; no rounding
  policy is involved; the differences seen were under 1e-5).
* bfloat16 layer functions: ``BF16_TOL`` = 2^-6 of the largest magnitude,
  a step or two of a bfloat16 value (XLA and PyTorch sum products in other
  orders and may keep an intermediate in float32 where the other rounds).
* The bfloat16 model, its caches and ``serve_lm``: ``MODEL_TOL`` = 4% of
  the largest magnitude, the rule of ``tests/test_torch_models.py``
  (about ten bfloat16 steps at that magnitude).
"""

import argparse
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import Model as JModel
from repro.models import rwkv as jrwkv
from repro.models.layers import embed as jembed
from repro_torch.configs import get_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_plain, rwkv6_scan_state
from repro_torch.launch import serve as tserve
from repro_torch.models import Model, model_params_from_reference
from repro_torch.models import rwkv as trwkv
from repro_torch.models.layers import embed

ROOT = Path(__file__).resolve().parents[1]
ARCH = "rwkv6-3b"
SCAN_TOL = 2e-3
F32_TOL = 1e-4
BF16_TOL = 2.0 ** -6
MODEL_TOL = 0.04


def _close(got: torch.Tensor, want, rel: float, what: str = "") -> None:
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not want.size:
        return
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, rel * scale)


def _scan_inputs(rng, bt, h, s, dh, decay_scale):
    r, k, v = (rng.standard_normal((bt, h, s, dh)).astype(np.float32) for _ in range(3))
    logw = -np.exp(rng.standard_normal((bt, h, s, dh)) * decay_scale)
    logw = np.maximum(logw, -30.0).astype(np.float32)  # the model's decay contract
    u = (rng.standard_normal((h, dh)) * 0.1).astype(np.float32)
    return r, k, v, logw, u


def chip_smoke():
    """``chip_smoke.py`` as a module: its scan checks run on the CPU too,
    where the wrappers take the plain versions."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def bf16_exp(monkeypatch):
    """Round every ``torch.exp`` to bfloat16 until ``monkeypatch.undo()``:
    a scan whose gates and decays lose precision."""
    exp = torch.exp
    monkeypatch.setattr(torch, "exp", lambda t: exp(t).bfloat16().float())


def _tree_get(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


# ---------------------------------------------------------------------------
# (a) K6's plain version against the Pallas K6 and the sequential oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(64, 16), (128, 32), (128, 64)])
@pytest.mark.parametrize("decay_scale", [0.5, 4.0])  # 4.0: fast decay
def test_rwkv6_plain_matches_pallas_and_oracle(s, chunk, decay_scale):
    arrays = _scan_inputs(np.random.default_rng(3), 2, 3, s, 16, decay_scale)
    want = np.asarray(jops.wkv6(*map(jnp.asarray, arrays), chunk=chunk))
    oracle = np.asarray(jref.rwkv6_scan_ref(*map(jnp.asarray, arrays)))
    tens = [torch.from_numpy(a) for a in arrays]
    got = tops.wkv6(*tens, chunk=chunk)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, atol=SCAN_TOL, rtol=SCAN_TOL)
    np.testing.assert_allclose(got.numpy(), oracle, atol=SCAN_TOL, rtol=SCAN_TOL)
    # the final state: against the model's _wkv_chunked and the float64 oracle
    y, state = rwkv6_scan_plain(*tens, chunk=chunk)
    _, jfinal = jrwkv._wkv_chunked(*map(jnp.asarray, arrays), chunk)
    y64, state64 = tref.rwkv6_scan_ref(*tens, dtype=torch.float64, return_state=True)
    np.testing.assert_allclose(state.numpy(), np.asarray(jfinal), atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    np.testing.assert_allclose(state.numpy(), state64.numpy(), atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    np.testing.assert_allclose(y.numpy(), y64.numpy(), atol=SCAN_TOL, rtol=SCAN_TOL)


@pytest.mark.parametrize("decay_scale", [0.5, 4.0])
def test_smoke_scan_limit_holds_fp32_and_fails_bf16_controls(decay_scale, monkeypatch):
    """``chip_smoke.py``'s K6 limit, eps32 sqrt(3 Q) (1 + c) sum|terms| per
    entry: the fp32 scan of bf16 r, k, v stays within it (the smoke's
    ``rwkv6_checks`` fails otherwise), its own control (logw rounded to
    bfloat16) does not, and neither does the scan with every exp rounded
    to bfloat16."""
    smoke = chip_smoke()
    arrays = _scan_inputs(np.random.default_rng(5), 1, 2, 256, 64, decay_scale)
    r, k, v = (torch.from_numpy(a).bfloat16() for a in arrays[:3])
    logw, u = torch.from_numpy(arrays[3]), torch.from_numpy(arrays[4])
    checks, _ = smoke.rwkv6_checks(dict(r=r, k=k, v=v, logw=logw, u=u), 64)
    assert max(checks[p]["vs_float64"][1] for p in ("y", "state")) < 0.25
    oracle = tref.rwkv6_scan_ref(r, k, v, logw, u, dtype=torch.float64, return_state=True)
    abs_oracle = tref.rwkv6_scan_ref(r.abs(), k.abs(), v.abs(), logw, u.abs(),
                                     dtype=torch.float64, return_state=True)
    cmax = logw.double().reshape(1, 2, 4, 64, 64).sum(3).abs().amax((2, 3))[..., None, None]
    limits = smoke.scan_limits(abs_oracle, (cmax, cmax), 64)
    bf16_exp(monkeypatch)
    control = rwkv6_scan_plain(r, k, v, logw, u, 64)
    monkeypatch.undo()
    assert sum(smoke.beyond(c, o, lim)[0] for c, o, lim in zip(control, oracle, limits)) > 0


def test_rwkv6_wrappers_on_the_cpu():
    """``rwkv6_scan`` is the output of ``rwkv6_scan_state``, which on a CPU
    tensor is the plain version; the port's oracle is the reference's."""
    arrays = _scan_inputs(np.random.default_rng(4), 1, 2, 32, 16, 0.5)
    tens = [torch.from_numpy(a) for a in arrays]
    y, state = rwkv6_scan_state(*tens, chunk=16)
    py, pstate = rwkv6_scan_plain(*tens, chunk=16)
    assert torch.equal(y, py) and torch.equal(state, pstate)
    assert torch.equal(rwkv6_scan(*tens, chunk=16), y)
    np.testing.assert_allclose(tref.rwkv6_scan_ref(*tens).numpy(),
                               np.asarray(jref.rwkv6_scan_ref(*map(jnp.asarray, arrays))),
                               atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="divide"):
        rwkv6_scan_plain(*tens, chunk=24)


# ---------------------------------------------------------------------------
# (b) the layer functions
# ---------------------------------------------------------------------------

def _layer():
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = jrwkv.init_rwkv6(jax.random.key(0), jcfg)
    # a nonzero decay LoRA and bonus, so both reach the output
    rng = np.random.default_rng(5)
    jp["tm"]["w_lora_b"] = jnp.asarray(rng.standard_normal(jp["tm"]["w_lora_b"].shape)
                                       * 0.3, jnp.float32)
    jp["tm"]["u"] = jnp.asarray(rng.standard_normal(jp["tm"]["u"].shape) * 0.3, jnp.float32)
    tp = model_params_from_reference({"p": jax.tree.map(np.asarray, jp)}, "cpu")["p"]
    return jcfg, cfg, jp, tp


DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_group_norm_and_token_shift(dtype):
    jd, td, tol = DTYPES[dtype]
    rng = np.random.default_rng(6)
    y = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    _close(trwkv._group_norm(torch.from_numpy(y).to(td), torch.from_numpy(scale), 4, 16),
           jrwkv._group_norm(jnp.asarray(y, jd), jnp.asarray(scale), 4, 16), tol)
    prev = rng.standard_normal((2, 1, 64)).astype(np.float32)
    got = trwkv._token_shift(torch.from_numpy(y).to(td), torch.from_numpy(prev).to(td))
    want = jrwkv._token_shift(jnp.asarray(y, jd), jnp.asarray(prev, jd))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["prefill", "prefill_cached", "decode", "one_token_no_cache"])
def test_time_mix_and_channel_mix(dtype, case):
    """The time mix and channel mix in each of the reference's token-shift
    cases: a prompt without and with a cache (the cached token shifts in),
    one token with a cache (the O(1) decode branch), one token without."""
    jd, td, tol = DTYPES[dtype]
    jcfg, cfg, jp, tp = _layer()
    rng = np.random.default_rng(7)
    s = 1 if case in ("decode", "one_token_no_cache") else 24
    x = rng.standard_normal((2, s, 64)).astype(np.float32)
    jcache = tcache = None
    index = None
    if case != "prefill" and case != "one_token_no_cache":
        shift = rng.standard_normal((2, 2, 1, 64)).astype(np.float32)
        state = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
        jcache = {"shift_tm": jnp.asarray(shift[0], jnp.bfloat16),
                  "shift_cm": jnp.asarray(shift[1], jnp.bfloat16),
                  "state": jnp.asarray(state, jnp.bfloat16)}
        tcache = {k: torch.from_numpy(np.asarray(v, np.float32)).bfloat16()
                  for k, v in jcache.items()}
        index = 24 if case == "decode" else None
    jy, jnc = jrwkv.rwkv6_time_mix(jp, jnp.asarray(x, jd), jcfg, cache=jcache,
                                   cache_index=index)
    ty, tnc = trwkv.rwkv6_time_mix(tp, torch.from_numpy(x).to(td), cfg, cache=tcache,
                                   cache_index=index)
    assert ty.dtype == td
    _close(ty, jy, tol, "time mix")
    assert (tnc is None) == (jnc is None)
    for k in (jnc or {}):
        _close(tnc[k], jnc[k], BF16_TOL, f"time-mix cache {k}")  # stored as bf16
    jy, jnc = jrwkv.rwkv6_channel_mix(jp, jnp.asarray(x, jd), cache=jcache)
    ty, tnc = trwkv.rwkv6_channel_mix(tp, torch.from_numpy(x).to(td), cache=tcache)
    _close(ty, jy, tol, "channel mix")
    assert (tnc is None) == (jnc is None)
    for k in (jnc or {}):
        _close(tnc[k], jnc[k], 0.0, f"channel-mix cache {k}")


def test_init_matches_reference_shapes():
    jcfg, cfg, jp, tp = _layer()
    mine = trwkv.init_rwkv6(torch.Generator().manual_seed(0), cfg, "cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in jflat:
        assert tuple(_tree_get(mine, path).shape) == leaf.shape, path
    cache = trwkv.init_rwkv6_cache(cfg, 3)
    jc = jrwkv.init_rwkv6_cache(jcfg, 3)
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        k: (v.shape, torch.bfloat16) for k, v in jc.items()}


# ---------------------------------------------------------------------------
# (c) the model: prefill and decode against the reference
# ---------------------------------------------------------------------------

class _J32(JModel):
    """The reference model with float32 activations (a test-only view)."""

    def _embed_inputs(self, params, batch_inputs, positions):
        return jembed(params["embed"], batch_inputs["tokens"]).astype(jnp.float32)


class _T32(Model):
    """The port's model with float32 activations (a test-only view)."""

    def _embed_inputs(self, params, batch_inputs):
        return embed(params["embed"], batch_inputs["tokens"]).float()


def model_parity(jm, tm, prompt_len: int, steps: int, tol: float,
                 cache_dtype=(jnp.bfloat16, torch.bfloat16)) -> None:
    """Prefill a numpy prompt (seed 1), then ``steps`` greedy decode steps
    on the reference's tokens: logits and every cache entry within ``tol``
    of the largest magnitude. (``tests/test_torch_ssm.py`` uses it too.)"""
    jp = jm.init_params(jax.random.key(0))
    tp = model_params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(1).integers(0, tm.cfg.vocab_size, (2, prompt_len),
                                             dtype=np.int32)
    s_max = prompt_len + steps + 1
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                 jm.init_cache(2, s_max, cache_dtype[0]))
    cache = tm.init_cache(2, s_max, cache_dtype[1], device="cpu")
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache)
    assert tc is cache
    _close(tl, jl, tol, "prefill logits")
    leaves = jax.tree_util.tree_flatten_with_path(jc)[0]
    for path, leaf in leaves:
        _close(_tree_get(tc, path), leaf, tol, f"prefill cache {path}")
    decode = jax.jit(jm.decode_step)
    for step in range(steps):
        tok = np.argmax(np.asarray(jl[:, -1], np.float32), -1)[:, None].astype(np.int32)
        jl, jc = decode(jp, jnp.asarray(tok), jc, jnp.int32(prompt_len + step))
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc, prompt_len + step)
        _close(tl, jl, tol, f"decode {step} logits")
    for path, leaf in jax.tree_util.tree_flatten_with_path(jc)[0]:
        _close(_tree_get(tc, path), leaf, tol, f"decode cache {path}")


@pytest.mark.parametrize("prompt_len", [1, 40])
def test_prefill_and_decode_match_reference(prompt_len):
    """bf16 activations and caches, as served; 40 tokens run five chunks
    of 8, one token the chunk path at length 1."""
    model_parity(JModel(jget_config(ARCH).reduced()), Model(get_config(ARCH).reduced()),
                 prompt_len, 3, MODEL_TOL)


def test_prefill_and_decode_match_reference_in_float32():
    """The same in float32 activations and caches: the algorithm alone."""
    model_parity(_J32(jget_config(ARCH).reduced()), _T32(get_config(ARCH).reduced()),
                 40, 3, F32_TOL, (jnp.float32, torch.float32))


def test_params_from_reference_keep_names_and_layouts():
    jm, tm = JModel(jget_config(ARCH).reduced()), Model(get_config(ARCH).reduced())
    jp = jm.init_params(jax.random.key(0))
    tp = model_params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    mine = tm.init_params(torch.Generator().manual_seed(0), "cpu")
    assert sorted(tp) == sorted(mine) == ["embed", "final_norm", "head", "layers"]
    assert len(tp["layers"]) == len(mine["layers"]) == tm.cfg.n_layers
    for got, made in zip(tp["layers"], mine["layers"]):
        assert got.keys() == made.keys() >= {"tm", "cm", "ln1", "ln1b", "ln2", "ln2b"}
        for part in ("tm", "cm"):
            assert {k: v.shape for k, v in got[part].items()} == \
                {k: v.shape for k, v in made[part].items()}
    np.testing.assert_array_equal(tp["layers"][1]["tm"]["wk"].numpy(),
                                  np.asarray(jp["layers"]["tm"]["wk"][1]))


# ---------------------------------------------------------------------------
# (d) serve_lm on the CPU
# ---------------------------------------------------------------------------

def test_serve_lm_matches_reference_loop(capsys):
    """The port's loop on the reference's weights: at every step logits
    within MODEL_TOL of the reference's prefill / decode fed the port's
    tokens (teacher forcing)."""
    args = argparse.Namespace(arch=ARCH, smoke=True, requests=3, slots=2, prompt_len=16,
                              gen_len=3, technique="GSS", device="cpu")
    jm = JModel(jget_config(ARCH).reduced())
    jp = jm.init_params(jax.random.key(0))
    res = tserve.serve_lm(args, params=model_params_from_reference(
        jax.tree.map(np.asarray, jp), "cpu"))
    assert "[serve] 3 requests x 3 tokens" in capsys.readouterr().out
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    for rows, toks, logits in zip(res.requests, res.tokens, res.logits):
        assert toks.shape == (args.slots, args.gen_len)
        jl, jc = prefill(jp, {"tokens": jnp.asarray(res.prompts[rows])},
                         jm.init_cache(len(rows), args.prompt_len + args.gen_len))
        _close(logits[:, 0], jl[:, -1], MODEL_TOL, "prefill logits")
        for t in range(args.gen_len - 1):
            tok = jnp.asarray(toks[:, t:t + 1].numpy().astype(np.int32))
            jl, jc = decode(jp, tok, jc, jnp.int32(args.prompt_len + t))
            _close(logits[:, t + 1], jl[:, 0], MODEL_TOL, f"decode {t} logits")


def test_serve_main_on_the_cpu(capsys):
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "2",
                 "--prompt-len", "16", "--gen-len", "2"])
    assert "[serve] 2 requests x 2 tokens" in capsys.readouterr().out
