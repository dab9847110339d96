"""The port's Mamba2 / Zamba2 path (K5's plain version, the layer
functions, the hybrid model and ``serve_lm``) against the JAX package's.

Inputs are drawn with numpy from a seed and fed to both packages; model
weights are the reference's ``init_params(key 0)``, carried across by
``model_params_from_reference``.

``zamba2-7b``'s reduced config has ``n_layers = 2`` with ``attn_every =
6``: no super-block, two tail layers, and the shared attention block never
runs. ``VARIANT`` (``n_layers = 5, attn_every = 2``, applied to both
packages' configs) runs two super-blocks, each two Mamba2 layers and the
shared block with its own KV cache, then one tail layer.

Tolerances, with their reasons:

* K5's plain version against the Pallas K5 (``ops.mamba2_chunk_scan``,
  ``interpret=True``) and the sequential oracle: the reference's own
  kernel-test tolerances (``tests/test_kernels.py``), 2e-4 in float32 and
  5e-2 in bfloat16 (inputs of 8 bits); the same for the final state
  against the float64 oracle's.
The model-level helpers (``model_parity``, the float32 views ``_J32`` and
``_T32``) are ``tests/test_torch_rwkv.py``'s.

* float32 layer functions and the float32 model: ``F32_TOL`` = 1e-4 of
  the largest magnitude (matmul, reduction and cumsum order only; the
  differences seen were under 1e-5).
* bfloat16 layer functions: ``BF16_TOL`` = 2^-6 of the largest magnitude,
  a step or two of a bfloat16 value.
* The bfloat16 model, its caches and ``serve_lm``: ``MODEL_TOL`` = 4% of
  the largest magnitude, the rule of ``tests/test_torch_models.py``.
* The bfloat16 ``VARIANT``: held to the reference's own bfloat16 spread.
  It is 5 layers deep (the reduced configs 2), and bfloat16 roundings
  compound through it. Run through ``_reference_run`` and ``_port_run``
  below over prompt seeds 0-8, the reference's bfloat16 run
  lies 5.5-12.8% of the largest magnitude from its float32 run (its worst
  entry over logits and caches), and the port's bfloat16 run 4.0-10.5%
  from the same float32 run, at most 1.20 times the reference's own gap
  on any seed; the two bfloat16 runs differ by up to 22.7% (seed 4), each
  drifting from float32 its own way. So ``spread`` (the reference's
  worst bf16-vs-float32 entry on the seed) is the yardstick: every entry
  of the port's bfloat16 run lies within ``SPREAD_ROOM`` = 1.5 spreads of
  the reference's float32 run, and within 1 + 1.5 of its bfloat16 run.
  The float32 run of the same variant agrees to 1e-5, which shows the
  gap is rounding, not a different computation.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import Model as JModel
from repro.models import blocks as jblocks
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain, ssm_scan_state
from repro_torch.launch import serve as tserve
from repro_torch.models import Model, model_params_from_reference
from repro_torch.models import blocks as tblocks
from repro_torch.models import ssm as tssm
from test_torch_rwkv import _J32, _T32, _close, _tree_get, bf16_exp, chip_smoke, model_parity

ARCH = "zamba2-7b"
F32_TOL = 1e-4
BF16_TOL = 2.0 ** -6
MODEL_TOL = 0.04
SPREAD_ROOM = 1.5
SCAN_TOL = {"float32": 2e-4, "bfloat16": 5e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _variant(cfg):
    return dataclasses.replace(cfg, n_layers=5,
                               ssm=dataclasses.replace(cfg.ssm, attn_every=2))


def _scan_inputs(rng, bt, s, h, dh, n):
    x = rng.standard_normal((bt, s, h, dh)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bt, s, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.5)).astype(np.float32)
    B = rng.standard_normal((bt, s, n)).astype(np.float32)
    C = rng.standard_normal((bt, s, n)).astype(np.float32)
    D = np.ones(h, np.float32)
    return x, dt, A, B, C, D


# ---------------------------------------------------------------------------
# (a) K5's plain version against the Pallas K5 and the sequential oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(128, 32), (256, 64), (256, 128)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssm_plain_matches_pallas_and_oracle(s, chunk, dtype):
    jd, td = DTYPES[dtype]
    x, dt, A, B, C, D = _scan_inputs(np.random.default_rng(2), 2, s, 3, 16, 8)
    # x, dt, B and C in the working type, A and D in float32, as the
    # reference's kernel test draws them
    jin = [jnp.asarray(a, jd) for a in (x, dt)] + [jnp.asarray(A)] + \
        [jnp.asarray(a, jd) for a in (B, C)] + [jnp.asarray(D)]
    tin = [torch.from_numpy(a).to(td) for a in (x, dt)] + [torch.from_numpy(A)] + \
        [torch.from_numpy(a).to(td) for a in (B, C)] + [torch.from_numpy(D)]
    want = np.asarray(jops.mamba2_chunk_scan(*jin, chunk=chunk))
    oracle = np.asarray(jref.ssm_scan_ref(*jin))
    got = tops.mamba2_chunk_scan(*tin, chunk=chunk)
    assert got.dtype == torch.float32
    tol = SCAN_TOL[dtype]
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)
    np.testing.assert_allclose(got.numpy(), oracle, atol=tol, rtol=tol)
    # the final state, against the float64 oracle's
    _, state = ssm_scan_plain(*tin[:5], chunk=chunk)
    _, state64 = tref.ssm_scan_ref(*tin, dtype=torch.float64, return_state=True)
    np.testing.assert_allclose(state.numpy(), state64.numpy(), atol=tol, rtol=tol)


@pytest.mark.parametrize("a_scale", [0.5, 2.0])
def test_smoke_scan_limit_holds_fp32_and_fails_bf16_controls(a_scale, monkeypatch):
    """``chip_smoke.py``'s K5 limit, eps32 sqrt(3 Q) (1 + c) sum|terms| per
    entry: the fp32 scan of bf16 x, B, C stays within it (the smoke's
    ``ssm_checks`` fails otherwise), its own control (dt rounded to
    bfloat16) does not, and neither does the scan with every exp rounded
    to bfloat16."""
    smoke = chip_smoke()
    x, dt, A, B, C, _ = _scan_inputs(np.random.default_rng(6), 1, 256, 4, 64, 64)
    x, B, C = (torch.from_numpy(a).bfloat16() for a in (x, B, C))
    dt, A = torch.from_numpy(dt), torch.from_numpy(A) * a_scale
    checks, _ = smoke.ssm_checks(dict(x=x, dt=dt, A=A, B=B, C=C), 64)
    assert max(checks[p]["vs_float64"][1] for p in ("y", "state")) < 0.25
    zero = torch.zeros_like(A)
    oracle = tref.ssm_scan_ref(x, dt, A, B, C, zero, dtype=torch.float64,
                               return_state=True)
    abs_oracle = tref.ssm_scan_ref(x.abs(), dt, A, B.abs(), C.abs(), zero,
                                   dtype=torch.float64, return_state=True)
    cmax = (dt.double() * A.double()).reshape(1, 4, 64, 4).sum(2).abs().amax(1)
    limits = smoke.scan_limits(abs_oracle, (cmax[:, None, :, None],
                                            cmax[:, :, None, None]), 64)
    bf16_exp(monkeypatch)
    control = ssm_scan_plain(x, dt, A, B, C, 64)
    monkeypatch.undo()
    assert sum(smoke.beyond(c, o, lim)[0] for c, o, lim in zip(control, oracle, limits)) > 0


def test_ssm_wrappers_on_the_cpu():
    """``ssm_scan`` adds ``D * x`` once to ``ssm_scan_state``'s output,
    which on a CPU tensor is the plain version's; the port's oracle is the
    reference's."""
    arrays = _scan_inputs(np.random.default_rng(3), 1, 32, 2, 16, 8)
    x, dt, A, B, C, D = (torch.from_numpy(a) for a in arrays)
    D = D * 1.5
    y, state = ssm_scan_state(x, dt, A, B, C, chunk=16)
    py, pstate = ssm_scan_plain(x, dt, A, B, C, chunk=16)
    assert torch.equal(y, py) and torch.equal(state, pstate)
    assert torch.equal(ssm_scan(x, dt, A, B, C, D, chunk=16),
                       y + D[None, None, :, None] * x)
    np.testing.assert_allclose(
        tref.ssm_scan_ref(x, dt, A, B, C, D).numpy(),
        np.asarray(jref.ssm_scan_ref(*(jnp.asarray(a) for a in
                                       (*arrays[:5], arrays[5] * 1.5)))),
        atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="divide"):
        ssm_scan_plain(x, dt, A, B, C, chunk=24)


# ---------------------------------------------------------------------------
# (b) the layer functions
# ---------------------------------------------------------------------------

def _layer():
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = jblocks.init_mamba_layer(jax.random.key(0), jcfg)
    # a nonzero A_log, dt bias and conv bias, so each reaches the output
    rng = np.random.default_rng(5)
    for k in ("A_log", "dt_bias", "conv_b"):
        jp["mamba"][k] = jnp.asarray(rng.standard_normal(jp["mamba"][k].shape) * 0.5,
                                     jnp.float32)
    tp = model_params_from_reference({"p": jax.tree.map(np.asarray, jp)}, "cpu")["p"]
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gated_norm_and_split(dtype):
    jd, td = DTYPES[dtype]
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    rng = np.random.default_rng(6)
    x, z = (rng.standard_normal((2, 5, 128)).astype(np.float32) for _ in range(2))
    scale = rng.standard_normal(128).astype(np.float32)
    _close(tssm._gated_norm(torch.from_numpy(x).to(td), torch.from_numpy(z).to(td),
                            torch.from_numpy(scale), 1e-5),
           jssm._gated_norm(jnp.asarray(x, jd), jnp.asarray(z, jd), jnp.asarray(scale),
                            1e-5), tol)
    w = rng.standard_normal((2, 3, 2 * 128 + 2 * 16 + 8)).astype(np.float32)
    for got, want in zip(tssm._split_in_proj(cfg, torch.from_numpy(w)),
                         jssm._split_in_proj(jcfg, jnp.asarray(w))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["prefill", "prefill_cached", "short_prefill_cached",
                                  "decode"])
def test_mamba_layer(dtype, case):
    """The pre-norm Mamba2 layer: a prompt without and with a cache, a
    2-token prompt (shorter than the conv's 3-row cache: the reference's
    concatenating branch), and one decode step."""
    jd, td = DTYPES[dtype]
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jcfg, cfg, jp, tp = _layer()
    rng = np.random.default_rng(7)
    s = {"prefill": 24, "prefill_cached": 24, "short_prefill_cached": 2, "decode": 1}[case]
    x = rng.standard_normal((2, s, 64)).astype(np.float32)
    jcache = tcache = index = None
    if case != "prefill":
        conv = rng.standard_normal((2, 3, 160)).astype(np.float32)
        state = rng.standard_normal((2, 8, 16, 16)).astype(np.float32)
        jcache = {"conv": jnp.asarray(conv, jnp.bfloat16),
                  "state": jnp.asarray(state, jnp.bfloat16)}
        tcache = {k: torch.from_numpy(np.asarray(v, np.float32)).bfloat16()
                  for k, v in jcache.items()}
        index = 24 if case == "decode" else None
    jy, jnc, _ = jblocks.apply_mamba_layer(jp, jnp.asarray(x, jd), jcfg, cache=jcache,
                                           cache_index=index)
    ty, tnc, _ = tblocks.apply_mamba_layer(tp, torch.from_numpy(x).to(td), cfg,
                                           cache=tcache, cache_index=index)
    assert ty.dtype == td
    _close(ty, jy, tol, "layer output")
    assert (tnc is None) == (jnc is None)
    for k in (jnc or {}):
        # stored as bf16: a flipped rounding is one step
        _close(tnc[k].to(torch.bfloat16), jnp.asarray(jnc[k], jnp.bfloat16), BF16_TOL,
               f"cache {k}")


def test_prefill_state_is_chunk_steps_final():
    """With a float32 cache and float32 activations the stored state is
    the scan's final state unrounded: K5's plain version's, held to the
    reference's ``chunk_step`` result."""
    jcfg, cfg, jp, tp = _layer()
    x = np.random.default_rng(8).standard_normal((2, 32, 64)).astype(np.float32)
    jc = jssm.init_mamba2_cache(jcfg, 2, jnp.float32)
    tc = tssm.init_mamba2_cache(cfg, 2, torch.float32)
    _, jnc = jssm.mamba2_block(jp["mamba"], jnp.asarray(x), jcfg, cache=jc)
    _, tnc = tssm.mamba2_block(tp["mamba"], torch.from_numpy(x), cfg, cache=tc)
    _close(tnc["state"], jnc["state"], F32_TOL, "final state")
    _close(tnc["conv"], jnc["conv"], F32_TOL, "conv cache")  # in_proj rows


# ---------------------------------------------------------------------------
# (c) the hybrid model: prefill and decode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prompt_len", [2, 40])
def test_prefill_and_decode_match_reference(prompt_len):
    """The reduced config (no super-block), bf16 as served; a 2-token
    prompt takes the conv cache's short branch."""
    model_parity(JModel(jget_config(ARCH).reduced()), Model(get_config(ARCH).reduced()),
                 prompt_len, 3, MODEL_TOL)


@pytest.mark.parametrize("prompt_len", [40, 1088])
def test_variant_with_shared_block_matches_reference_in_float32(prompt_len):
    """Two super-blocks through the shared attention (40 tokens: the full
    impl; 1,088: the chunked impl, K4's plain version), float32."""
    model_parity(_J32(_variant(jget_config(ARCH).reduced())),
                 _T32(_variant(get_config(ARCH).reduced())),
                 prompt_len, 3, F32_TOL, (jnp.float32, torch.float32))


def _reference_run(jm, jp, toks, cache_dtype, decode_tokens=None, steps=3):
    """Prefill ``toks``, then ``steps`` decode steps (the run's own greedy
    tokens unless ``decode_tokens``): ``(name, value)`` of the logits and
    every cache entry, the cache paths and the decode tokens."""
    s = toks.shape[1]
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                 jm.init_cache(2, s + steps + 1, cache_dtype))
    paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(jc)[0]]
    out = [("prefill logits", jl)] + [(f"prefill cache {jax.tree_util.keystr(p)}",
                                       _tree_get(jc, p)) for p in paths]
    decode, tokens = jax.jit(jm.decode_step), []
    for step in range(steps):
        tok = (decode_tokens[step] if decode_tokens is not None else
               np.argmax(np.asarray(jl[:, -1], np.float32), -1)[:, None].astype(np.int32))
        tokens.append(tok)
        jl, jc = decode(jp, jnp.asarray(tok), jc, jnp.int32(s + step))
        out.append((f"decode {step} logits", jl))
    out += [(f"decode cache {jax.tree_util.keystr(p)}", _tree_get(jc, p)) for p in paths]
    return [(n, np.asarray(v, np.float32)) for n, v in out], paths, tokens


def _port_run(tm, tp, toks, paths, decode_tokens):
    """The same run through the port, bfloat16 activations and caches."""
    s, steps = toks.shape[1], len(decode_tokens)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        tm.init_cache(2, s + steps + 1, torch.bfloat16, device="cpu"))
    out = [tl.float().numpy()] + [_tree_get(tc, p).float().numpy().copy() for p in paths]
    for step, tok in enumerate(decode_tokens):
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc, s + step)
        out.append(tl.float().numpy())
    return out + [_tree_get(tc, p).float().numpy() for p in paths]


def _rel(got, want) -> float:
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def test_variant_with_shared_block_matches_reference_in_bfloat16():
    """bfloat16 as served, 40-token prompts of seeds 1 and 4 (the seed
    whose two bfloat16 runs differ most over seeds 0-8) and three decode
    steps on the reference's tokens: every logit and cache entry of the
    port within ``SPREAD_ROOM`` reference spreads of the reference's
    float32 run, and within 1 + ``SPREAD_ROOM`` of its bfloat16 run."""
    jcfg, cfg = _variant(jget_config(ARCH).reduced()), _variant(get_config(ARCH).reduced())
    jm = JModel(jcfg)
    jp = jm.init_params(jax.random.key(0))
    tp = model_params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    for seed in (1, 4):
        toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 40),
                                                    dtype=np.int32)
        ref16, paths, tokens = _reference_run(jm, jp, toks, jnp.bfloat16)
        ref32, _, _ = _reference_run(_J32(jcfg), jp, toks, jnp.float32, tokens)
        port16 = _port_run(Model(cfg), tp, toks, paths, tokens)
        assert len(port16) == len(ref16) == len(ref32)
        spread = max(_rel(a, b) for (_, a), (_, b) in zip(ref16, ref32))
        for got, (name, want16), (_, want32) in zip(port16, ref16, ref32):
            assert _rel(got, want32) <= SPREAD_ROOM * spread, \
                (seed, name, _rel(got, want32), spread)
            assert _rel(got, want16) <= (1 + SPREAD_ROOM) * spread, \
                (seed, name, _rel(got, want16), spread)


def test_params_from_reference_keep_names_and_layouts():
    jm, tm = JModel(_variant(jget_config(ARCH).reduced())), \
        Model(_variant(get_config(ARCH).reduced()))
    jp = jm.init_params(jax.random.key(0))
    tp = model_params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    mine = tm.init_params(torch.Generator().manual_seed(0), "cpu")
    assert sorted(tp) == sorted(mine) == ["embed", "final_norm", "head", "mamba_main",
                                          "mamba_tail", "shared_attn"]
    assert [len(sb) for sb in tp["mamba_main"]] == [len(sb) for sb in mine["mamba_main"]] \
        == [2, 2]
    assert len(tp["mamba_tail"]) == len(mine["mamba_tail"]) == 1
    assert tp["shared_attn"].keys() == mine["shared_attn"].keys()
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp["shared_attn"])[0]:
        assert tuple(_tree_get(mine["shared_attn"], path).shape) == leaf.shape
    np.testing.assert_array_equal(tp["mamba_main"][1][0]["mamba"]["in_proj"].numpy(),
                                  np.asarray(jp["mamba_main"]["mamba"]["in_proj"][1, 0]))
    np.testing.assert_array_equal(tp["mamba_tail"][0]["mamba"]["conv_w"].numpy(),
                                  np.asarray(jp["mamba_tail"]["mamba"]["conv_w"][0]))
    cache, jcache = tm.init_cache(2, 9), jm.init_cache(2, 9)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jcache)[0]:
        assert tuple(_tree_get(cache, path).shape) == leaf.shape, path


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
