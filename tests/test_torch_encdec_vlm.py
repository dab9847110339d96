"""Whisper-small's encoder-decoder and InternVL2-26B's vision frontend on
the port against the JAX package's.

Weights are the reference's own ``Model.init_params`` (jax key 0), carried
across by ``model_params_from_reference``; frames, patch embeddings and
prompts are numpy draws from a seed. Whisper runs its reduced config with
the encoder at its full 1,500 frames (``EncDecConfig(2, 1500)``) and the
full config's attention blocks (512 / 1,024), so the encoder takes the
chunked impl (K4's plain version, blocks 500 / 750) as it does at full
size; a 1,088-token decoder prompt takes it too, causal for its
self-attention and non-causal for cross attention (1,088 x 1,500).

Tolerances are ``tests/test_torch_models.py``'s ``MODEL_TOL`` (logits and
caches, 4% of the compared tensor's largest magnitude) and
``tests/test_torch_train.py``'s ``GRAD_TOL`` and ``LOSS_RTOL`` (gradients
and the loss).
"""

import argparse
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import EncDecConfig as JEncDecConfig
from repro.models import Model as JModel
from repro.models import model as jmodel
from repro_torch.configs import get_config
from repro_torch.configs.base import EncDecConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import Model, model_params_from_reference
from repro_torch.models import model as tmodel
from repro_torch.runtime import loss_and_grads
from test_torch_models import _close
from test_torch_train import GRAD_TOL, LOSS_RTOL, assert_grads_close

ROOT = Path(__file__).resolve().parents[1]
ENC_POSITIONS = 1500


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as the train test files take it: under the
    suite's 6 workers torch's pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reduced(arch: str, get, enc_cls):
    cfg = get(arch).reduced()
    if cfg.encdec is not None:
        cfg = dataclasses.replace(cfg, encdec=enc_cls(2, ENC_POSITIONS), attn_chunk_q=512,
                                  attn_chunk_kv=1024)
    return cfg


@pytest.fixture(scope="module", params=["whisper-small", "internvl2-26b"])
def models(request):
    return _pair(request.param)


_PAIRS: dict = {}


def _pair(arch: str):
    """The reference and port models of ``arch``'s reduced config (Whisper's
    encoder at 1,500 frames), the reference's weights on both."""
    if arch not in _PAIRS:
        jm = JModel(_reduced(arch, jget_config, JEncDecConfig))
        tm = Model(_reduced(arch, get_config, EncDecConfig))
        jp = jax.jit(jm.init_params)(jax.random.key(0))
        tp = model_params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
        _PAIRS[arch] = (jm, jp, tm, tp)
    return _PAIRS[arch]


def _inputs(cfg, batch: int, seq: int, seed: int = 1) -> dict:
    """Tokens ``(batch, seq)`` and the family's stub frontend input, numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32)}
    if cfg.frontend == "audio":
        out["frames"] = rng.normal(size=(batch, cfg.encdec.n_enc_positions,
                                         tmodel.FRONTEND_DIM["audio"])).astype(np.float32)
    if cfg.frontend == "vision":
        out["patch_embeds"] = rng.normal(size=(batch, cfg.n_frontend_tokens,
                                               tmodel.FRONTEND_DIM["vision"])).astype(np.float32)
    return out


def _j(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def test_frontend_dims_match_reference():
    assert tmodel.FRONTEND_DIM == jmodel.FRONTEND_DIM


@pytest.mark.parametrize("d", [768, 64, 7, 2])
def test_sinusoidal_positions_match_reference(d):
    """Over 2,048 positions (the decoder's prompt in the smoke); the
    frequencies' denominator is max(1, d/2 - 1). An angle reaches 2,047
    rad, where XLA's and PyTorch's fp32 exp may part by an ulp of the
    frequency, which moves the angle, and so a sine, by up to 2,047 x
    2^-23 (2.4e-4); the limit is two such steps."""
    pos = np.arange(2048)
    want = np.asarray(jmodel.sinusoidal_positions(jnp.asarray(pos), d))
    got = tmodel.sinusoidal_positions(torch.from_numpy(pos), d)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2048, 2 * (d // 2))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2 * 2047 * 2.0 ** -23)


# ---------------------------------------------------------------------------
# Whisper: prefill, caches, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prompt_len", [8, 1088])
def test_whisper_prefill_and_decode_match_reference(prompt_len):
    """The encoder over 1,500 frames (chunked), the decoder's prompt of 8
    tokens (full) or 1,088 (chunked: self-attention causal, cross 1,088 x
    1,500 non-causal); the logits, the self and cross caches, then three
    decode steps on the same tokens."""
    jm, jp, tm, tp = _pair("whisper-small")
    cfg = tm.cfg
    assert tm._impl(prompt_len) == jm._impl(prompt_len)
    assert tm._impl(ENC_POSITIONS) == jm._impl(ENC_POSITIONS) == "chunked"
    batch = _inputs(cfg, 2, prompt_len + 3)
    prompt = {**batch, "tokens": batch["tokens"][:, :prompt_len]}
    s_max = prompt_len + 4
    jl, jc = jax.jit(jm.prefill)(jp, _j(prompt), jm.init_cache(2, s_max))
    cache = tm.init_cache(2, s_max, device="cpu")
    tl, tc = tm.prefill(tp, _t(prompt), cache)
    assert tc is cache and tl.dtype == torch.bfloat16
    assert int(tc["has_cross"]) == int(jc["has_cross"]) == 1
    _close(tl, jl, "prefill logits")
    for part in ("self", "cross"):
        for kv in ("k", "v"):
            assert tuple(tc[part][kv].shape) == jc[part][kv].shape
            _close(tc[part][kv], jc[part][kv], f"{part} {kv} cache after prefill")
    decode = jax.jit(jm.decode_step)
    for i in range(prompt_len, prompt_len + 3):
        tok = batch["tokens"][:, i:i + 1]
        jl, jc = decode(jp, jnp.asarray(tok), jc, jnp.int32(i))
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc, i)
        _close(tl, jl, f"decode logits at {i}")
    _close(tc["self"]["k"], jc["self"]["k"], "self k cache after decode")
    _close(tc["self"]["v"], jc["self"]["v"], "self v cache after decode")


def test_whisper_decode_matches_teacher_forcing():
    """Prefill + decode against the full-sequence forward (encoder output
    into ``_trunk`` without a cache), on the port, and the forward against
    the reference's: ``tests/test_models_smoke.py``'s serving invariant,
    with the encoder over 1,500 frames and a float32 cache."""
    jm, jp, tm, tp = _pair("whisper-small")
    batch = _inputs(tm.cfg, 2, 17, seed=2)

    def port_full(b):
        positions = torch.arange(16)
        x = tm._trunk_inputs(tp, {"tokens": b["tokens"][:, :16]}, positions)
        x, _, _ = tm._trunk(tp, x, positions, enc_out=tm._encoder(tp, b["frames"]))
        return tm._logits(tp, x)

    def ref_full(p, b):
        positions = jnp.arange(16)
        x = jm._embed_inputs(p, {"tokens": b["tokens"][:, :16]}, positions)
        x, _, _ = jm._trunk(p, x, positions, enc_out=jm._encoder(p, b["frames"]))
        return jm._logits(p, x)

    full = port_full(_t(batch))
    _close(full, jax.jit(ref_full)(jp, _j(batch)), "teacher-forced logits")
    cache = tm.init_cache(2, 32, dtype=torch.float32, device="cpu")
    lg, cache = tm.prefill(tp, _t({**batch, "tokens": batch["tokens"][:, :8]}), cache)
    np.testing.assert_allclose(lg[:, 0].float().numpy(), full[:, 7].float().numpy(),
                               rtol=3e-2, atol=6e-2)
    for i in range(8, 12):
        lg, cache = tm.decode_step(tp, torch.from_numpy(batch["tokens"][:, i:i + 1]),
                                   cache, i)
        np.testing.assert_allclose(lg[:, 0].float().numpy(), full[:, i].float().numpy(),
                                   rtol=3e-2, atol=6e-2)


# ---------------------------------------------------------------------------
# InternVL2: the vision frontend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_patches", [True, False])
def test_internvl2_prefill_and_decode_match_reference(with_patches):
    """A 32-token prompt whose first 8 positions take the projected patch
    embeddings (or, without them, text only), then two decode steps; other
    patches give other logits."""
    jm, jp, tm, tp = _pair("internvl2-26b")
    batch = _inputs(tm.cfg, 2, 34)
    prompt = {**batch, "tokens": batch["tokens"][:, :32]}
    if not with_patches:
        del prompt["patch_embeds"]
    jl, jc = jax.jit(jm.prefill)(jp, _j(prompt), jm.init_cache(2, 36))
    tl, tc = tm.prefill(tp, _t(prompt), tm.init_cache(2, 36, device="cpu"))
    _close(tl, jl, "prefill logits")
    _close(tc["k"], jc["k"], "k cache")
    _close(tc["v"], jc["v"], "v cache")
    for i in (32, 33):
        tok = batch["tokens"][:, i:i + 1]
        jl, jc = jax.jit(jm.decode_step)(jp, jnp.asarray(tok), jc, jnp.int32(i))
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc, i)
        _close(tl, jl, f"decode logits at {i}")
    if with_patches:  # other patches, other logits: the frontend is live
        first = tm.prefill(tp, _t(prompt), tm.init_cache(2, 36, device="cpu"))[0]
        other = tm.prefill(tp, _t({**prompt, "patch_embeds": -prompt["patch_embeds"]}),
                           tm.init_cache(2, 36, device="cpu"))[0]
        assert not torch.equal(other, first)


# ---------------------------------------------------------------------------
# train_loss and its gradients
# ---------------------------------------------------------------------------

def test_train_loss_and_grads_match_reference(models):
    """``jax.value_and_grad(train_loss)`` with the frontend's input (Whisper's
    1,500 frames, one row to keep the suite's time; InternVL2's 8 patch
    embeddings, two rows) against the port's ``loss_and_grads``, remat
    "full": the loss within LOSS_RTOL, every leaf within GRAD_TOL of its
    largest |gradient|, the frontend's included."""
    jm, jp, tm, tp = models
    batch = _inputs(tm.cfg, 1 if tm.cfg.encdec is not None else 2, 33, seed=3)
    fn = lambda p: jm.train_loss(p, _j(batch))  # noqa: E731
    (jloss, _), jg = jax.jit(jax.value_and_grad(fn, has_aux=True))(jp)
    loss, metrics, grads = loss_and_grads(tm, tp, _t(batch))
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL[torch.bfloat16] * abs(float(jloss))
    assert float(grads["frontend"]["w"].abs().max()) > 0
    assert_grads_close(grads, jax.tree.map(np.asarray, jg), GRAD_TOL)


# ---------------------------------------------------------------------------
# serving and the import guard
# ---------------------------------------------------------------------------

def test_serve_lm_refuses_whisper_before_drawing_weights():
    """serve_lm gives token prompts only; the reference fails on the same
    input at ``batch['frames']``. The port refuses before drawing weights."""
    args = argparse.Namespace(arch="whisper-small", smoke=True, requests=2, slots=2,
                              prompt_len=8, gen_len=2, technique="GSS", device="cpu")
    with mock.patch.object(tmodel.Model, "init_params", side_effect=AssertionError), \
            pytest.raises(ValueError, match="frames"):
        tserve.serve_lm(args)


_GUARD = textwrap.dedent("""
    import importlib, importlib.abc, sys, argparse

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import Model
    from repro_torch.models.model import FRONTEND_DIM
    from repro_torch.runtime import loss_and_grads
    gen = torch.Generator()
    gen.manual_seed(0)
    for arch in ("whisper-small", "internvl2-26b"):
        cfg = get_config(arch).reduced()
        model = Model(cfg)
        params = model.init_params(gen, "cpu")
        batch = {"tokens": torch.zeros(2, 8, dtype=torch.long)}
        if cfg.encdec is not None:
            batch["frames"] = torch.randn(2, cfg.encdec.n_enc_positions,
                                          FRONTEND_DIM["audio"], generator=gen)
        else:
            batch["patch_embeds"] = torch.randn(2, cfg.n_frontend_tokens,
                                                FRONTEND_DIM["vision"], generator=gen)
        logits, cache = model.prefill(params, batch, model.init_cache(2, 10, device="cpu"))
        logits, cache = model.decode_step(params, logits[:, -1].argmax(-1)[:, None],
                                          cache, 8)
        assert logits.shape == (2, 1, cfg.padded_vocab)
        _, _, grads = loss_and_grads(model, params,
                                     {**batch, "tokens": torch.zeros(2, 9, dtype=torch.long)})
        assert float(grads["frontend"]["w"].abs().max()) > 0
    res = serve_lm(argparse.Namespace(arch="internvl2-26b", smoke=True, requests=2,
                                      slots=2, prompt_len=16, gen_len=2, technique="GSS",
                                      device="cpu"))
    assert res.tokens[0].shape == (2, 2)
    assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro") for m in sys.modules)
    print("ok")
""")


def test_encdec_and_vision_import_no_jax():
    """Whisper and InternVL2 through prefill, decode and the loss, and
    serve_lm's text-only InternVL2, with jax and the reference blocked."""
    out = subprocess.run([sys.executable, "-c", _GUARD], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
