"""The port's MLA (``init_mla``, ``mla_attention``, the MLA layers) and
DeepSeek-V2-Lite against the JAX package's.

Weights are the reference's own (``init_mla`` / ``Model.init_params``,
jax key 0), carried across with ``model_params_from_reference``; tokens and
activations are numpy draws from a seed. Tolerances and the treatment of
routing flips between the two bf16 stacks are ``tests/test_torch_moe_layer.py``'s
(``MODEL_TOL``: 4% of the compared tensor's largest magnitude). On the
chunked path (over 1,024 tokens) the prefill's attention is K4's plain
version at q and k ``dn + dr`` wide and v ``dv`` wide, v the view
``kv[..., dn:]`` that the kernel reads in place.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattention
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention_plain, kernel_reads_in_place
from repro_torch.models import Model, model_params_from_reference
from repro_torch.models import attention as tattention
from test_torch_models import MODEL_TOL, _models
from test_torch_moe_layer import (_bf16, _within, end_to_end, serve_against_reference,
                                  teacher_forced)

DEEPSEEK = "deepseek-v2-lite-16b"


def _mla_pair(prompt_len: int, seed: int = 2):
    jcfg, tcfg = jget_config(DEEPSEEK).reduced(), get_config(DEEPSEEK).reduced()
    jp = jattention.init_mla(jax.random.key(0), jcfg.d_model, jcfg.n_heads, jcfg.mla)
    tp = model_params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(seed).standard_normal((2, prompt_len, jcfg.d_model))
    return jcfg, tcfg, jp, tp, jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)


class K4Calls:
    """Records the (q, k, v) of each K4 call from the attention module and
    runs K4's plain version on them."""

    def __init__(self, monkeypatch):
        self.calls = []

        def spy(q, k, v, **kw):
            self.calls.append((q, k, v, kw))
            return flash_attention_plain(q, k, v, **kw)

        monkeypatch.setattr(tattention, "flash_attention", spy)


@pytest.mark.parametrize("prompt_len", [32, 1088])
def test_mla_attention_prefill_and_absorbed_decode_match_reference(prompt_len, monkeypatch):
    """Prefill through ``full_attention`` (32 tokens) or K4's plain version
    (1,088, chunked), then three absorbed decode steps: outputs and the
    latent cache within MODEL_TOL."""
    jcfg, tcfg, jp, tp, x = _mla_pair(prompt_len)
    r, dr = tcfg.mla.kv_lora_rank, tcfg.mla.rope_head_dim
    s_max = prompt_len + 3
    jc = {"ckv": jnp.zeros((2, s_max, r), jnp.bfloat16),
          "kpe": jnp.zeros((2, 1, s_max, dr), jnp.bfloat16)}
    cache = {"ckv": torch.zeros((2, s_max, r), dtype=torch.bfloat16),
             "kpe": torch.zeros((2, 1, s_max, dr), dtype=torch.bfloat16)}
    impl = "full" if prompt_len <= 1024 else "chunked"
    jy, jc = jax.jit(lambda p, x, c: jattention.mla_attention(
        p, x, jcfg, positions=jnp.arange(prompt_len), impl=impl, cache=c))(jp, x, jc)
    k4 = K4Calls(monkeypatch)
    y, got = tattention.mla_attention(tp, _bf16(x), tcfg, positions=torch.arange(prompt_len),
                                      impl=impl, cache=cache)
    assert got is cache and y.dtype == torch.bfloat16
    assert len(k4.calls) == (impl == "chunked")
    _within(y, jy, MODEL_TOL, "prefill output")
    for key in cache:
        _within(cache[key], jc[key], MODEL_TOL, f"prefill {key}")
    rng = np.random.default_rng(5)
    step = jax.jit(lambda p, x, c, i: jattention.mla_attention(
        p, x, jcfg, positions=jnp.full((1,), i, jnp.int32), impl=impl, cache=c,
        cache_index=i))
    for t in range(3):
        xt = jnp.asarray(rng.standard_normal((2, 1, jcfg.d_model)),
                         jnp.float32).astype(jnp.bfloat16)
        jy, jc = step(jp, xt, jc, jnp.int32(prompt_len + t))
        y, cache = tattention.mla_attention(
            tp, _bf16(xt), tcfg, positions=torch.full((1,), prompt_len + t, dtype=torch.int32),
            impl=impl, cache=cache, cache_index=prompt_len + t)
        _within(y, jy, MODEL_TOL, f"decode {t} output")
    assert len(k4.calls) == (impl == "chunked")     # decode is plain PyTorch
    for key in cache:
        _within(cache[key], jc[key], MODEL_TOL, f"decode {key}")


def test_mla_chunked_prefill_reads_v_in_place(monkeypatch):
    """At DeepSeek-V2-Lite's full widths the chunked prefill hands K4 q and
    k (B, 16, S, 192) and v, the view ``kv[..., 128:]`` of the
    reconstructed (B, 16, S, 256) ``kv``: no copy, and within the kernel's
    stride and alignment rule, so the wrapper launches on it as it lies."""
    cfg = get_config(DEEPSEEK)
    gen = torch.Generator().manual_seed(0)
    params = tattention.init_mla(gen, cfg.d_model, cfg.n_heads, cfg.mla, device="cpu")
    x = torch.randn((1, 16, cfg.d_model), generator=gen).bfloat16()
    k4 = K4Calls(monkeypatch)
    tattention.mla_attention(params, x, cfg, positions=torch.arange(16), impl="chunked")
    ((q, k, v, kw),) = k4.calls
    dn, dv = cfg.mla.nope_head_dim, cfg.mla.v_head_dim
    assert q.shape == k.shape == (1, 16, 16, 192) and v.shape == (1, 16, 16, dv)
    assert q.is_contiguous() and k.is_contiguous() and not v.is_contiguous()
    assert v.stride(3) == 1 and v.stride(2) % (dn + dv) == 0
    assert v.storage_offset() % (dn + dv) == dn          # 256 bytes into kv's rows
    assert all(kernel_reads_in_place(t) for t in (q, k, v))
    assert kw == dict(causal=True, tile_k=min(cfg.attn_chunk_kv, 16))


def test_mla_model_params_and_cache_layouts():
    jm, jp, tm, tp = _models(DEEPSEEK)
    made = tm.init_params(torch.Generator().manual_seed(0), "cpu")
    assert sorted(tp) == sorted(made) == ["embed", "final_norm", "head", "layer0", "layers"]
    assert len(tp["layers"]) == len(made["layers"]) == tm.cfg.n_layers - 1
    assert tp["layer0"].keys() == made["layer0"].keys() == {"ln1", "attn", "ln2", "mlp"}
    for got, mine in zip(tp["layers"], made["layers"]):
        assert got.keys() == mine.keys() == {"ln1", "attn", "ln2", "moe"}
        assert got["attn"].keys() == mine["attn"].keys() == {"wq", "wkv_a", "kv_norm",
                                                             "wkv_b", "wo"}
        for key, t in got["attn"].items():
            assert t.shape == mine["attn"][key].shape, key
    np.testing.assert_array_equal(tp["layer0"]["attn"]["wkv_b"].numpy(),
                                  np.asarray(jp["layer0"]["attn"]["wkv_b"]))
    np.testing.assert_array_equal(tp["layers"][0]["moe"]["router"].numpy(),
                                  np.asarray(jp["layers"]["moe"]["router"][0]))
    cache, jc = tm.init_cache(2, 40, device="cpu"), jm.init_cache(2, 40)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    assert all(t.dtype == torch.bfloat16 for t in cache.values())


@pytest.mark.parametrize("prompt_len", [32, 1088])
def test_deepseek_teacher_forced_layers_match_reference(prompt_len):
    teacher_forced(DEEPSEEK, prompt_len)


@pytest.mark.parametrize("prompt_len", [32, 1088])
def test_deepseek_prefill_and_decode_match_reference(prompt_len):
    end_to_end(DEEPSEEK, prompt_len)


@pytest.mark.parametrize("prompt_len", [32, 1088])
def test_serve_deepseek_matches_reference_loop(prompt_len, capsys):
    serve_against_reference(DEEPSEEK, prompt_len, capsys)


def test_deepseek_layer0_is_dense_and_adds_no_aux():
    """Layer 0 runs MLA and the dense gated MLP; the trunk's aux is the 26
    (reduced: 1) MoE layers' alone, as the reference's scan starts from
    layer 0's zero."""
    jm, jp, tm, tp = _models(DEEPSEEK)
    toks = np.random.default_rng(3).integers(0, tm.cfg.vocab_size, (2, 16), dtype=np.int32)
    x = tm._embed_inputs(tp, {"tokens": torch.from_numpy(toks)})
    _, _, aux = tm._trunk(tp, x, torch.arange(16))
    jx = jm._embed_inputs(jp, {"tokens": jnp.asarray(toks)}, jnp.arange(16))
    _, _, jaux = jm._trunk(jp, jx, jnp.arange(16))
    assert 0 < float(aux) < 1
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0.05)
    assert isinstance(Model(get_config(DEEPSEEK)), Model)
