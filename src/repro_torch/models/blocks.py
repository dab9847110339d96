"""Decoder layers (the port's copy of ``models/blocks.py``: the dense, MoE,
MLA, Mamba2, RWKV6 and Whisper layers).

Every layer apply has the reference's uniform signature

    apply(params, x, cfg, *, positions, impl, cache, cache_index) -> (x, cache, aux)

``aux`` is a scalar: the MoE load-balance loss (times its weight) in the
MoE and MLA-with-MoE layers, 0 elsewhere; the Mamba2 and RWKV6 layers
take no positions and no attention impl. Whisper's encoder layer takes
only ``impl`` and returns x; its decoder layer also takes ``cross_kv``.
"""

from __future__ import annotations

import torch

from .attention import gqa_attention, init_attention, init_mla, mla_attention
from .layers import Params, init_mlp, layer_norm, mlp, rms_norm
from .moe import init_moe, moe_block
from .rwkv import init_rwkv6, rwkv6_channel_mix, rwkv6_time_mix
from .ssm import init_mamba2, mamba2_block

__all__ = ["ZERO", "init_dense_layer", "apply_dense_layer", "init_moe_layer",
           "apply_moe_layer", "init_mla_layer", "apply_mla_layer",
           "init_mamba_layer", "apply_mamba_layer", "init_rwkv_layer",
           "apply_rwkv_layer", "init_whisper_layer", "apply_whisper_enc_layer",
           "apply_whisper_dec_layer"]

#: the aux loss of a layer that has none
ZERO = 0.0


def init_dense_layer(generator: torch.Generator, cfg, device=None,
                     dtype=torch.float32) -> Params:
    """One dense GQA layer: norms, attention and the gated MLP."""
    device = generator.device if device is None else torch.device(device)
    return {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "attn": init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, bias=cfg.qkv_bias, device=device,
                               dtype=dtype),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, gated=True,
                        device=device, dtype=dtype),
    }


def apply_dense_layer(params: Params, x: torch.Tensor, cfg, *, positions,
                      impl: str, cache, cache_index):
    """Pre-norm attention and MLP, each added to the residual."""
    h, cache = gqa_attention(params["attn"], rms_norm(x, params["ln1"], cfg.norm_eps),
                             cfg, positions=positions, impl=impl, cache=cache,
                             cache_index=cache_index)
    x = x + h
    x = x + mlp(params["mlp"], rms_norm(x, params["ln2"], cfg.norm_eps))
    return x, cache, ZERO


# ---------------------------------------------------------------------------
# GQA + MoE layer (Qwen1.5-MoE)
# ---------------------------------------------------------------------------

def init_moe_layer(generator: torch.Generator, cfg, device=None,
                   dtype=torch.float32) -> Params:
    """One MoE layer: norms, GQA attention and the routed + shared experts."""
    device = generator.device if device is None else torch.device(device)
    return {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "attn": init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, bias=cfg.qkv_bias, device=device,
                               dtype=dtype),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "moe": init_moe(generator, cfg.d_model, cfg.moe, device=device, dtype=dtype),
    }


def apply_moe_layer(params: Params, x: torch.Tensor, cfg, *, positions,
                    impl: str, cache, cache_index):
    """Pre-norm attention, then ``moe_block`` on the pre-normed residual;
    the block's aux loss is the layer's."""
    h, cache = gqa_attention(params["attn"], rms_norm(x, params["ln1"], cfg.norm_eps),
                             cfg, positions=positions, impl=impl, cache=cache,
                             cache_index=cache_index)
    x = x + h
    h, aux = moe_block(params["moe"], rms_norm(x, params["ln2"], cfg.norm_eps), cfg)
    return x + h, cache, aux


# ---------------------------------------------------------------------------
# MLA + MoE layer (DeepSeek-V2-Lite; layer 0 has a dense FFN)
# ---------------------------------------------------------------------------

def init_mla_layer(generator: torch.Generator, cfg, dense_ffn: bool, device=None,
                   dtype=torch.float32) -> Params:
    """One MLA layer: norms, MLA, and the dense gated MLP (``dense_ffn``)
    or the MoE block."""
    device = generator.device if device is None else torch.device(device)
    p = {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "attn": init_mla(generator, cfg.d_model, cfg.n_heads, cfg.mla, device=device,
                         dtype=dtype),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if dense_ffn:
        p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff, gated=True,
                            device=device, dtype=dtype)
    else:
        p["moe"] = init_moe(generator, cfg.d_model, cfg.moe, device=device, dtype=dtype)
    return p


def apply_mla_layer(params: Params, x: torch.Tensor, cfg, *, positions,
                    impl: str, cache, cache_index):
    """Pre-norm MLA, then the MoE block or the dense MLP."""
    h, cache = mla_attention(params["attn"], rms_norm(x, params["ln1"], cfg.norm_eps),
                             cfg, positions=positions, impl=impl, cache=cache,
                             cache_index=cache_index)
    x = x + h
    h2 = rms_norm(x, params["ln2"], cfg.norm_eps)
    if "moe" in params:
        h, aux = moe_block(params["moe"], h2, cfg)
    else:
        h, aux = mlp(params["mlp"], h2), ZERO
    return x + h, cache, aux


# ---------------------------------------------------------------------------
# Mamba2 layer (Zamba2's trunk)
# ---------------------------------------------------------------------------

def init_mamba_layer(generator: torch.Generator, cfg, device=None,
                     dtype=torch.float32) -> Params:
    """The pre-norm scale and one Mamba2 block."""
    mamba = init_mamba2(generator, cfg, device, dtype)
    return {"ln": torch.ones((cfg.d_model,), dtype=dtype,
                             device=mamba["in_proj"].device),
            "mamba": mamba}


def apply_mamba_layer(params: Params, x: torch.Tensor, cfg, *, cache, cache_index):
    """Pre-norm Mamba2 block added to the residual."""
    h, cache = mamba2_block(params["mamba"], rms_norm(x, params["ln"], cfg.norm_eps),
                            cfg, cache=cache, cache_index=cache_index)
    return x + h, cache, ZERO


# ---------------------------------------------------------------------------
# RWKV6 layer
# ---------------------------------------------------------------------------

def init_rwkv_layer(generator: torch.Generator, cfg, device=None,
                    dtype=torch.float32) -> Params:
    """Time mix, channel mix and their two layer norms."""
    p = init_rwkv6(generator, cfg, device, dtype)
    dev = p["tm"]["wr"].device
    for name, value in (("ln1", 1.0), ("ln1b", 0.0), ("ln2", 1.0), ("ln2b", 0.0)):
        p[name] = torch.full((cfg.d_model,), value, dtype=dtype, device=dev)
    return p


def apply_rwkv_layer(params: Params, x: torch.Tensor, cfg, *, cache, cache_index):
    """Time mix then channel mix, each layer-normed and added to the
    residual; the new cache entries are the two mixes' together."""
    h, tm_cache = rwkv6_time_mix(
        params, layer_norm(x, params["ln1"], params["ln1b"], cfg.norm_eps), cfg,
        cache=cache, cache_index=cache_index)
    x = x + h
    h, cm_cache = rwkv6_channel_mix(
        params, layer_norm(x, params["ln2"], params["ln2b"], cfg.norm_eps), cache=cache)
    new_cache = None
    if cache is not None:
        new_cache = {**(tm_cache or {}), **(cm_cache or {})}
    return x + h, new_cache, ZERO


# ---------------------------------------------------------------------------
# Whisper encoder / decoder layers (LayerNorm, GELU MLP, bidirectional encoder)
# ---------------------------------------------------------------------------

def init_whisper_layer(generator: torch.Generator, cfg, cross: bool, device=None,
                       dtype=torch.float32) -> Params:
    """One Whisper layer: biased self-attention, a biased non-gated MLP and
    their layer norms; ``cross`` (a decoder layer) adds the cross attention
    and its norm."""
    device = generator.device if device is None else torch.device(device)

    def attention():
        return init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, bias=True, device=device, dtype=dtype)

    def norm(value: float):
        return torch.full((cfg.d_model,), value, dtype=dtype, device=device)

    p = {"ln1": norm(1.0), "ln1b": norm(0.0), "attn": attention(),
         "ln2": norm(1.0), "ln2b": norm(0.0),
         "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, gated=False, bias=True,
                         device=device, dtype=dtype)}
    if cross:
        p.update(lnx=norm(1.0), lnxb=norm(0.0), cross=attention())
    return p


def apply_whisper_enc_layer(params: Params, x: torch.Tensor, cfg, *, impl: str):
    """Non-causal self-attention without positions, then the GELU MLP, each
    layer-normed and added to the residual."""
    h, _ = gqa_attention(params["attn"],
                         layer_norm(x, params["ln1"], params["ln1b"], cfg.norm_eps),
                         cfg, positions=None, impl=impl, causal=False)
    x = x + h
    return x + mlp(params["mlp"], layer_norm(x, params["ln2"], params["ln2b"], cfg.norm_eps),
                   gated=False, act="gelu")


def apply_whisper_dec_layer(params: Params, x: torch.Tensor, cfg, *, positions,
                            impl: str, cache, cache_index, cross_kv: tuple):
    """Causal self-attention (RoPE where the config has a ``rope_theta``,
    as the reference's), cross attention to ``cross_kv``, then the GELU
    MLP, each layer-normed and added to the residual."""
    h, cache = gqa_attention(params["attn"],
                             layer_norm(x, params["ln1"], params["ln1b"], cfg.norm_eps),
                             cfg, positions=positions, impl=impl, cache=cache,
                             cache_index=cache_index)
    x = x + h
    h, _ = gqa_attention(params["cross"],
                         layer_norm(x, params["lnx"], params["lnxb"], cfg.norm_eps),
                         cfg, positions=None, impl=impl, cross_kv=cross_kv)
    x = x + h
    x = x + mlp(params["mlp"], layer_norm(x, params["ln2"], params["ln2b"], cfg.norm_eps),
                gated=False, act="gelu")
    return x, cache, ZERO
