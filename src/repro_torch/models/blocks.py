"""Decoder layers (the port's copy of the dense part of ``models/blocks.py``).

Every layer apply has the reference's uniform signature

    apply(params, x, cfg, *, positions, impl, cache, cache_index) -> (x, cache, aux)

``aux`` is a scalar (the MoE load-balance loss; 0 for a dense layer). The
MoE, MLA, Mamba2, RWKV6 and Whisper layers wait for ROADMAP A11.1-A11.5.
"""

from __future__ import annotations

import torch

from .attention import gqa_attention, init_attention
from .layers import Params, init_mlp, mlp, rms_norm

__all__ = ["ZERO", "init_dense_layer", "apply_dense_layer"]

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
