"""Shared building blocks (the port's copy of ``models/layers.py``).

Params are nested dicts of tensors, as in the reference. Every initializer
takes an explicit ``torch.Generator`` and device: the reference draws
from ``jax.random`` keys, which give other numbers from the same seed, so
a test that needs both packages on the same weights converts the
reference's arrays (``models/model.py:model_params_from_reference``,
``vee/ml_apps.py:moe_params_from_reference``). On the ``meta`` device
the initializers draw nothing: shapes only, for counting parameters.

dtype policy, as the reference's: params stay in fp32 (the master copy),
activations are bf16 from the embedding on, and ``dense`` casts a weight
to the activation's type at each use; ``rms_norm`` and ``layer_norm``
compute in fp32 and cast back. The reference's sharding annotations
(``runtime/pspec.shard``) are the identity without a mesh, so the port
leaves them out until the mesh layer is ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["Params", "he_init", "init_mlp", "rms_norm", "layer_norm", "dense",
           "rope_freqs", "apply_rope", "mlp", "init_embedding", "embed",
           "unembed"]

Params = dict


def _normal(generator: torch.Generator | None, shape, device,
            dtype) -> torch.Tensor:
    """Standard normal draws on ``device``; shapes only on ``meta``."""
    if device.type == "meta":
        return torch.empty(tuple(shape), device=device, dtype=dtype)
    return torch.randn(tuple(shape), generator=generator, device=device,
                       dtype=dtype)


def he_init(generator: torch.Generator, shape, fan_in: int,
            device=None, dtype=torch.float32) -> torch.Tensor:
    """Normal draws scaled by ``1/sqrt(fan_in)``, made on ``device``.

    ``device`` defaults to the generator's; a CUDA generator draws on the
    card, so full-width weights never pass through the host.
    """
    device = generator.device if device is None else torch.device(device)
    return _normal(generator, shape, device, dtype) * (1.0 / math.sqrt(fan_in))


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             gated: bool = True, bias: bool = False, device=None,
             dtype=torch.float32) -> Params:
    """``wi (d_model, 2*d_ff or d_ff)`` and ``wo (d_ff, d_model)``, He-scaled."""
    wi_cols = 2 * d_ff if gated else d_ff
    p = {
        "wi": he_init(generator, (d_model, wi_cols), d_model, device, dtype),
        "wo": he_init(generator, (d_ff, d_model), d_ff, device, dtype),
    }
    if bias:
        dev = p["wi"].device
        p["bi"] = torch.zeros((wi_cols,), dtype=dtype, device=dev)
        p["bo"] = torch.zeros((d_model,), dtype=dtype, device=dev)
    return p


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS normalisation in fp32, cast back to ``x``'s type."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer normalisation in fp32, cast back to ``x``'s type."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ w`` with the weight cast to ``x``'s type at this use."""
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    """``1 / theta^(2i / dim)`` for i < dim / 2, fp32."""
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Interleaved RoPE: x ``(..., S, dh)``, pairs ``(0::2, 1::2)``.

    ``x`` times the fp32 ``cos`` and ``sin`` promotes to fp32, as in the
    reference; the result is cast back to ``x``'s type.
    """
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                          # (dh/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs       # (S, dh/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp(params: Params, x: torch.Tensor, gated: bool = True,
        act: str = "silu") -> torch.Tensor:
    """Gated (llama-style) or plain MLP."""
    h = dense(x, params["wi"], params.get("bi"))
    if gated:
        g, u = torch.chunk(h, 2, dim=-1)
        h = F.silu(g) * u if act == "silu" else _gelu(g) * u
    else:
        h = _gelu(h) if act == "gelu" else F.silu(h)
    return dense(h, params["wo"], params.get("bo"))


# ---------------------------------------------------------------------------
# embedding / LM head
# ---------------------------------------------------------------------------

def init_embedding(generator: torch.Generator, vocab: int, d_model: int,
                   device=None, dtype=torch.float32) -> Params:
    """``table (vocab, d_model)``, normal draws scaled by 0.02."""
    device = generator.device if device is None else torch.device(device)
    return {"table": _normal(generator, (vocab, d_model), device, dtype) * 0.02}


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Row gather of the table: the no-mesh branch of the reference's
    ``vocab_parallel.vp_embed``."""
    return params["table"][tokens]


def unembed(params: Params, x: torch.Tensor,
            table: torch.Tensor | None = None) -> torch.Tensor:
    """Logits over the padded vocab, in ``x``'s type (bf16 in the model).
    ``table`` for tied embeddings."""
    w = table.T if table is not None else params["w"]
    return x @ w.to(x.dtype)
