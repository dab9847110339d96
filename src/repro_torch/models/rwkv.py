"""RWKV6 ("Finch") block: token-shift mixing and data-dependent-decay WKV
(the port's copy of ``models/rwkv.py``).

Recurrence per head (state S in R^{dh x dh}):

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(-exp(wraw_t))

Prefill runs the chunked closed form, ``_wkv_chunked``: K6
(``kernels/rwkv6_scan.py``) — the kernel on a CUDA tensor, its plain
version on a CPU tensor — which also returns the final state for the
decode cache. Decode (one token with a cache) is the O(1) recurrent update
in plain PyTorch, as the reference computes it outside any kernel.

Decode cache = ``{'shift_tm', 'shift_cm': (B, 1, d), 'state': (B, H, dh,
dh)}``, bf16 by default as in the reference: the prefill's fp32 final
state is rounded when stored, and each decode step reads the bf16 state,
computes in fp32 and stores bf16 again. The layer functions return the new
entries; ``models/model.py`` writes them into its stacked cache in place.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..kernels.rwkv6_scan import rwkv6_scan_state
from .layers import Params, dense, he_init

__all__ = ["init_rwkv6", "rwkv6_time_mix", "rwkv6_channel_mix", "init_rwkv6_cache"]


def _dims(cfg):
    dh = cfg.rwkv.head_dim
    nh = cfg.n_heads  # the wkv head count (d_model / dh)
    return nh, dh, nh * dh


def init_rwkv6(generator: torch.Generator, cfg, device=None,
               dtype=torch.float32) -> Params:
    """Time-mix and channel-mix weights, the reference's initial values."""
    device = generator.device if device is None else torch.device(device)
    d = cfg.d_model
    nh, dh, dk = _dims(cfg)
    lora = cfg.rwkv.decay_lora

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    def he(shape, fan_in):
        return he_init(generator, shape, fan_in, device, dtype)

    return {
        "tm": {  # time mix
            "mu_r": full((d,), 0.5), "mu_k": full((d,), 0.5), "mu_v": full((d,), 0.5),
            "mu_g": full((d,), 0.5), "mu_w": full((d,), 0.5),
            "wr": he((d, dk), d), "wk": he((d, dk), d), "wv": he((d, dk), d),
            "wg": he((d, dk), d), "wo": he((dk, d), dk),
            "w_base": full((dk,), -0.6),           # decay bias (pre -exp(.))
            "w_lora_a": he((d, lora), d),
            "w_lora_b": full((lora, dk), 0.0),
            "u": full((nh, dh), 0.0),              # bonus
            "ln_x": full((dk,), 1.0),              # per-head group norm
        },
        "cm": {  # channel mix
            "mu_k": full((d,), 0.5), "mu_r": full((d,), 0.5),
            "wk": he((d, cfg.d_ff), d), "wv": he((cfg.d_ff, d), cfg.d_ff),
            "wr": he((d, d), d),
        },
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x ``(B, S, d)``; prev ``(B, 1, d)`` the previous segment's last token."""
    return torch.cat([prev, x[:, :-1]], dim=1)


def _shifted(x: torch.Tensor, cache: Params | None, key: str) -> torch.Tensor:
    """The token-shifted input, the reference's three cases: a prompt
    shifts in the cached (or a zero) token; one token with a cache is
    shifted to the cached token; one token without a cache to zeros."""
    b, s, d = x.shape
    if cache is None:
        if s == 1:
            return torch.zeros_like(x)
        prev = torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
    else:
        prev = cache[key].to(x.dtype)
    return _token_shift(x, prev) if s > 1 else prev


def _mix(x: torch.Tensor, xs: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return x + (xs - x) * mu.to(x.dtype)


def _group_norm(y: torch.Tensor, scale: torch.Tensor, nh: int, dh: int,
                eps: float = 1e-5) -> torch.Tensor:
    """Per-head LayerNorm over dh (RWKV's ln_x), in fp32, cast back."""
    b, s, _ = y.shape
    yh = y.reshape(b, s, nh, dh).float()
    mu = yh.mean(-1, keepdim=True)
    var = ((yh - mu) ** 2).mean(-1, keepdim=True)
    yh = (yh - mu) * torch.rsqrt(var + eps)
    return (yh.reshape(b, s, nh * dh) * scale.float()).to(y.dtype)


def _wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 logw: torch.Tensor, u: torch.Tensor, chunk: int):
    """r, k, v, logw ``(B, H, S, dh)`` (logw <= 0); u ``(H, dh)``. Returns
    the ``(B, H, S, dh)`` fp32 outputs and the final state ``(B, H, dh,
    dh)``: K6 on a CUDA tensor, its plain version on a CPU tensor. Kept
    under the reference's name (``repro/models/rwkv.py:_wkv_chunked``) so
    that its counterpart is found, and its final state tested, by name."""
    return rwkv6_scan_state(r, k, v, logw, u, chunk)


def rwkv6_time_mix(params: Params, x: torch.Tensor, cfg: Any, *,
                   cache: Params | None = None, cache_index=None):
    """Returns ``(out, new cache entries or None)``."""
    nh, dh, dk = _dims(cfg)
    b, s, d = x.shape
    p = params["tm"]
    xs = _shifted(x, cache, "shift_tm")

    r = dense(_mix(x, xs, p["mu_r"]), p["wr"])
    k = dense(_mix(x, xs, p["mu_k"]), p["wk"])
    v = dense(_mix(x, xs, p["mu_v"]), p["wv"])
    g = dense(_mix(x, xs, p["mu_g"]), p["wg"])
    # Finch data-dependent decay (low-rank)
    wraw = dense(_mix(x, xs, p["mu_w"]), p["w_lora_a"])
    wraw = dense(torch.tanh(wraw), p["w_lora_b"]) + p["w_base"].to(x.dtype)
    # clamp: per-step decay saturates at e^-30 (a full reset); unbounded
    # logw magnitudes destroy the chunked form's fp32 cumsum
    logw = -torch.exp(torch.clamp(wraw.float(), max=3.4))  # in [-30, 0]

    def heads(t):  # (B, S, dk) -> (B, H, S, dh), a transposed view
        return t.reshape(b, s, nh, dh).transpose(1, 2)

    r_h, k_h, v_h, logw_h = heads(r), heads(k), heads(v), heads(logw)
    u = p["u"].float()

    if cache is not None and cache_index is not None and s == 1:
        state = cache["state"].float()                          # (B, H, dh, dh)
        r1, k1, v1 = (t[:, :, 0].float() for t in (r_h, k_h, v_h))
        y = torch.einsum("bhc,bhcd->bhd", r1, state) \
            + torch.einsum("bhc,bhc,bhd->bhd", r1 * u[None], k1, v1)
        w1 = torch.exp(logw_h[:, :, 0])
        state = state * w1[..., None] + k1[..., :, None] * v1[..., None, :]
        y = y.reshape(b, 1, dk).to(x.dtype)
        new_cache = {"shift_tm": x, "state": state.to(cache["state"].dtype)}
    else:
        yh, final = _wkv_chunked(r_h, k_h, v_h, logw_h, u, cfg.rwkv.chunk)
        y = yh.transpose(1, 2).reshape(b, s, dk).to(x.dtype)
        new_cache = None
        if cache is not None:
            new_cache = {"shift_tm": x[:, -1:], "state": final.to(cache["state"].dtype)}

    y = _group_norm(y, p["ln_x"], nh, dh)
    y = y * F.silu(g)
    return dense(y, p["wo"]), new_cache


def rwkv6_channel_mix(params: Params, x: torch.Tensor, *, cache: Params | None = None):
    """Returns ``(out, {'shift_cm'} or None)``."""
    p = params["cm"]
    xs = _shifted(x, cache, "shift_cm")
    k = dense(_mix(x, xs, p["mu_k"]), p["wk"])
    k = torch.square(torch.relu(k))
    kv = dense(k, p["wv"])
    r = torch.sigmoid(dense(_mix(x, xs, p["mu_r"]), p["wr"]))
    new_cache = {"shift_cm": x[:, -1:]} if cache is not None else None
    return r * kv, new_cache


def init_rwkv6_cache(cfg, batch: int, dtype=torch.bfloat16, device=None) -> Params:
    """One layer's zeroed cache."""
    nh, dh, _ = _dims(cfg)
    return {
        "shift_tm": torch.zeros((batch, 1, cfg.d_model), dtype=dtype, device=device),
        "shift_cm": torch.zeros((batch, 1, cfg.d_model), dtype=dtype, device=device),
        "state": torch.zeros((batch, nh, dh, dh), dtype=dtype, device=device),
    }
