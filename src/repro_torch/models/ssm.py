"""Mamba2 (SSD) block (the port's copy of ``models/ssm.py``).

Prefill runs the causal conv and the chunked SSD scan: K5
(``kernels/ssm_scan.py:ssm_scan_state``) — the kernel on a CUDA tensor,
its plain version (the reference's ``chunk_step``) on a CPU tensor —
which also returns the final state for the decode cache. ``D * x`` is added after the scan, once,
where the reference adds it. Decode is the O(1) recurrent update
``state <- exp(dt A) state + dt B x`` in plain PyTorch, as the reference
computes it outside any kernel.

Cache = ``{'conv': (B, W-1, d_conv_in), 'state': (B, H, dh, N)}``, bf16
by default as in the reference (the fp32 state is rounded when stored).
The block returns the new entries; ``models/model.py`` writes them into
its stacked cache in place.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..kernels.ssm_scan import ssm_scan_state
from .layers import Params, dense, he_init

__all__ = ["init_mamba2", "mamba2_block", "init_mamba2_cache"]


def _dims(cfg):
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    n_heads = d_inner // ssm.head_dim
    return d_inner, n_heads, ssm.d_state, ssm.head_dim, ssm.conv_width


def init_mamba2(generator: torch.Generator, cfg, device=None,
                dtype=torch.float32) -> Params:
    """The block's weights, the reference's initial values."""
    device = generator.device if device is None else torch.device(device)
    d = cfg.d_model
    di, nh, n, dh, w = _dims(cfg)
    d_conv_in = di + 2 * n  # x, B, C share the causal conv

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "in_proj": he_init(generator, (d, 2 * di + 2 * n + nh), d, device, dtype),
        "conv_w": he_init(generator, (w, d_conv_in), w, device, dtype),
        "conv_b": full((d_conv_in,), 0.0),
        "A_log": full((nh,), 0.0),          # A = -exp(A_log)
        "D": full((nh,), 1.0),
        "dt_bias": full((nh,), 0.0),
        "norm": full((di,), 1.0),
        "out_proj": he_init(generator, (di, d), di, device, dtype),
    }


def _split_in_proj(cfg, zxbcdt: torch.Tensor):
    di, nh, n, dh, w = _dims(cfg)
    return zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n], zxbcdt[..., 2 * di + 2 * n:]


def _gated_norm(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Mamba2's RMSNorm(x * silu(z)), in fp32, cast back."""
    y = x * F.silu(z)
    dt = y.dtype
    y = y.float()
    var = torch.mean(y * y, dim=-1, keepdim=True)
    return (y * torch.rsqrt(var + eps) * scale.float()).to(dt)


def mamba2_block(params: Params, x: torch.Tensor, cfg: Any, *,
                 cache: Params | None = None, cache_index=None):
    """x ``(B, S, d)`` -> ``(y, new cache entries or None)``."""
    di, nh, n, dh, w = _dims(cfg)
    b, s, d = x.shape
    zxbcdt = dense(x, params["in_proj"])
    z, xbc, dt = _split_in_proj(cfg, zxbcdt)
    dt = F.softplus(dt.float() + params["dt_bias"].float())          # (B, S, nh)
    A = -torch.exp(params["A_log"].float())                           # (nh,)
    conv_w = params["conv_w"].to(x.dtype)                             # (W, C)
    conv_b = params["conv_b"].to(x.dtype)

    if cache is not None and cache_index is not None and s == 1:
        # ---- decode: O(1) update ---------------------------------------------
        conv_state = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)  # (B, W, C)
        xbc_t = F.silu((conv_state * conv_w[None]).sum(1) + conv_b)         # (B, C)
        xh = xbc_t[..., :di].reshape(b, nh, dh)
        Bv, Cv = xbc_t[..., di:di + n], xbc_t[..., di + n:]
        dt_t = dt[:, 0]                                                     # (B, nh)
        dA = torch.exp(dt_t * A[None, :])
        upd = (dt_t[..., None, None] * xh[..., :, None]) * Bv[:, None, None, :]
        state = cache["state"].float() * dA[..., None, None] + upd
        y = torch.einsum("bhdn,bn->bhd", state, Cv.float())
        y = y + params["D"].float()[None, :, None] * xh.float()
        y = y.reshape(b, 1, di).to(x.dtype)
        new_cache = {"conv": conv_state[:, 1:], "state": state.to(cache["state"].dtype)}
    else:
        # ---- prefill: causal conv + chunked SSD ------------------------------
        pad = torch.zeros((b, w - 1, xbc.shape[-1]), dtype=xbc.dtype, device=x.device)
        xbc_p = torch.cat([pad, xbc], dim=1)
        xbc_c = 0  # the reference's Python sum, from the integer 0, in bf16
        for i in range(w):
            xbc_c = xbc_c + xbc_p[:, i:i + s] * conv_w[i][None, None]
        xbc_c = F.silu(xbc_c + conv_b)
        xh = xbc_c[..., :di].reshape(b, s, nh, dh)   # a strided view
        Bv, Cv = xbc_c[..., di:di + n], xbc_c[..., di + n:]
        # the chunked SSD scan without D * x: K5 (its plain version on the CPU)
        y, final_state = ssm_scan_state(xh, dt, A, Bv, Cv, cfg.ssm.chunk)
        y = y + params["D"].float()[None, None, :, None] * xh.float()
        y = y.reshape(b, s, di).to(x.dtype)
        new_cache = None
        if cache is not None:
            conv = xbc[:, s - (w - 1):] if s >= w - 1 \
                else torch.cat([cache["conv"].to(xbc.dtype), xbc], 1)[:, -(w - 1):]
            new_cache = {"conv": conv, "state": final_state.to(cache["state"].dtype)}

    y = _gated_norm(y, z, params["norm"], cfg.norm_eps)
    return dense(y, params["out_proj"]), new_cache


def init_mamba2_cache(cfg, batch: int, dtype=torch.bfloat16, device=None) -> Params:
    """One layer's zeroed cache."""
    di, nh, n, dh, w = _dims(cfg)
    return {
        "conv": torch.zeros((batch, w - 1, di + 2 * n), dtype=dtype, device=device),
        "state": torch.zeros((batch, nh, dh, n), dtype=dtype, device=device),
    }
