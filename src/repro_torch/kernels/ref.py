"""Plain PyTorch oracles for the kernels (the ground truth of the tests)."""

from __future__ import annotations

import math

import torch


def cc_propagate_ref(G: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """u[i] = max(max_{j: G[i,j] != 0} c[j], c[i]).  G: (n, n) dense {0,1}."""
    neigh = torch.where(G > 0, c[None, :], torch.zeros((), dtype=c.dtype,
                                                       device=c.device))
    return torch.maximum(neigh.amax(dim=1), c)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q, k, v: (B, H, S, dh) (same H; GQA expansion happens in ops).

    The masked S x S softmax: scores in q's type, then fp32, masked with
    -1e30, softmax, weights rounded to q's type for the product with v.
    """
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float()
    s = s / math.sqrt(q.shape[-1])
    if causal:
        sq, sk = s.shape[-2:]
        mask = torch.arange(sq, device=q.device)[:, None] >= torch.arange(
            sk, device=q.device)[None, :]
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w.to(q.dtype), v)


def ssm_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                 dtype=torch.float32, return_state: bool = False):
    """Sequential Mamba2 (SSD) recurrence oracle.

    x ``(Bt, S, H, dh)``; dt ``(Bt, S, H)``; A ``(H,)`` (negative); B and C
    ``(Bt, S, N)``. Returns ``(Bt, S, H, dh)`` in ``dtype`` (float64 for a
    card check), and with ``return_state`` the final state ``(Bt, H, dh,
    N)`` too.
    """
    bt, s, h, dh = x.shape
    n = B.shape[-1]
    xf, dtf, Af = x.to(dtype), dt.to(dtype), A.to(dtype)
    Bf, Cf = B.to(dtype), C.to(dtype)
    state = torch.zeros((bt, h, dh, n), dtype=dtype, device=x.device)
    ys = []
    for t in range(s):
        dA = torch.exp(dtf[:, t] * Af[None, :])                           # (Bt, H)
        upd = (dtf[:, t, :, None, None] * xf[:, t, :, :, None]) \
            * Bf[:, t, None, None, :]
        state = state * dA[..., None, None] + upd
        ys.append(torch.einsum("bhdn,bn->bhd", state, Cf[:, t]))
    y = torch.stack(ys, dim=1) + D.to(dtype)[None, None, :, None] * xf
    return (y, state) if return_state else y


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   logw: torch.Tensor, u: torch.Tensor, dtype=torch.float32,
                   return_state: bool = False):
    """Sequential RWKV6 recurrence oracle.

    r, k, v, logw ``(Bt, H, S, dh)`` (logw <= 0); u ``(H, dh)``.
    ``y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)``,
    ``S_t = diag(w_t) S_{t-1} + k_t v_t^T``. Returns ``(Bt, H, S, dh)`` in
    ``dtype``, and with ``return_state`` the final state ``(Bt, H, dh, dh)``.
    """
    bt, h, s, dh = r.shape
    rf, kf, vf, lwf = (t.to(dtype) for t in (r, k, v, logw))
    uf = u.to(dtype)
    state = torch.zeros((bt, h, dh, dh), dtype=dtype, device=r.device)
    ys = []
    for t in range(s):
        r_t, k_t, v_t = rf[:, :, t], kf[:, :, t], vf[:, :, t]
        ys.append(torch.einsum("bhc,bhcd->bhd", r_t, state)
                  + (r_t * uf[None] * k_t).sum(-1, keepdim=True) * v_t)
        state = state * torch.exp(lwf[:, :, t])[..., None] \
            + k_t[..., :, None] * v_t[..., None, :]
    y = torch.stack(ys, dim=2)
    return (y, state) if return_state else y


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """float32 ``a`` rounded to TF32 (10 stored mantissa bits), to nearest
    with ties to even, on the bit pattern; the low 13 bits come out zero.
    The walker's MoE program rounds its operands so (csrc/dag_walk.cu:
    tf32_rne)."""
    u = a.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32).view(torch.float32)


def user_bias_ref(R: torch.Tensor, vectors: bool | None = None) -> torch.Tensor:
    """The walker's ``user_bias`` row means in its own order of additions,
    in float32 (csrc/dag_walk.cu: Recommendation): lane l of a warp adds
    its columns c = 4 (l + 32 k) + e (16-byte vectors; ``vectors``, the
    default when n_items % 4 == 0) or c = l + 32 k (scalars), k and e
    ascending, into one accumulator; an xor tree over lane offsets 16, 8,
    4, 2, 1 adds the lanes; the sum is divided by n_items. Columns past
    the row add zeros, which leave a sum unchanged."""
    n, m = R.shape
    if vectors is None:
        vectors = m % 4 == 0
    width = 128 if vectors else 32
    Rp = torch.zeros((n, -(-m // width) * width), dtype=torch.float32)
    Rp[:, :m] = R.float().cpu()
    Rp = Rp.view(n, -1, 32, 4) if vectors else Rp.view(n, -1, 32, 1)
    s = torch.zeros((n, 32), dtype=torch.float32)
    for k in range(Rp.shape[1]):
        for e in range(Rp.shape[3]):
            s = s + Rp[:, k, :, e]
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        s = s + s[:, lanes ^ off]
    return (s[:, 0] / m).to(R.device)
