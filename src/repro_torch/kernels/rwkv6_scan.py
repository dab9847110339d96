"""RWKV6 chunked WKV scan (K6): data-dependent per-channel decay.

The function of the Pallas kernel ``repro/kernels/rwkv6_scan.py:
rwkv6_scan``: its code's exact form. Per (batch, head) the chunks run in
order, carrying a ``(dh, dh)`` fp32 state; inside a chunk of ``Q`` steps

* ``A[t, s] = sum_c r[t,c] k[s,c] exp(cum_{t-1,c} - cum_{s,c})`` on the
  strict lower triangle;
* ``y = A v + diag(sum_c r u k) v + (r * exp(cum_{t-1})) state``;
* ``state <- diag(exp(cum_Q)) state + (k * exp(cum_Q - cum))^T v``,

with ``cum`` the inclusive cumsum of ``logw`` over the chunk and
``cum_{t-1}`` the exclusive one, as the model's ``_wkv_chunked`` takes it.
The factored form that the Pallas kernel's docstring names, with one
reference point at the chunk's end, is not this function's: its first
factor ``exp(cum_{t-1} - cum_Q)`` overflows under fast decay.
``rwkv6_scan_state`` returns the output and the final state, which the
model's prefill stores in its decode cache; ``rwkv6_scan`` the output
alone, as the Pallas kernel does.

CUDA kernel: ``csrc/rwkv6_scan.cu`` (its note gives the design and the
bound): the chunk-parallel form in two launches, the chunks' updates and
the state pass, then every chunk's output. Inside a chunk the gate is
recentred at each 16-step sub-chunk: the blocks of A below the diagonal
become products ``(r exp(cum_{t-1} - e_j)) (k exp(e_j - cum_s))^T``, every
exponent <= 0, on the tensor cores as split TF32 (so does each diagonal
block's lower-left quadrant, recentred at its step 7), and only pairs
within one 8-step run take the exact per-pair gate. ``kernels/ref.py:
rwkv6_scan_split_ref`` emulates its arithmetic on the CPU. On a CPU
tensor the wrappers run ``rwkv6_scan_plain``, the same chunk recurrence
in PyTorch; on a CUDA tensor they launch the kernel or raise. The wrapper
allocates the kernel's scratch, the state entering each chunk (``S / Q``
states of ``dh * dh`` floats a (batch, head)).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import RWKV6_SCAN, kernel_chunk, ptr, seq_chunk, stream

__all__ = ["HEAD_DIM", "MAX_CHUNK", "rwkv6_scan", "rwkv6_scan_plain",
           "rwkv6_scan_state"]

#: the head width and the longest chunk the CUDA kernel is compiled for
HEAD_DIM, MAX_CHUNK = 64, 64


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     logw: torch.Tensor, u: torch.Tensor,
                     chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunk recurrence in plain PyTorch (any device): ``(y, state)``,
    y ``(B, H, S, dh)`` and state ``(B, H, dh, dh)``, both fp32."""
    b, h, s, dh = r.shape
    q = seq_chunk(s, chunk)
    nc = s // q
    rc, kc, vc, lw = (t.float().reshape(b, h, nc, q, dh) for t in (r, k, v, logw))
    cum = torch.cumsum(lw, dim=3)
    uf = u.float()[None, :, None, :]
    tri = (torch.arange(q, device=r.device)[:, None]
           > torch.arange(q, device=r.device)[None, :])[..., None]
    state = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
    ys = []
    for i in range(nc):
        r_i, k_i, v_i, cum_i = rc[:, :, i], kc[:, :, i], vc[:, :, i], cum[:, :, i]
        cum_tm1 = F.pad(cum_i[:, :, :-1], (0, 0, 1, 0))   # cum_{t-1}, cum_{-1} = 0
        diff = cum_tm1[:, :, :, None, :] - cum_i[:, :, None, :, :]
        gate = torch.where(tri, torch.exp(diff), torch.zeros((), device=r.device))
        A = torch.einsum("bhtc,bhsc,bhtsc->bhts", r_i, k_i, gate)
        diag = torch.einsum("bhtc,bhtc->bht", r_i * uf, k_i)
        y = torch.einsum("bhts,bhsd->bhtd", A, v_i) + diag[..., None] * v_i
        y = y + torch.einsum("bhtc,bhcd->bhtd", r_i * torch.exp(cum_tm1), state)
        wq = torch.exp(cum_i[:, :, -1:, :] - cum_i)
        upd = torch.einsum("bhsc,bhsd->bhcd", k_i * wq, v_i)
        state = state * torch.exp(cum_i[:, :, -1, :])[..., None] + upd
        ys.append(y)
    return torch.stack(ys, dim=2).reshape(b, h, s, dh), state


def rwkv6_scan_state(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     logw: torch.Tensor, u: torch.Tensor,
                     chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y, final state)``: r, k, v, logw ``(B, H, S, dh)``, u ``(H, dh)``.

    On a CUDA tensor r, k and v share a dtype (bfloat16 or float32),
    logw and u are float32, ``dh`` is ``HEAD_DIM``, and each of r, k, v
    and logw has a contiguous last axis (other strides are free: the
    model's transposed head views go in as they are). Anything else
    raises, and so does a call on the card that needs a gradient (grad
    enabled and an input requiring it): the kernel has no backward yet
    (ROADMAP A12.2). A chunk above ``MAX_CHUNK`` runs as sub-chunks of its
    largest divisor up to ``MAX_CHUNK`` (``_build.kernel_chunk``). The
    kernel's two launches count as one in ``RWKV6_SCAN.launches["rwkv6_scan"]``.
    """
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, logw, u, chunk)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: unsupported device {r.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, logw, u)):
        raise NotImplementedError(
            "rwkv6_scan on the card has no backward kernel yet (ROADMAP A12.2): its "
            "result would carry no gradient; train RWKV6 on the CPU, or call it "
            "under torch.no_grad()")
    if r.dim() != 4 or not (k.shape == v.shape == logw.shape == r.shape):
        raise ValueError(f"rwkv6_scan: r, k, v and logw must share one (B, H, S, dh) "
                         f"shape, got {[tuple(t.shape) for t in (r, k, v, logw)]}")
    b, h, s, dh = r.shape
    q = kernel_chunk(seq_chunk(s, chunk), MAX_CHUNK)
    if dh != HEAD_DIM:
        raise ValueError(f"rwkv6_scan kernel takes dh {HEAD_DIM}, got dh {dh}")
    if r.dtype not in (torch.float32, torch.bfloat16) or k.dtype != r.dtype \
            or v.dtype != r.dtype or logw.dtype != torch.float32 \
            or u.dtype != torch.float32 or tuple(u.shape) != (h, dh):
        raise ValueError(f"rwkv6_scan kernel takes r, k, v of one dtype (bfloat16 or "
                         f"float32), float32 logw and float32 u of shape {(h, dh)}, "
                         f"got {r.dtype}, {k.dtype}, {v.dtype}, {logw.dtype}, "
                         f"u {u.dtype} {tuple(u.shape)}")
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw), ("u", u)):
        if t.device != r.device:
            raise ValueError(f"{name} lies on {t.device}, r on {r.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"rwkv6_scan kernel: {name} needs a contiguous last "
                             f"axis, got strides {t.stride()}")
    u = u.contiguous()
    y = torch.empty((b, h, s, dh), dtype=torch.float32, device=r.device)
    state = torch.empty((b, h, dh, dh), dtype=torch.float32, device=r.device)
    chunk_state = torch.empty((b, h, s // q, dh, dh), dtype=torch.float32, device=r.device)
    ll = ctypes.c_longlong
    RWKV6_SCAN.launch(
        "rwkv6_scan", ptr(r), ptr(k), ptr(v), ptr(logw), ptr(u), ptr(y), ptr(state),
        ptr(chunk_state),
        ctypes.c_int(int(r.dtype == torch.bfloat16)), ctypes.c_int(b), ctypes.c_int(h),
        ctypes.c_int(s), ctypes.c_int(dh), ctypes.c_int(q),
        *(ll(st) for t in (r, k, v, logw) for st in t.stride()[:3]), stream(r.device))
    return y, state


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """The Pallas kernel's function: ``(B, H, S, dh)`` fp32 outputs."""
    return rwkv6_scan_state(r, k, v, logw, u, chunk)[0]
