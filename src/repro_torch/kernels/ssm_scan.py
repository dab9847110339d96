"""Mamba2 (SSD) chunked scan (K5): a scalar decay per head.

The function of the Pallas kernel ``repro/kernels/ssm_scan.py:ssm_scan``.
Per (batch, head) the chunks run in order, carrying a ``(dh, N)`` fp32
state; inside a chunk of ``Q`` steps, with ``cum`` the inclusive cumsum
of ``dt * A``:

* the gated quadratic form ``((C B^T) * exp(cum_t - cum_s)[s <= t] * dt_s) x``;
* the carry-in ``exp(cum_t) * C state^T``;
* ``state <- exp(cum_Q) state + sum_s exp(cum_Q - cum_s) dt_s x_s B_s^T``.

``D * x`` lies outside the scan: ``ssm_scan`` adds it, as the Pallas
wrapper does; ``ssm_scan_state`` returns the scan without it and the final
state, for the model, which adds ``D * x`` itself after the scan
(``models/ssm.py:mamba2_block``) and stores the state in its decode cache.

CUDA kernel: ``csrc/ssm_scan.cu`` (its note gives the design, the order
of its split-TF32 products and the bound): the chunk-parallel SSD form in
two launches, the chunks' updates and the state pass, then every chunk's
output; ``kernels/ref.py:ssm_scan_split_ref`` emulates its arithmetic on
the CPU. On a CPU tensor the wrappers run ``ssm_scan_plain``, the same
chunk recurrence in PyTorch (the model's ``chunk_step``); on a CUDA
tensor they launch the kernel or raise. The kernel reads x, B and C in
place by their strides: the Pallas wrapper's broadcast of B and C over
the heads and its transpose of x are not copied. The wrapper allocates
the kernel's scratch: each chunk's cumsum and the state entering each
chunk (``S / Q`` states of ``dh * N`` floats a (batch, head)).
"""

from __future__ import annotations

import ctypes

import torch

from ._build import SSM_SCAN, kernel_chunk, ptr, seq_chunk, stream

__all__ = ["HEAD_DIM", "D_STATE", "MAX_CHUNK", "ssm_scan", "ssm_scan_plain",
           "ssm_scan_state"]

#: the head width, state width and longest chunk the CUDA kernel is compiled for
HEAD_DIM, D_STATE, MAX_CHUNK = 64, 64, 64


def ssm_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor,
                   chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunk recurrence in plain PyTorch (any device): ``(y, state)``,
    y ``(Bt, S, H, dh)`` without ``D * x`` and state ``(Bt, H, dh, N)``,
    both fp32."""
    bt, s, h, dh = x.shape
    n = B.shape[-1]
    q = seq_chunk(s, chunk)
    nc = s // q
    xc = x.float().reshape(bt, nc, q, h, dh)
    Bc, Cc = B.float().reshape(bt, nc, q, n), C.float().reshape(bt, nc, q, n)
    dtc = dt.float().reshape(bt, nc, q, h)
    cums = torch.cumsum(dtc * A.float()[None, None, None, :], dim=2)
    mask = (torch.arange(q, device=x.device)[:, None]
            >= torch.arange(q, device=x.device)[None, :])[None, :, :, None]
    state = torch.zeros((bt, h, dh, n), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(nc):
        x_i, B_i, C_i, dt_i, cum_i = xc[:, i], Bc[:, i], Cc[:, i], dtc[:, i], cums[:, i]
        diff = cum_i[:, :, None, :] - cum_i[:, None, :, :]           # (Bt, Q, Q, H)
        gate = torch.where(mask, torch.exp(diff), torch.zeros((), device=x.device))
        scores = torch.einsum("btn,bsn->bts", C_i, B_i)[..., None] * gate
        y_intra = torch.einsum("btsh,bsh,bshd->bthd", scores, dt_i, x_i)
        y_inter = torch.einsum("btn,bhdn->bthd", C_i, state) \
            * torch.exp(cum_i)[..., None]
        decay = torch.exp(cum_i[:, -1, :])                             # (Bt, H)
        w_s = torch.exp(cum_i[:, -1:, :] - cum_i)                      # (Bt, Q, H)
        upd = torch.einsum("bsh,bsh,bshd,bsn->bhdn", w_s, dt_i, x_i, B_i)
        state = state * decay[..., None, None] + upd
        ys.append(y_intra + y_inter)
    return torch.stack(ys, dim=1).reshape(bt, s, h, dh), state


def ssm_scan_state(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor,
                   chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y without D * x, final state)``: x ``(Bt, S, H, dh)``, dt
    ``(Bt, S, H)``, A ``(H,)``, B and C ``(Bt, S, N)``.

    On a CUDA tensor x, B and C share a dtype (bfloat16 or float32), dt
    and A are float32, ``dh`` is ``HEAD_DIM``, ``N`` is ``D_STATE``, and
    x, B and C have a contiguous last axis (other strides are free).
    Anything else raises, and so does a call on the card that needs a
    gradient (grad enabled and an input requiring it): the kernel has no
    backward yet (ROADMAP A12.2). A chunk above ``MAX_CHUNK`` (the default 128,
    the Pallas wrapper's) runs as sub-chunks of its largest divisor up to
    ``MAX_CHUNK`` (``_build.kernel_chunk``). The kernel's two launches
    count as one in ``SSM_SCAN.launches["ssm_scan"]``.
    """
    if x.device.type == "cpu":
        return ssm_scan_plain(x, dt, A, B, C, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B, C)):
        raise NotImplementedError(
            "ssm_scan on the card has no backward kernel yet (ROADMAP A12.2): its "
            "result would carry no gradient; train Zamba2 on the CPU, or call it "
            "under torch.no_grad()")
    if x.dim() != 4 or B.dim() != 3 or C.shape != B.shape \
            or tuple(dt.shape) != tuple(x.shape[:3]) or tuple(B.shape[:2]) != tuple(x.shape[:2]) \
            or tuple(A.shape) != (x.shape[2],):
        raise ValueError(f"ssm_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}: "
                         "need (Bt, S, H, dh), (Bt, S, H), (H,) and two (Bt, S, N)")
    bt, s, h, dh = x.shape
    n = B.shape[-1]
    q = kernel_chunk(seq_chunk(s, chunk), MAX_CHUNK)
    if dh != HEAD_DIM or n != D_STATE:
        raise ValueError(f"ssm_scan kernel takes dh {HEAD_DIM} and N {D_STATE}, "
                         f"got dh {dh}, N {n}")
    if x.dtype not in (torch.float32, torch.bfloat16) or B.dtype != x.dtype \
            or C.dtype != x.dtype or dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"ssm_scan kernel takes x, B, C of one dtype (bfloat16 or "
                         f"float32) and float32 dt and A, got {x.dtype}, {B.dtype}, "
                         f"{C.dtype}, {dt.dtype}, {A.dtype}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.device != x.device:
            raise ValueError(f"{name} lies on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssm_scan kernel: {name} needs a contiguous last axis, "
                             f"got strides {t.stride()}")
    A = A.contiguous()
    y = torch.empty((bt, s, h, dh), dtype=torch.float32, device=x.device)
    state = torch.empty((bt, h, dh, n), dtype=torch.float32, device=x.device)
    cum = torch.empty((bt, h, s), dtype=torch.float32, device=x.device)
    chunk_state = torch.empty((bt, h, s // q, dh, n), dtype=torch.float32, device=x.device)
    ll = ctypes.c_longlong
    SSM_SCAN.launch(
        "ssm_scan", ptr(x), ptr(dt), ptr(A), ptr(B), ptr(C), ptr(y), ptr(state),
        ptr(cum), ptr(chunk_state),
        ctypes.c_int(int(x.dtype == torch.bfloat16)), ctypes.c_int(bt), ctypes.c_int(h),
        ctypes.c_int(s), ctypes.c_int(dh), ctypes.c_int(n), ctypes.c_int(q),
        *(ll(st) for st in (x.stride(0), x.stride(1), x.stride(2))),
        *(ll(st) for st in dt.stride()), ll(B.stride(0)), ll(B.stride(1)),
        ll(C.stride(0)), ll(C.stride(1)), stream(x.device))
    return y, state


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, D: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """The Pallas wrapper's function: the scan plus ``D * x``, ``(Bt, S, H,
    dh)`` fp32."""
    y, _ = ssm_scan_state(x, dt, A, B, C, chunk)
    return y + D.float()[None, None, :, None] * x.float()
