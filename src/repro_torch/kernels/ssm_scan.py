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

The gradient (K5'): ``csrc/ssm_scan_bwd.cu`` (its note gives the
recurrences, the bound and the design), three launches counted once in
``SSM_SCAN_BWD.launches["ssm_scan_bwd"]``: the reverse pass of the state's
gradient over the chunks, every chunk's dx, ddt and dcum for a group of
``HEAD_GROUP`` heads with the group's shares of dB and dC summed in
registers, and the fold of dB and dC over the groups and of dA. Its
products run on the tensor cores as split TF32, as the forward's do
(``kernels/ref.py:ssm_scan_bwd_split_ref`` emulates their order on the
CPU). No atomics: two calls give the same bits. ``ssm_scan_bwd_plain`` walks the
same recurrences in PyTorch. ``_SsmScan`` pairs the forward, which keeps
its scratch (``cum`` and the entering states) for the backward, with the
backward kernel; ``ssm_scan_plain_pair`` pairs the two plain versions, the
yardstick of a train step through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import SSM_SCAN, SSM_SCAN_BWD, kernel_chunk, ptr, seq_chunk, stream

__all__ = ["HEAD_DIM", "D_STATE", "MAX_CHUNK", "ssm_scan", "ssm_scan_bwd",
           "ssm_scan_bwd_plain", "ssm_scan_plain", "ssm_scan_plain_pair",
           "ssm_scan_state"]

#: the head width, state width and longest chunk the CUDA kernel is compiled for
HEAD_DIM, D_STATE, MAX_CHUNK = 64, 64, 64
#: heads a CTA of K5' takes in turn (csrc/ssm_scan_bwd.cu: HG): dB and dC
#: are folded over ``ceil(H / HEAD_GROUP)`` group partials
HEAD_GROUP = 8


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


def ssm_scan_bwd_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                       dstate: torch.Tensor | None = None, chunk: int = 128,
                       dtype: torch.dtype = torch.float32, magnitude: bool = False):
    """The gradient of ``ssm_scan_state`` in plain PyTorch (any device), by
    the recurrences of ``csrc/ssm_scan_bwd.cu``: the states entering each
    chunk, the reverse pass of the state's gradient, each chunk's terms and
    the reverse cumsum of dcum. ``dy`` is y's gradient, ``dstate`` the final
    state's (None: zero). Returns ``(dx, ddt, dA, dB, dC)`` in ``dtype``.

    ``magnitude`` gives each entry's sum of |terms| instead (inputs taken
    as |x|, |B|, |C|, |dy|, |dstate| and |A|, every difference a sum): the
    scale of the limits that hold the kernel to a float64 gradient."""
    bt, s, h, dh = x.shape
    n = B.shape[-1]
    q = seq_chunk(s, chunk)
    nc = s // q
    dev = x.device

    def val(t):
        t = t.to(dtype)
        return t.abs() if magnitude else t

    minus = torch.add if magnitude else torch.sub
    xc, dyc = val(x).reshape(bt, nc, q, h, dh), val(dy).reshape(bt, nc, q, h, dh)
    Bc, Cc = val(B).reshape(bt, nc, q, n), val(C).reshape(bt, nc, q, n)
    dtc = dt.to(dtype).reshape(bt, nc, q, h)
    cums = torch.cumsum(dtc * A.to(dtype)[None, None, None, :], dim=2)
    a = val(A)
    tri = (torch.arange(q, device=dev)[:, None] >= torch.arange(q, device=dev)[None, :])
    zero = torch.zeros((), dtype=dtype, device=dev)
    state = torch.zeros((bt, h, dh, n), dtype=dtype, device=dev)
    s_in = []                                  # the state entering each chunk
    for i in range(nc):
        s_in.append(state)
        cum = cums[:, i]
        w = torch.exp(cum[:, -1:] - cum)
        upd = torch.einsum("bsh,bsh,bshd,bsn->bhdn", w, dtc[:, i], xc[:, i], Bc[:, i])
        state = state * torch.exp(cum[:, -1])[..., None, None] + upd
    ds = torch.zeros_like(state) if dstate is None else val(dstate)
    ds_out = [ds] * nc                         # the gradient of the state leaving each
    for i in reversed(range(nc)):
        ds_out[i] = ds
        cum = cums[:, i]
        back = torch.einsum("bth,bthd,btn->bhdn", torch.exp(cum), dyc[:, i], Cc[:, i])
        ds = ds * torch.exp(cum[:, -1])[..., None, None] + back
    dx, ddt, dB, dC = [], [], [], []
    dA = torch.zeros_like(a)
    for i in range(nc):
        x_i, B_i, C_i, dt_i, dy_i = xc[:, i], Bc[:, i], Cc[:, i], dtc[:, i], dyc[:, i]
        cum, so, si = cums[:, i], ds_out[i], s_in[i]
        E = torch.where(tri[None, :, :, None],
                        torch.exp(cum[:, :, None, :] - cum[:, None, :, :]), zero)  # (Bt, t, s, H)
        cb = torch.einsum("btn,bsn->bts", C_i, B_i)[..., None]
        M = torch.einsum("bthd,bshd->btsh", dy_i, x_i)
        G, Ml, Z = cb * E * dt_i[:, None], M * E * dt_i[:, None], M * cb * E
        w = torch.exp(cum[:, -1:] - cum)                                  # (Bt, s, H)
        wdt = w * dt_i
        Y = torch.einsum("bhdn,bshd->bshn", so, x_i)
        P = torch.einsum("bshn,bsn->bsh", Y, B_i)
        carry = torch.exp(cum)[..., None] * torch.einsum("bhdn,bthd->bthn", si, dy_i)
        dx.append(torch.einsum("btsh,bthd->bshd", G, dy_i)
                  + wdt[..., None] * torch.einsum("bhdn,bsn->bshd", so, B_i))
        dC.append((torch.einsum("btsh,bsn->bthn", Ml, B_i) + carry).sum(2))
        dB.append((torch.einsum("btsh,btn->bshn", Ml, C_i) + wdt[..., None] * Y).sum(2))
        zs = Z.sum(1)
        dcum = minus(minus((Z * dt_i[:, None]).sum(2), dt_i * zs)
                     + torch.einsum("bthn,btn->bth", carry, C_i), wdt * P)
        end = torch.exp(cum[:, -1]) * (so * si).sum((-1, -2)) + (wdt * P).sum(1)
        dcum = torch.cat([dcum[:, :-1], dcum[:, -1:] + end[:, None]], dim=1)
        dda = torch.flip(torch.cumsum(torch.flip(dcum, (1,)), 1), (1,))  # d(dt A)
        ddt.append(zs + w * P + a * dda)
        dA = dA + (dt_i * dda).sum((0, 1))

    def steps(parts):
        return torch.stack(parts, 1).reshape(bt, s, *parts[0].shape[2:])

    return steps(dx), steps(ddt), dA, steps(dB), steps(dC)


def _check(x, dt, A, B, C, chunk: int) -> int:
    """Raise unless the kernels take these inputs; return the kernel's chunk."""
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan: unsupported device {x.device}")
    if x.dim() != 4 or B.dim() != 3 or C.shape != B.shape \
            or tuple(dt.shape) != tuple(x.shape[:3]) or tuple(B.shape[:2]) != tuple(x.shape[:2]) \
            or tuple(A.shape) != (x.shape[2],):
        raise ValueError(f"ssm_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}: "
                         "need (Bt, S, H, dh), (Bt, S, H), (H,) and two (Bt, S, N)")
    bt, s, h, dh = x.shape
    n = B.shape[-1]
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
    return kernel_chunk(seq_chunk(s, chunk), MAX_CHUNK)


def _forward(x, dt, A, B, C, chunk: int):
    """K5: ``(y, state, cum, chunk_state)``, the last two its scratch."""
    q = _check(x, dt, A, B, C, chunk)
    bt, s, h, dh = x.shape
    n = B.shape[-1]
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
    return y, state, cum, chunk_state


def ssm_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, cum: torch.Tensor, chunk_state: torch.Tensor,
                 dy: torch.Tensor, dstate: torch.Tensor | None = None):
    """K5' on the card: ``(dx, ddt, dA, dB, dC)`` for the inputs of a K5
    call, its scratch ``cum`` and ``chunk_state`` (``_forward``'s), y's
    gradient ``dy`` and the final state's ``dstate`` (None: zero). dx, dB
    and dC come in their inputs' dtype, contiguous; ddt and dA in float32.
    One count in ``SSM_SCAN_BWD.launches["ssm_scan_bwd"]``."""
    bt, s, h, dh = x.shape
    n = B.shape[-1]
    q = s // chunk_state.shape[2]
    if _check(x, dt, A, B, C, q) != q or tuple(cum.shape) != (bt, h, s) \
            or tuple(chunk_state.shape) != (bt, h, s // q, dh, n) \
            or tuple(dy.shape) != tuple(x.shape) \
            or (dstate is not None and tuple(dstate.shape) != (bt, h, dh, n)):
        raise ValueError(f"ssm_scan_bwd: cum {tuple(cum.shape)}, chunk_state "
                         f"{tuple(chunk_state.shape)}, dy {tuple(dy.shape)} do not match "
                         f"x {tuple(x.shape)}")
    dy = dy.float()
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    if dstate is not None:
        dstate = dstate.float().contiguous()
    dev, f32 = x.device, torch.float32
    nc = s // q
    ds = torch.empty((bt, h, nc, dh, n), dtype=f32, device=dev)
    dBg = torch.empty((bt, -(-h // HEAD_GROUP), s, n), dtype=f32, device=dev)
    dCg = torch.empty_like(dBg)
    dApart = torch.empty((bt, h, nc), dtype=f32, device=dev)
    dx = torch.empty((bt, s, h, dh), dtype=x.dtype, device=dev)
    ddt = torch.empty((bt, s, h), dtype=f32, device=dev)
    dA = torch.empty((h,), dtype=f32, device=dev)
    dB = torch.empty((bt, s, n), dtype=B.dtype, device=dev)
    dC = torch.empty_like(dB)
    ll = ctypes.c_longlong
    SSM_SCAN_BWD.launch(
        "ssm_scan_bwd", ptr(x), ptr(dt), ptr(A.contiguous()), ptr(B), ptr(C), ptr(cum),
        ptr(chunk_state), ptr(dy), ptr(dstate), ptr(ds), ptr(dBg), ptr(dCg), ptr(dApart),
        ptr(dx), ptr(ddt), ptr(dA), ptr(dB), ptr(dC),
        ctypes.c_int(int(x.dtype == torch.bfloat16)), ctypes.c_int(bt), ctypes.c_int(h),
        ctypes.c_int(s), ctypes.c_int(dh), ctypes.c_int(n), ctypes.c_int(q),
        *(ll(st) for st in x.stride()[:3]), *(ll(st) for st in dt.stride()),
        ll(B.stride(0)), ll(B.stride(1)), ll(C.stride(0)), ll(C.stride(1)),
        *(ll(st) for st in dy.stride()[:3]), stream(dev))
    return dx, ddt, dA, dB, dC


class _SsmScan(torch.autograd.Function):
    """K5 with its gradient: the forward kernel, keeping its scratch, and
    K5' on the saved inputs and scratch (``plain``: the two plain versions
    in their places). Under ``torch.utils.checkpoint`` the forward runs
    again in the recompute."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int, plain: bool):
        ctx.set_materialize_grads(False)
        if plain:
            y, state = ssm_scan_plain(x, dt, A, B, C, chunk)
            ctx.save_for_backward(x, dt, A, B, C)
        else:
            y, state, cum, chunk_state = _forward(x, dt, A, B, C, chunk)
            ctx.save_for_backward(x, dt, A, B, C, cum, chunk_state)
        ctx.chunk, ctx.plain = chunk, plain
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B, C, *scratch = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        if ctx.plain:
            grads = ssm_scan_bwd_plain(x, dt, A, B, C, dy, dstate, ctx.chunk)
            grads = tuple(g.to(t.dtype) for g, t in zip(grads, (x, dt, A, B, C)))
        else:
            grads = ssm_scan_bwd(x, dt, A, B, C, *scratch, dy, dstate)
        return (*grads, None, None)


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def ssm_scan_state(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor,
                   chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y without D * x, final state)``: x ``(Bt, S, H, dh)``, dt
    ``(Bt, S, H)``, A ``(H,)``, B and C ``(Bt, S, N)``.

    On a CUDA tensor x, B and C share a dtype (bfloat16 or float32), dt
    and A are float32, ``dh`` is ``HEAD_DIM``, ``N`` is ``D_STATE``, and
    x, B and C have a contiguous last axis (other strides are free).
    Anything else raises. A chunk above ``MAX_CHUNK`` (the default 128,
    the Pallas wrapper's) runs as sub-chunks of its largest divisor up to
    ``MAX_CHUNK`` (``_build.kernel_chunk``). The kernel's two launches
    count as one in ``SSM_SCAN.launches["ssm_scan"]``. Where a gradient is
    needed (grad enabled and an input requiring it) the call goes through
    ``_SsmScan``: the same forward launch, and K5' in the backward;
    otherwise the forward kernel alone runs.
    """
    if x.device.type == "cpu":
        return ssm_scan_plain(x, dt, A, B, C, chunk)
    if _needs_grad(x, dt, A, B, C):
        return _SsmScan.apply(x, dt, A, B, C, chunk, False)
    return _forward(x, dt, A, B, C, chunk)[:2]


def ssm_scan_plain_pair(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        B: torch.Tensor, C: torch.Tensor,
                        chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """``ssm_scan_state``'s function and gradient through the two plain
    versions (``ssm_scan_plain`` and ``ssm_scan_bwd_plain``), paired as
    the kernels are (any device): the yardstick a train step through K5
    is held to on the card."""
    if _needs_grad(x, dt, A, B, C):
        return _SsmScan.apply(x, dt, A, B, C, chunk, True)
    return ssm_scan_plain(x, dt, A, B, C, chunk)


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, D: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """The Pallas wrapper's function: the scan plus ``D * x``, ``(Bt, S, H,
    dh)`` fp32."""
    y, _ = ssm_scan_state(x, dt, A, B, C, chunk)
    return y + D.float()[None, None, :, None] * x.float()
