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

The gradient (K6'): ``csrc/rwkv6_scan_bwd.cu`` (its note gives the
recurrences, the bound and the design), three launches counted once in
``RWKV6_SCAN_BWD.launches["rwkv6_scan_bwd"]``: the reverse pass of the
state's gradient over the chunks, every chunk's dr, dk, dv, dlogw and
share of du, and the fold of du. The gate keeps the forward's 16-step
sub-chunk reference points, every exponent <= 0; the decay's gradient
takes no Q x Q x dh gate gradient: with ``drg`` and ``dkg`` r's and k's
gradients without the u bonus, ``dcum_j = r_{j+1} drg_{j+1} - k_j dkg_j``
(plus ``sum_d dS S_out`` at the chunk's last step) and dlogw is its
reverse cumsum. Its products run on the tensor cores as split TF32, as
the forward's do: the gated sums across sub-chunks as 16-step block
products, only each sub-chunk's two 8-step triangles with the exact gate
a pair (``kernels/ref.py:rwkv6_scan_bwd_split_ref`` emulates their order
on the CPU). No atomics: two calls give the same bits.
``rwkv6_scan_bwd_plain`` walks the same recurrences in PyTorch.
``_Rwkv6Scan`` pairs the forward, which keeps its scratch for the
backward, with the backward kernel; ``rwkv6_scan_plain_pair`` pairs the two
plain versions, the yardstick of a train step through the kernels.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import RWKV6_SCAN, RWKV6_SCAN_BWD, kernel_chunk, ptr, seq_chunk, stream

__all__ = ["HEAD_DIM", "MAX_CHUNK", "rwkv6_scan", "rwkv6_scan_bwd", "rwkv6_scan_bwd_plain",
           "rwkv6_scan_plain", "rwkv6_scan_plain_pair", "rwkv6_scan_state"]

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


def rwkv6_scan_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         logw: torch.Tensor, u: torch.Tensor, dy: torch.Tensor,
                         dstate: torch.Tensor | None = None, chunk: int = 64,
                         dtype: torch.dtype = torch.float32, magnitude: bool = False):
    """The gradient of ``rwkv6_scan_state`` in plain PyTorch (any device),
    by the recurrences of ``csrc/rwkv6_scan_bwd.cu``: the states entering
    each chunk, the reverse pass of the state's gradient, each chunk's terms
    (the gate ``exp(cm1_t - cum_s)`` only where s < t, every exponent <= 0)
    and the reverse cumsum of dcum. ``dy`` is y's gradient, ``dstate`` the
    final state's (None: zero). Returns ``(dr, dk, dv, dlogw, du)`` in
    ``dtype``.

    ``magnitude`` gives each entry's sum of |terms| instead (inputs taken
    as |r|, |k|, |v|, |u|, |dy|, |dstate|, every difference a sum): the
    scale of the limits that hold the kernel to a float64 gradient."""
    b, h, s, dh = r.shape
    q = seq_chunk(s, chunk)
    nc = s // q
    dev = r.device

    def val(t):
        t = t.to(dtype)
        return t.abs() if magnitude else t

    minus = torch.add if magnitude else torch.sub
    rc, kc, vc, dyc = (val(t).reshape(b, h, nc, q, dh) for t in (r, k, v, dy))
    cums = torch.cumsum(logw.to(dtype).reshape(b, h, nc, q, dh), dim=3)
    uf = val(u)[None, :, None, :]
    zero = torch.zeros((), dtype=dtype, device=dev)
    tri = (torch.arange(q, device=dev)[:, None] > torch.arange(q, device=dev)[None, :])[..., None]
    state = torch.zeros((b, h, dh, dh), dtype=dtype, device=dev)
    s_in = []                                  # the state entering each chunk
    for i in range(nc):
        s_in.append(state)
        cum = cums[:, :, i]
        wq = torch.exp(cum[:, :, -1:] - cum)
        state = state * torch.exp(cum[:, :, -1])[..., None] \
            + torch.einsum("bhsc,bhsd->bhcd", kc[:, :, i] * wq, vc[:, :, i])
    s_out = s_in[1:] + [state]
    ds = torch.zeros_like(state) if dstate is None else val(dstate)
    ds_out = [ds] * nc                         # the gradient of the state leaving each
    for i in reversed(range(nc)):
        ds_out[i] = ds
        cum = cums[:, :, i]
        cm1 = F.pad(cum[:, :, :-1], (0, 0, 1, 0))
        ds = ds * torch.exp(cum[:, :, -1])[..., None] \
            + torch.einsum("bhtc,bhtd->bhcd", rc[:, :, i] * torch.exp(cm1), dyc[:, :, i])
    dr, dk, dv, dlogw = [], [], [], []
    du = torch.zeros((h, dh), dtype=dtype, device=dev)
    for i in range(nc):
        r_i, k_i, v_i, dy_i = rc[:, :, i], kc[:, :, i], vc[:, :, i], dyc[:, :, i]
        cum, so, si = cums[:, :, i], ds_out[i], s_in[i]
        cm1 = F.pad(cum[:, :, :-1], (0, 0, 1, 0))
        gate = torch.where(tri, torch.exp(cm1[:, :, :, None, :] - cum[:, :, None, :, :]), zero)
        A = torch.einsum("bhtc,bhsc,bhtsc->bhts", r_i, k_i, gate)
        bonus = (r_i * uf * k_i).sum(-1)
        dA = torch.where(tri[..., 0], torch.einsum("bhtd,bhsd->bhts", dy_i, v_i), zero)
        db = (dy_i * v_i).sum(-1)
        wq = torch.exp(cum[:, :, -1:] - cum)
        dv.append(torch.einsum("bhts,bhtd->bhsd", A, dy_i) + bonus[..., None] * dy_i
                  + torch.einsum("bhsc,bhcd->bhsd", k_i * wq, so))
        drg = torch.einsum("bhts,bhsc,bhtsc->bhtc", dA, k_i, gate) \
            + torch.exp(cm1) * torch.einsum("bhcd,bhtd->bhtc", si, dy_i)
        dkg = torch.einsum("bhts,bhtc,bhtsc->bhsc", dA, r_i, gate) \
            + wq * torch.einsum("bhcd,bhsd->bhsc", so, v_i)
        dr.append(drg + db[..., None] * uf * k_i)
        dk.append(dkg + db[..., None] * uf * r_i)
        du = du + torch.einsum("bht,bhtc->hc", db, r_i * k_i)
        dcum = minus(F.pad((r_i * drg)[:, :, 1:], (0, 0, 0, 1)), k_i * dkg)
        end = (so * s_out[i]).sum(-1)          # the chunk's last step: sum_d dS S_out
        dcum = torch.cat([dcum[:, :, :-1], dcum[:, :, -1:] + end[:, :, None]], dim=2)
        dlogw.append(torch.flip(torch.cumsum(torch.flip(dcum, (2,)), 2), (2,)))

    def steps(parts):
        return torch.stack(parts, 2).reshape(b, h, s, dh)

    return steps(dr), steps(dk), steps(dv), steps(dlogw), du


def _check(r, k, v, logw, u, chunk: int) -> int:
    """Raise unless the kernels take these inputs; return the kernel's chunk."""
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: unsupported device {r.device}")
    if r.dim() != 4 or not (k.shape == v.shape == logw.shape == r.shape):
        raise ValueError(f"rwkv6_scan: r, k, v and logw must share one (B, H, S, dh) "
                         f"shape, got {[tuple(t.shape) for t in (r, k, v, logw)]}")
    b, h, s, dh = r.shape
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
    return kernel_chunk(seq_chunk(s, chunk), MAX_CHUNK)


def _forward(r, k, v, logw, u, chunk: int):
    """K6: ``(y, state, chunk_state)``, the last its scratch."""
    q = _check(r, k, v, logw, u, chunk)
    b, h, s, dh = r.shape
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
    return y, state, chunk_state


def rwkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
                   u: torch.Tensor, chunk_state: torch.Tensor, state: torch.Tensor,
                   dy: torch.Tensor, dstate: torch.Tensor | None = None):
    """K6' on the card: ``(dr, dk, dv, dlogw, du)`` for the inputs of a K6
    call, its scratch ``chunk_state`` and final ``state`` (``_forward``'s),
    y's gradient ``dy`` and the final state's ``dstate`` (None: zero). dr,
    dk and dv come in r's dtype, contiguous; dlogw and du in float32. One
    count in ``RWKV6_SCAN_BWD.launches["rwkv6_scan_bwd"]``."""
    b, h, s, dh = r.shape
    q = s // chunk_state.shape[2]
    if _check(r, k, v, logw, u, q) != q \
            or tuple(chunk_state.shape) != (b, h, s // q, dh, dh) \
            or tuple(state.shape) != (b, h, dh, dh) or tuple(dy.shape) != tuple(r.shape) \
            or (dstate is not None and tuple(dstate.shape) != (b, h, dh, dh)):
        raise ValueError(f"rwkv6_scan_bwd: chunk_state {tuple(chunk_state.shape)}, state "
                         f"{tuple(state.shape)}, dy {tuple(dy.shape)} do not match r "
                         f"{tuple(r.shape)}")
    dy = dy.float()
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    if dstate is not None:
        dstate = dstate.float().contiguous()
    dev, f32 = r.device, torch.float32
    nc = s // q
    ds = torch.empty((b, h, nc, dh, dh), dtype=f32, device=dev)
    du_part = torch.empty((b, h, nc, dh), dtype=f32, device=dev)
    dr, dk, dv = (torch.empty((b, h, s, dh), dtype=r.dtype, device=dev) for _ in range(3))
    dlogw = torch.empty((b, h, s, dh), dtype=f32, device=dev)
    du = torch.empty((h, dh), dtype=f32, device=dev)
    ll = ctypes.c_longlong
    RWKV6_SCAN_BWD.launch(
        "rwkv6_scan_bwd", ptr(r), ptr(k), ptr(v), ptr(logw), ptr(u.contiguous()),
        ptr(chunk_state), ptr(state), ptr(dy), ptr(dstate), ptr(ds), ptr(du_part),
        ptr(dr), ptr(dk), ptr(dv), ptr(dlogw), ptr(du),
        ctypes.c_int(int(r.dtype == torch.bfloat16)), ctypes.c_int(b), ctypes.c_int(h),
        ctypes.c_int(s), ctypes.c_int(dh), ctypes.c_int(q),
        *(ll(st) for t in (r, k, v, logw, dy) for st in t.stride()[:3]), stream(dev))
    return dr, dk, dv, dlogw, du


class _Rwkv6Scan(torch.autograd.Function):
    """K6 with its gradient: the forward kernel, keeping its scratch and
    final state, and K6' on them and the saved inputs (``plain``: the two
    plain versions in their places). Under ``torch.utils.checkpoint`` the
    forward runs again in the recompute."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, chunk: int, plain: bool):
        ctx.set_materialize_grads(False)
        if plain:
            y, state = rwkv6_scan_plain(r, k, v, logw, u, chunk)
            ctx.save_for_backward(r, k, v, logw, u)
        else:
            y, state, chunk_state = _forward(r, k, v, logw, u, chunk)
            ctx.save_for_backward(r, k, v, logw, u, chunk_state, state)
        ctx.chunk, ctx.plain = chunk, plain
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, logw, u, *scratch = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        if ctx.plain:
            grads = rwkv6_scan_bwd_plain(r, k, v, logw, u, dy, dstate, ctx.chunk)
            grads = tuple(g.to(t.dtype) for g, t in zip(grads, (r, k, v, logw, u)))
        else:
            grads = rwkv6_scan_bwd(r, k, v, logw, u, *scratch, dy, dstate)
        return (*grads, None, None)


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def rwkv6_scan_state(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     logw: torch.Tensor, u: torch.Tensor,
                     chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y, final state)``: r, k, v, logw ``(B, H, S, dh)``, u ``(H, dh)``.

    On a CUDA tensor r, k and v share a dtype (bfloat16 or float32),
    logw and u are float32, ``dh`` is ``HEAD_DIM``, and each of r, k, v
    and logw has a contiguous last axis (other strides are free: the
    model's transposed head views go in as they are). Anything else
    raises. A chunk above ``MAX_CHUNK`` runs as sub-chunks of its largest
    divisor up to ``MAX_CHUNK`` (``_build.kernel_chunk``). The kernel's two
    launches count as one in ``RWKV6_SCAN.launches["rwkv6_scan"]``. Where
    a gradient is needed (grad enabled and an input requiring it) the call
    goes through ``_Rwkv6Scan``: the same forward launch, and K6' in the
    backward; otherwise the forward kernel alone runs.
    """
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, logw, u, chunk)
    if _needs_grad(r, k, v, logw, u):
        return _Rwkv6Scan.apply(r, k, v, logw, u, chunk, False)
    return _forward(r, k, v, logw, u, chunk)[:2]


def rwkv6_scan_plain_pair(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          logw: torch.Tensor, u: torch.Tensor,
                          chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """``rwkv6_scan_state``'s function and gradient through the two plain
    versions (``rwkv6_scan_plain`` and ``rwkv6_scan_bwd_plain``), paired as
    the kernels are (any device): the yardstick a train step through K6 is
    held to on the card."""
    if _needs_grad(r, k, v, logw, u):
        return _Rwkv6Scan.apply(r, k, v, logw, u, chunk, True)
    return rwkv6_scan_plain(r, k, v, logw, u, chunk)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """The Pallas kernel's function: ``(B, H, S, dh)`` fp32 outputs."""
    return rwkv6_scan_state(r, k, v, logw, u, chunk)[0]
