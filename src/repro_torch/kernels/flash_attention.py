"""Flash attention (K4): the online-softmax forward and its gradient.

The function of the Pallas kernel ``repro/kernels/flash_attention.py:
flash_attention``, GQA included (``ops.attention`` of the reference repeats
each kv head; here query head ``h`` reads kv head ``h // (H // KV)`` in
place), with a value width ``dv`` of its own, as the reference's
``chunked_attention`` takes it (MLA: q and k 192 wide, v 128):

* ``s = (q . k^T in fp32) * scale``, masked with ``NEG_INF = -1e30``
  where a key lies after its query (``causal``; query row ``i`` and key
  ``i`` share a position, as in the reference kernel);
* ``m``, ``l`` and ``acc`` in fp32, updated once per kv tile;
* ``l`` sums the unrounded fp32 ``p``; ``p`` is rounded to v's type before
  ``p . v`` (accumulated in fp32);
* ``out = acc / max(l, 1e-30)``, rounded to q's type.

CUDA kernel: ``csrc/flash_attention.cu`` (its note gives the design and the
bound): bfloat16 runs both products on the tensor cores (``wgmma``),
float32 on fp32 FMA. On a CPU tensor ``flash_attention`` runs
``flash_attention_plain``, the same tile recurrence in PyTorch; on a CUDA
tensor it launches the kernel or raises. ``tile_k`` is the plain
version's kv tile, the grouping of the online-softmax updates, which
moves only fp32 rounding; the kernel's kv tiles are 128 keys (bfloat16)
or 64 (float32). Each row's recurrence does not depend on the q tiling,
so the plain version takes all query rows at once.

The gradient. The JAX package differentiates its chunked attention op by
op (``jax.value_and_grad`` in ``runtime/steps.py``); on a CPU tensor
autograd does the same through ``flash_attention_plain``'s ops. On a CUDA
tensor that needs a gradient (grad enabled and q, k or v requiring it)
``flash_attention`` goes through ``_FlashAttention``, a
``torch.autograd.Function``: its forward launches the same kernel and has
it write each row's log-sum-exp ``m + log l`` (fp32) beside the output,
and its backward launches ``csrc/flash_attention_bwd.cu`` (the standard
recurrences, its note gives the design: bfloat16 on ``wgmma`` with P and
dS rounded to bfloat16 as operands, float32 on fp32 FMA, chosen by
dtype), whose plain version is ``flash_attention_bwd_plain``. A call
without a gradient passes no LSE buffer, and its output is bit for bit
the same. The backward never falls
back to its plain version; a ``dout`` the kernel cannot read in place
(``kernel_reads_in_place``) is copied to contiguous, counted in
``DOUT_COPIES``. ``flash_attention_plain_pair`` is the same Function with
the two plain versions in the kernels' places (the same route, padding
included), the yardstick on the card.

Head widths. The Pallas kernel takes any ``dh``; the CUDA kernels are
compiled for the ``(dh, dv)`` pairs of ``WIDTHS``. On a CUDA tensor any
other pair up to ``MAX_WIDTHS`` runs on the smallest compiled pair that
covers it (``compiled_widths``): q and k zero-padded to its dh, v (and in
the backward the output and ``dout``) to its dv, the launch given the
true width's ``1/sqrt(dh)``, and the output, dq, dk and dv sliced back.
Zero columns add exactly 0 to ``q . k`` and leave the padded output and
gradient columns 0, so the result is the unpadded function's. The copies
are counted in ``PAD_COPIES``. ``_forward(..., plain=True)`` and
``flash_attention_bwd(..., plain=True)`` run the same route with the
plain versions (``scale`` given) in the kernels' places, on any device:
``flash_attention_plain_pair`` goes through them, and the CPU tests hold
them to the reference.

Strides. The kernels read the q, k, v (and ``dout``) they are handed where
they lie (``kernel_reads_in_place``). At a pair of ``WIDTHS`` that is the
caller's tensor, and a view the kernel cannot read raises (``dout``: is
copied, see above); off one it is the padded copy, new and contiguous, so
any view runs.
"""

from __future__ import annotations

import ctypes
import math

import torch

from collections import Counter

from ._build import FLASH_ATTENTION, FLASH_ATTENTION_BWD, ptr, stream

__all__ = ["NEG_INF", "WIDTHS", "MAX_WIDTHS", "DOUT_COPIES", "PAD_COPIES",
           "compiled_widths", "flash_attention", "flash_attention_plain",
           "flash_attention_lse_plain", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_plain_pair",
           "kernel_reads_in_place"]

NEG_INF = -1e30
#: (dh, dv) pairs the CUDA kernels are compiled for, growing in both
#: widths: the reduced configs' 16, 64, the ``train_lm`` example's ~100M
#: configuration's 96 (768 over 8 heads), Zamba2-7B's shared attention's
#: 112, every dense config's 128, and DeepSeek-V2-Lite's MLA (q and k 192,
#: v 128)
WIDTHS = ((16, 16), (64, 64), (96, 96), (112, 112), (128, 128), (192, 128))
#: the widest pair: a wider one raises (ROADMAP B0)
MAX_WIDTHS = WIDTHS[-1]
#: copies of a ``dout`` the backward kernel could not read in place, made
#: by ``flash_attention_bwd`` before its launch (``"dout"``)
DOUT_COPIES: Counter = Counter()
#: zero-padded copies made to reach a compiled pair, by tensor (``"q"``,
#: ``"k"``, ``"v"``; the backward's ``"out"`` and ``"dout"`` too)
PAD_COPIES: Counter = Counter()


def compiled_widths(dh: int, dv: int) -> tuple[int, int]:
    """The compiled ``(dh, dv)`` pair a call at ``(dh, dv)`` runs on: the
    first of ``WIDTHS`` that covers both, so the pair itself when it is
    compiled. Raises above ``MAX_WIDTHS``, naming ROADMAP B0."""
    for pair in WIDTHS:
        if dh <= pair[0] and dv <= pair[1]:
            return pair
    raise ValueError(f"flash_attention kernels take dh <= {MAX_WIDTHS[0]} and dv <= "
                     f"{MAX_WIDTHS[1]}, got ({dh}, {dv}): wider heads are ROADMAP B0's, "
                     "and no config or example of the repo uses them")


def _padded(t: torch.Tensor, width: int, name: str) -> torch.Tensor:
    """``t`` with its last axis zero-padded to ``width``: a new contiguous
    tensor, counted in ``PAD_COPIES[name]``; ``t`` itself when as wide."""
    if t.shape[-1] == width:
        return t
    out = t.new_zeros((*t.shape[:-1], width))
    out[..., :t.shape[-1]].copy_(t)
    PAD_COPIES[name] += 1
    return out


def _shapes(q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor) -> tuple[int, int, int, int, int, int, int]:
    """(B, H, KV, Sq, Skv, dh, dv) of q (B, H, Sq, dh), k (B, KV, Skv, dh)
    and v (B, KV, Skv, dv)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: need (B, H, Sq, dh), then k and v "
                         "with two equal (B, KV, Skv) leading axes, k (..., dh) "
                         "and v (..., dv)")
    b, h, sq, dh = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or kvh < 1 or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: batch and "
                         "head width must match and KV must divide H")
    return b, h, kvh, sq, skv, dh, v.shape[3]


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              causal: bool = True, tile_k: int = 512,
                              scale: float | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's recurrence in plain PyTorch (any device): the output
    and each row's log-sum-exp ``m + log l`` (fp32, ``(B, H, Sq)``).
    ``scale`` defaults to ``1/sqrt(dh)``.

    Kv tiles past the last query's position are skipped when ``causal``:
    they would add ``exp(-1e30 - m) = 0`` with ``corr = 1``.
    """
    b, h, kvh, sq, skv, dh, dv = _shapes(q, k, v)
    g = h // kvh
    tile_k = min(tile_k, skv)
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    qf = q.float().reshape(b, kvh, g, sq, dh)
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, g, sq, dv), dtype=torch.float32, device=q.device)
    qpos = torch.arange(sq, device=q.device)[:, None]
    end = min(skv, sq) if causal else skv  # past the last query
    for k0 in range(0, end, tile_k):
        kt = k[:, :, k0:k0 + tile_k].float()
        vt = v[:, :, k0:k0 + tile_k]
        s = torch.einsum("bkgqd,bkvd->bkgqv", qf, kt) * scale
        if causal:
            kpos = torch.arange(k0, k0 + kt.shape[2], device=q.device)[None, :]
            s = torch.where(qpos >= kpos, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqv,bkvd->bkgqd", p.to(v.dtype).float(), vt.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, sq, dv).to(q.dtype), (m + torch.log(l)).reshape(b, h, sq)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, tile_k: int = 512) -> torch.Tensor:
    """The forward kernel's function in plain PyTorch (any device); autograd
    differentiates its ops on the CPU."""
    return flash_attention_lse_plain(q, k, v, causal, tile_k)[0]


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                              causal: bool = True, tile_k: int = 512,
                              scale: float | None = None):
    """The backward kernel's recurrences in plain PyTorch (any device):
    ``(dq, dk, dv)`` in q's, k's and v's types; ``scale`` defaults to
    ``1/sqrt(dh)``.

    ``D = rowsum(dout * out)``; per kv tile ``P = exp(s * scale - lse)``
    (0 where masked), ``dV += P^T dout``, ``dS = P (dout v^T - D)``, ``dQ
    += dS k``, ``dK = dS^T q`` summed over the group's query heads; dQ and
    dK times ``scale`` at the end; all in fp32. For bfloat16 inputs P and
    dS are rounded to bfloat16 where the kernel rounds them, as the A
    operands of their products (``dV``; ``dQ`` and ``dK``), after dS is
    formed from the unrounded P. ``out`` of zeros drops the D term (the
    control the card tests hold the kernel's limit against).
    """
    b, h, kvh, sq, skv, dh, dv = _shapes(q, k, v)
    g = h // kvh
    tile_k = min(tile_k, skv)
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    qf = q.float().reshape(b, kvh, g, sq, dh)
    dof = dout.float().reshape(b, kvh, g, sq, dv)
    delta = (dof * out.float().reshape(b, kvh, g, sq, dv)).sum(-1)
    lse_ = lse.float().reshape(b, kvh, g, sq, 1)
    dq = torch.zeros((b, kvh, g, sq, dh), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, kvh, skv, dh), dtype=torch.float32, device=q.device)
    dvv = torch.zeros((b, kvh, skv, dv), dtype=torch.float32, device=q.device)
    qpos = torch.arange(sq, device=q.device)[:, None]
    end = min(skv, sq) if causal else skv

    def rounded(x: torch.Tensor) -> torch.Tensor:
        return x.to(q.dtype).float() if q.dtype == torch.bfloat16 else x

    for k0 in range(0, end, tile_k):
        kt = k[:, :, k0:k0 + tile_k].float()
        vt = v[:, :, k0:k0 + tile_k].float()
        p = torch.exp(torch.einsum("bkgqd,bkvd->bkgqv", qf, kt) * scale - lse_)
        if causal:
            kpos = torch.arange(k0, k0 + kt.shape[2], device=q.device)[None, :]
            p = torch.where(qpos >= kpos, p, torch.zeros_like(p))
        ds = p * (torch.einsum("bkgqd,bkvd->bkgqv", dof, vt) - delta[..., None])
        p, ds = rounded(p), rounded(ds)
        dq += torch.einsum("bkgqv,bkvd->bkgqd", ds, kt)
        dk[:, :, k0:k0 + tile_k] = torch.einsum("bkgqv,bkgqd->bkvd", ds, qf)
        dvv[:, :, k0:k0 + tile_k] = torch.einsum("bkgqv,bkgqd->bkvd", p, dof)
    return ((dq * scale).reshape(b, h, sq, dh).to(q.dtype), (dk * scale).to(k.dtype),
            dvv.to(v.dtype))


def kernel_reads_in_place(t: torch.Tensor) -> bool:
    """Whether the kernel reads the 4-D ``t`` where it lies, without a copy:
    a contiguous last axis, the other strides a multiple of 16 bytes and
    16-byte aligned data (MLA's v, the view ``kv[..., dn:]``, qualifies)."""
    vec = 16 // t.element_size()
    return (t.stride(3) == 1 and not any(st % vec for st in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           what: str = "flash_attention") -> tuple:
    """The shapes of a kernel call on the card; raises on a device or
    dtype the kernels do not take (``compiled_widths`` on a width)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    shapes = _shapes(q, k, v)
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{what} kernel takes bfloat16 or float32 q, k "
                         f"and v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
    return shapes


def _in_place(what: str, **tensors: torch.Tensor) -> None:
    """Raise unless the kernel reads each tensor where it lies: the one
    stride rule, applied after padding (see the module's note)."""
    for name, t in tensors.items():
        if not kernel_reads_in_place(t):
            raise ValueError(f"{what} kernel: {name} needs a contiguous "
                             f"last axis, strides a multiple of "
                             f"{16 // t.element_size()} elements and 16-byte "
                             f"aligned data, got strides {t.stride()}")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
             with_lse: bool, plain: bool = False,
             tile_k: int = 512) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch the forward kernel on the compiled pair covering ``(dh,
    dv)`` (q, k and v zero-padded where narrower, the true width's scale,
    the output sliced back); the LSE buffer only when ``with_lse``.
    ``plain``: the plain version in the kernel's place (any device; the
    LSE always)."""
    b, h, kvh, sq, skv, dh, dv = _shapes(q, k, v) if plain else _check(q, k, v)
    pdh, pdv = compiled_widths(dh, dv)
    scale = 1.0 / math.sqrt(dh)
    q, k, v = _padded(q, pdh, "q"), _padded(k, pdh, "k"), _padded(v, pdv, "v")
    if plain:
        out, lse = flash_attention_lse_plain(q, k, v, causal, tile_k, scale)
    else:
        _in_place("flash_attention", q=q, k=k, v=v)
        out = torch.empty((b, h, sq, pdv), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, h, sq), dtype=torch.float32,
                          device=q.device) if with_lse else None
        ll = ctypes.c_longlong
        FLASH_ATTENTION.launch(
            "flash_attention", ptr(q), ptr(k), ptr(v), ptr(out), ptr(lse),
            ctypes.c_int(int(q.dtype == torch.bfloat16)), ctypes.c_int(b),
            ctypes.c_int(h), ctypes.c_int(kvh), ctypes.c_int(sq), ctypes.c_int(skv),
            ctypes.c_int(pdh), ctypes.c_int(pdv),
            *(ll(st) for t in (q, k, v) for st in t.stride()[:3]),
            ctypes.c_int(int(causal)), ctypes.c_float(scale), stream(q.device))
    return (out if pdv == dv else out[..., :dv].contiguous()), lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                        causal: bool = True, plain: bool = False, tile_k: int = 512):
    """``(dq, dk, dv)`` by the backward kernel (CUDA tensors only): ``out``
    and ``lse`` are the forward kernel's output and LSE on the same q, k,
    v; ``dout`` the output's gradient. q, k and v as ``flash_attention``
    takes them; ``out`` contiguous, ``lse`` contiguous fp32 ``(B, H,
    Sq)``. Off a compiled pair, q, k, v, ``out`` and ``dout`` are
    zero-padded to the pair covering ``(dh, dv)`` and the gradients sliced
    back (``PAD_COPIES``). Else a ``dout`` the kernel cannot read in place
    is copied to contiguous (``DOUT_COPIES``). Three launches (D, dK/dV,
    dQ), counted once in ``FLASH_ATTENTION_BWD.launches[
    "flash_attention_bwd"]``. ``plain``: the same route with the plain
    version in the kernel's place, on any device."""
    b, h, kvh, sq, skv, dh, dv = (_shapes(q, k, v) if plain
                                  else _check(q, k, v, "flash_attention_bwd"))
    if out.shape != (b, h, sq, dv) or dout.shape != out.shape or out.dtype != q.dtype \
            or dout.dtype != q.dtype or not out.is_contiguous() \
            or lse.shape != (b, h, sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() \
            or any(t.device != q.device for t in (out, dout, lse)):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} {out.dtype}, dout "
                         f"{tuple(dout.shape)} {dout.dtype} and lse {tuple(lse.shape)} "
                         f"{lse.dtype} do not match q {tuple(q.shape)} {q.dtype}, or "
                         "out / lse are not contiguous")
    pdh, pdv = compiled_widths(dh, dv)
    scale = 1.0 / math.sqrt(dh)
    q, k = _padded(q, pdh, "q"), _padded(k, pdh, "k")
    v, out, dout = _padded(v, pdv, "v"), _padded(out, pdv, "out"), _padded(dout, pdv, "dout")
    if plain:
        grads = flash_attention_bwd_plain(q, k, v, out, dout, lse, causal, tile_k, scale)
    else:
        _in_place("flash_attention_bwd", q=q, k=k, v=v)
        if not kernel_reads_in_place(dout):
            dout = dout.contiguous()
            DOUT_COPIES["dout"] += 1
        grads = (torch.empty((b, h, sq, pdh), dtype=q.dtype, device=q.device),
                 torch.empty((b, kvh, skv, pdh), dtype=q.dtype, device=q.device),
                 torch.empty((b, kvh, skv, pdv), dtype=q.dtype, device=q.device))
        delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        ll = ctypes.c_longlong
        FLASH_ATTENTION_BWD.launch(
            "flash_attention_bwd", ptr(q), ptr(k), ptr(v), ptr(out), ptr(dout), ptr(lse),
            ptr(delta), *(ptr(g) for g in grads),
            ctypes.c_int(int(q.dtype == torch.bfloat16)), ctypes.c_int(b),
            ctypes.c_int(h), ctypes.c_int(kvh), ctypes.c_int(sq), ctypes.c_int(skv),
            ctypes.c_int(pdh), ctypes.c_int(pdv),
            *(ll(st) for t in (q, k, v, dout) for st in t.stride()[:3]),
            ctypes.c_int(int(causal)), ctypes.c_float(scale), stream(q.device))
    return tuple(g if g.shape[-1] == w else g[..., :w].contiguous()
                 for g, w in zip(grads, (dh, dh, dv)))


class _FlashAttention(torch.autograd.Function):
    """K4 with its gradient: the forward kernel writing the LSE, the
    backward kernel on the saved q, k, v, output and LSE (``plain``: the
    two plain versions in their places). Under ``torch.utils.checkpoint``
    the forward runs again in the recompute and writes the same LSE."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, tile_k: int, plain: bool):
        out, lse = _forward(q, k, v, causal, with_lse=True, plain=plain, tile_k=tile_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.tile_k, ctx.plain = causal, tile_k, plain
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        grads = flash_attention_bwd(q, k, v, out, dout, lse, ctx.causal, plain=ctx.plain,
                                    tile_k=ctx.tile_k)
        return (*grads, None, None, None)


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, tile_k: int = 512) -> torch.Tensor:
    """Attention forward: q ``(B, H, Sq, dh)``, k ``(B, KV, Skv, dh)`` and
    v ``(B, KV, Skv, dv)``; the output is ``(B, H, Sq, dv)``.

    On a CUDA tensor q, k and v must share a dtype (bfloat16 or float32)
    and have ``dh`` and ``dv`` within ``MAX_WIDTHS`` (off ``WIDTHS``
    zero-padded, ``compiled_widths``); the strides follow the module's
    rule (``_split_heads``'s transposed views qualify as they are). The
    output is contiguous. Anything else raises. Where a gradient is needed the call goes
    through ``_FlashAttention`` (forward kernel with the LSE, backward
    kernel); otherwise the forward kernel alone runs, without an LSE.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, tile_k)
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, tile_k, False)
    return _forward(q, k, v, causal, with_lse=False)[0]


def flash_attention_plain_pair(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               causal: bool = True, tile_k: int = 512) -> torch.Tensor:
    """``flash_attention``'s function and gradient through the two plain
    versions (``flash_attention_lse_plain`` and
    ``flash_attention_bwd_plain``) on the kernels' route, padding included,
    paired as the kernels are (any device): the yardstick a train step
    through K4 is held to on the card."""
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, tile_k, True)
    return _forward(q, k, v, causal, with_lse=False, plain=True, tile_k=tile_k)[0]
