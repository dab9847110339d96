"""Flash-attention forward (K4): online-softmax attention over kv tiles.

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
"""

from __future__ import annotations

import ctypes
import math

import torch

from ._build import FLASH_ATTENTION, ptr, stream

__all__ = ["NEG_INF", "HEAD_DIMS", "WIDTHS", "flash_attention", "flash_attention_plain",
           "kernel_reads_in_place"]

NEG_INF = -1e30
#: (dh, dv) pairs the CUDA kernel is compiled for: every dense config's
#: 128, Zamba2-7B's shared attention's 112, 64, the reduced configs' 16,
#: and DeepSeek-V2-Lite's MLA (q and k 192, v 128)
WIDTHS = ((16, 16), (64, 64), (112, 112), (128, 128), (192, 128))
#: the key widths among them
HEAD_DIMS = tuple(sorted({dh for dh, _ in WIDTHS}))


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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, tile_k: int = 512) -> torch.Tensor:
    """The kernel's recurrence in plain PyTorch (any device).

    Kv tiles past the last query's position are skipped when ``causal``:
    they would add ``exp(-1e30 - m) = 0`` with ``corr = 1``.
    """
    b, h, kvh, sq, skv, dh, dv = _shapes(q, k, v)
    g = h // kvh
    tile_k = min(tile_k, skv)
    scale = 1.0 / math.sqrt(dh)
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
    return out.reshape(b, h, sq, dv).to(q.dtype)


def kernel_reads_in_place(t: torch.Tensor) -> bool:
    """Whether the kernel reads the 4-D ``t`` where it lies, without a copy:
    a contiguous last axis, the other strides a multiple of 16 bytes and
    16-byte aligned data (MLA's v, the view ``kv[..., dn:]``, qualifies)."""
    vec = 16 // t.element_size()
    return (t.stride(3) == 1 and not any(st % vec for st in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, tile_k: int = 512) -> torch.Tensor:
    """Attention forward: q ``(B, H, Sq, dh)``, k ``(B, KV, Skv, dh)`` and
    v ``(B, KV, Skv, dv)``; the output is ``(B, H, Sq, dv)``.

    On a CUDA tensor q, k and v must share a dtype (bfloat16 or float32),
    have ``(dh, dv)`` in ``WIDTHS``, a contiguous last axis, other strides a
    multiple of 16 bytes and 16-byte aligned data (``_split_heads``'s
    transposed views qualify as they are); the kernel writes a contiguous
    output. Anything else raises.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, tile_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, h, kvh, sq, skv, dh, dv = _shapes(q, k, v)
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes bfloat16 or float32 q, k "
                         f"and v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if (dh, dv) not in WIDTHS:
        raise ValueError(f"flash_attention kernel takes dh in {HEAD_DIMS} with "
                         f"(dh, dv) one of {WIDTHS}, got ({dh}, {dv})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
        if not kernel_reads_in_place(t):
            raise ValueError(f"flash_attention kernel: {name} needs a contiguous "
                             f"last axis, strides a multiple of "
                             f"{16 // t.element_size()} elements and 16-byte "
                             f"aligned data, got strides {t.stride()}")
    out = torch.empty((b, h, sq, dv), dtype=q.dtype, device=q.device)
    ll = ctypes.c_longlong
    FLASH_ATTENTION.launch(
        "flash_attention", ptr(q), ptr(k), ptr(v), ptr(out),
        ctypes.c_int(int(q.dtype == torch.bfloat16)), ctypes.c_int(b),
        ctypes.c_int(h), ctypes.c_int(kvh), ctypes.c_int(sq), ctypes.c_int(skv),
        ctypes.c_int(dh), ctypes.c_int(dv), *(ll(st) for t in (q, k, v) for st in t.stride()[:3]),
        ctypes.c_int(int(causal)),
        ctypes.c_float(1.0 / math.sqrt(dh)), stream(q.device))
    return out
