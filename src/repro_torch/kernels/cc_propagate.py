"""DLS-scheduled connected-components propagation (the paper's VEE hot spot).

One CC step: ``u[i] = max(max_{j in N(i)} c[j], c[i])`` over a dense {0, 1}
adjacency. The row-tile visit ORDER is an input — a permutation produced by
any of the 11 partitioning techniques (``ops.dls_tile_schedule``); the
result does not depend on it, because max is exact.

CUDA kernel: ``csrc/cc_propagate.cu``. It replaces the Pallas kernel
``repro/kernels/cc_propagate.py:cc_propagate``. The step reads the n x n
adjacency once, so it is bound by bytes (4 n^2 over the card's memory
rate: 0.32 ms at n = 16,384 on an H100), and the whole card streams it: a
grid that fills every SM takes work items of (slot, 8 rows of the slot's
row tile) in the schedule's slot order, so row tiles are begun in the DLS
order; padding slots (a tile index below 0 or past the last tile) do
nothing. Each warp streams one row with several 16-byte loads in flight a
lane, keeping a running max seeded with the row's own label.

On a CPU tensor ``cc_propagate`` runs ``cc_propagate_plain``, the same
tile walk in PyTorch; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CC_PROPAGATE, ptr, stream

DEFAULT_TILE_R = 256
DEFAULT_TILE_C = 1024


def propagate_body(j: int, G: torch.Tensor, c_col: torch.Tensor,
                   c_row: torch.Tensor, out: torch.Tensor) -> None:
    """One (row-tile, col-tile) step of CC propagation, in place on ``out``.

    The plain walk below and the walker's CC stage share this body: ``j``
    is the column-tile index, and column tile 0 seeds ``out`` with the
    row tile's own labels.
    """
    if j == 0:
        out.copy_(c_row)
    # labels are >= 1; masked entries contribute 0 (never win the max)
    vals = torch.where(G > 0, c_col[None, :], torch.zeros_like(c_col)[None, :])
    torch.maximum(out, vals.amax(dim=1), out=out)


def _check(G: torch.Tensor, schedule: torch.Tensor, tile_r: int,
           tile_c: int) -> int:
    n = G.shape[0]
    if G.shape != (n, n) or n % tile_r or n % tile_c:
        raise ValueError(f"G {tuple(G.shape)} must be square with n a multiple "
                         f"of tile_r={tile_r} and tile_c={tile_c}")
    if tuple(schedule.shape) != (n // tile_r,):
        raise ValueError(f"schedule {tuple(schedule.shape)} must be "
                         f"({n // tile_r},), one entry per row tile")
    return n


def cc_propagate_plain(G: torch.Tensor, c: torch.Tensor,
                       schedule: torch.Tensor, tile_r: int = DEFAULT_TILE_R,
                       tile_c: int = DEFAULT_TILE_C) -> torch.Tensor:
    """The kernel's tile walk in plain PyTorch (any device)."""
    n = _check(G, schedule, tile_r, tile_c)
    c = c.to(torch.float32)
    out = torch.empty(n, dtype=torch.float32, device=G.device)
    for t in schedule.tolist():
        rows = slice(t * tile_r, (t + 1) * tile_r)
        for j in range(n // tile_c):
            cols = slice(j * tile_c, (j + 1) * tile_c)
            propagate_body(j, G[rows, cols], c[cols], c[rows], out[rows])
    return out


def cc_propagate(G: torch.Tensor, c: torch.Tensor, schedule: torch.Tensor,
                 tile_r: int = DEFAULT_TILE_R,
                 tile_c: int = DEFAULT_TILE_C) -> torch.Tensor:
    """One propagation step.

    G: (n, n) dense {0, 1}; c: (n,) labels (cast to float32); schedule:
    (n // tile_r,) int — the row-tile index per slot, in DLS order. On a
    CUDA tensor G must be float32 and contiguous.
    """
    if G.device.type == "cpu":
        return cc_propagate_plain(G, c, schedule, tile_r, tile_c)
    if G.device.type != "cuda":
        raise ValueError(f"cc_propagate: unsupported device {G.device}")
    n = _check(G, schedule, tile_r, tile_c)
    if G.dtype != torch.float32 or not G.is_contiguous():
        raise ValueError("cc_propagate kernel takes a contiguous float32 G")
    c = c.to(device=G.device, dtype=torch.float32).contiguous()
    sched = schedule.to(device=G.device, dtype=torch.int32).contiguous()
    if c.shape != (n,):
        raise ValueError(f"labels {tuple(c.shape)} must be ({n},)")
    if G.data_ptr() % 16 or c.data_ptr() % 16 or tile_c % 4:
        raise ValueError("cc_propagate kernel reads 16-byte vectors: G and c "
                         "must be 16-byte aligned and tile_c a multiple of 4")
    out = torch.empty(n, dtype=torch.float32, device=G.device)
    CC_PROPAGATE.launch("cc_propagate", ptr(G), ptr(c), ptr(sched), ptr(out),
                        ctypes.c_int(n), ctypes.c_int(tile_r),
                        ctypes.c_int(tile_c), stream(G.device))
    return out
