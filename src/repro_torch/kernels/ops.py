"""Public wrappers around the kernels: the DLS-scheduled CC step,
GQA-aware attention and the two recurrent scans."""

from __future__ import annotations

import numpy as np
import torch

from ..core.device_schedule import build_task_table
from .cc_propagate import cc_propagate
from .flash_attention import flash_attention
from .rwkv6_scan import rwkv6_scan
from .ssm_scan import ssm_scan

__all__ = ["cc_step", "attention", "mamba2_chunk_scan", "wkv6", "dls_tile_schedule"]


def dls_tile_schedule(technique: str, n_rows: int, tile_r: int,
                      n_workers: int = 8, seed: int = 0) -> np.ndarray:
    """Row-tile execution order from a DLS technique.

    Chunk sizes are quantized to tile multiples; the returned permutation of
    row-tile indices is the order in which the kernel visits row tiles.
    """
    n_tiles = n_rows // tile_r
    table = build_task_table(technique, n_tiles, n_workers, seed=seed)
    order: list[int] = []
    for start, size in table:
        order.extend(range(int(start), int(start + size)))
    out = np.array(order, dtype=np.int32)
    if len(out) != n_tiles or len(np.unique(out)) != n_tiles:
        raise RuntimeError(f"{technique} schedule is not a permutation of "
                           f"{n_tiles} row tiles")
    return out


def cc_step(G: torch.Tensor, c: torch.Tensor, technique: str = "MFSC",
            n_workers: int = 8, tile_r: int = 256,
            tile_c: int = 1024) -> torch.Tensor:
    """One scheduler-driven CC propagation step (paper Listing 1 kernel)."""
    schedule = torch.from_numpy(dls_tile_schedule(
        technique, G.shape[0], tile_r, n_workers)).to(G.device)
    return cc_propagate(G, c, schedule, tile_r=tile_r, tile_c=tile_c)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, tile_k: int = 512) -> torch.Tensor:
    """GQA-aware attention through K4: q ``(B, H, S, dh)``, k and v
    ``(B, KV, S, dh)``. Query head ``h`` reads kv head ``h // (H // KV)``,
    the reference's ``repeat`` without the copy."""
    return flash_attention(q, k, v, causal=causal, tile_k=tile_k)


def mamba2_chunk_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                      chunk: int = 128) -> torch.Tensor:
    """Mamba2's SSD scan plus ``D * x`` through K5: x ``(Bt, S, H, dh)``,
    dt ``(Bt, S, H)``, A and D ``(H,)``, B and C ``(Bt, S, N)``."""
    return ssm_scan(x, dt, A, B, C, D, chunk=chunk)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
         u: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """RWKV6's WKV through K6: r, k, v, logw ``(Bt, H, S, dh)``, u ``(H, dh)``."""
    return rwkv6_scan(r, k, v, logw, u, chunk=chunk)
