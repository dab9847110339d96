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
