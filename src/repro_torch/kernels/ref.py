"""Plain PyTorch oracles for the kernels (the ground truth of the tests)."""

from __future__ import annotations

import torch


def cc_propagate_ref(G: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """u[i] = max(max_{j: G[i,j] != 0} c[j], c[i]).  G: (n, n) dense {0,1}."""
    neigh = torch.where(G > 0, c[None, :], torch.zeros((), dtype=c.dtype,
                                                       device=c.device))
    return torch.maximum(neigh.amax(dim=1), c)
