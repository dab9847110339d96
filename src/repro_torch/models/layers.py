"""Parameter initializers (the port's copy of ``models/layers.py``'s
``he_init`` and ``init_mlp``).

Params are nested dicts of tensors, as in the reference. Every initializer
takes an explicit ``torch.Generator`` and device: the reference draws
from ``jax.random`` keys, which give other numbers from the same seed, so
a test that needs both packages on the same weights converts the
reference's arrays (``vee/ml_apps.py:moe_params_from_reference``).
"""

from __future__ import annotations

import math

import torch

__all__ = ["Params", "he_init", "init_mlp"]

Params = dict


def he_init(generator: torch.Generator, shape, fan_in: int,
            device=None, dtype=torch.float32) -> torch.Tensor:
    """Normal draws scaled by ``1/sqrt(fan_in)``, made on ``device``.

    ``device`` defaults to the generator's; a CUDA generator draws on the
    card, so full-width weights never pass through the host.
    """
    device = generator.device if device is None else torch.device(device)
    return torch.randn(tuple(shape), generator=generator, device=device,
                       dtype=dtype) * (1.0 / math.sqrt(fan_in))


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             gated: bool = True, bias: bool = False, device=None,
             dtype=torch.float32) -> Params:
    """``wi (d_model, 2*d_ff or d_ff)`` and ``wo (d_ff, d_model)``, He-scaled."""
    wi_cols = 2 * d_ff if gated else d_ff
    p = {
        "wi": he_init(generator, (d_model, wi_cols), d_model, device, dtype),
        "wo": he_init(generator, (d_ff, d_model), d_ff, device, dtype),
    }
    if bias:
        dev = p["wi"].device
        p["bi"] = torch.zeros((wi_cols,), dtype=dtype, device=dev)
        p["bo"] = torch.zeros((d_model,), dtype=dtype, device=dev)
    return p
