"""Capacity-based MoE routing and dispatch (the port's copy of the routing
and capacity semantics of ``models/moe.py``).

  1. router top-k over (padded) experts; padding experts masked to -inf
  2. position-in-expert via cumsum over one-hot, counted over the
     flattened ``(T*k)`` t-major order; tokens beyond capacity drop
  3. scatter tokens into an ``(E_loc, C, d)`` buffer (a trash row takes the
     dropped ones), batched gated expert FFN, gather back weighted.

``moe_block`` is the reference's single-device body: route, capacity
``max(1, ceil(top_k * B * S * capacity_factor / E_pad))``, dispatch over
every expert, the shared expert's gated MLP, and the Switch aux loss. The
reference's expert-parallel branch (under ``shard_map`` when a mesh is
active) needs the mesh layer (ROADMAP A17), which the port does not have,
so the port has no such branch. The expert products are ``torch.einsum``,
as the reference computes them outside any Pallas kernel. The
scheduler's MoE workload (``vee/ml_apps.py``) routes with the same
``top_k`` and is held to these functions by the tests.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from .layers import Params, he_init, init_mlp, mlp

__all__ = ["NEG_INF", "init_moe", "top_k", "aux_load_balance_loss", "moe_block"]

NEG_INF = -1e30


def init_moe(generator: torch.Generator, d_model: int, moe, device=None,
             dtype=torch.float32) -> Params:
    """Router, routed experts and (if any) the shared expert, He-scaled.

    ``router (d, E)``, ``experts.wi (E, d, 2f)``, ``experts.wo (E, f, d)``,
    ``shared`` a gated MLP of width ``n_shared * f`` — the reference's
    layout, drawn from ``generator`` on ``device``.
    """
    e = moe.n_routed_padded or moe.n_routed
    f = moe.d_ff_expert
    p = {
        "router": he_init(generator, (d_model, e), d_model, device, dtype),
        "experts": {
            "wi": he_init(generator, (e, d_model, 2 * f), d_model, device, dtype),
            "wo": he_init(generator, (e, f, d_model), f, device, dtype),
        },
    }
    if moe.n_shared:
        p["shared"] = init_mlp(generator, d_model, moe.n_shared * f,
                               gated=True, device=device, dtype=dtype)
    return p


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of the last axis and their indices, in
    descending order, the lower index first among equal values: the order
    ``jax.lax.top_k`` returns. ``torch.topk`` leaves the order of equal
    values unspecified, and router probabilities from bf16 logits tie
    exactly: a tie at the k-th place decides which experts a token goes
    to, and one inside the k the order its expert outputs are summed in.
    A stable descending sort keeps the reference's order on every
    device."""
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], idx[..., :k]


def _route(router_w: torch.Tensor, x_flat: torch.Tensor, moe):
    """Returns (expert_idx (T,k), weights (T,k), probs (T,E)) fp32."""
    logits = (x_flat @ router_w.to(x_flat.dtype)).float()
    e_pad = logits.shape[-1]
    if e_pad > moe.n_routed:  # mask padding experts (router never routes there)
        pad = torch.arange(e_pad, device=logits.device) >= moe.n_routed
        logits = torch.where(pad[None, :], torch.full_like(logits, NEG_INF),
                             logits)
    probs = torch.softmax(logits, dim=-1)
    w, idx = top_k(probs, moe.top_k)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)  # renormalize top-k
    return idx, w, probs


def _dispatch_compute_combine(params: Params, x_flat: torch.Tensor,
                              idx: torch.Tensor, w: torch.Tensor,
                              capacity: int, moe) -> torch.Tensor:
    """Scatter -> expert FFN -> weighted gather over this shard's experts.

    ``x_flat (T, d)``; ``idx``/``w (T, k)`` global expert ids and weights;
    ``params['experts']`` holds experts ``[e_lo, e_lo + E_loc)``. Returns
    the ``(T, d)`` partial output (over shards the partials sum).
    """
    e_loc = params["experts"]["wi"].shape[0]
    e_lo = params.get("_e_lo", 0)
    t, d = x_flat.shape
    k = idx.shape[1]
    c = capacity

    local = (idx >= e_lo) & (idx < e_lo + e_loc)                  # (T,k)
    lidx = torch.where(local, idx - e_lo, torch.full_like(idx, e_loc))
    onehot = F.one_hot(lidx.reshape(-1), e_loc + 1)               # (T*k, E+1)
    pos = torch.cumsum(onehot, dim=0) - 1                         # per expert
    pos = torch.gather(pos, 1, lidx.reshape(-1, 1))[:, 0]         # (T*k,)
    keep = local.reshape(-1) & (pos < c)
    slot = torch.where(keep, lidx.reshape(-1) * c + pos,
                       torch.full_like(pos, e_loc * c))           # trash slot

    buf = torch.zeros((e_loc * c + 1, d), dtype=x_flat.dtype,
                      device=x_flat.device)
    src = torch.repeat_interleave(x_flat, k, dim=0)               # (T*k, d)
    buf.index_add_(0, slot, src * keep[:, None].to(x_flat.dtype))
    eb = buf[:-1].reshape(e_loc, c, d)

    wi = params["experts"]["wi"].to(x_flat.dtype)                 # (E,d,2f)
    wo = params["experts"]["wo"].to(x_flat.dtype)                 # (E,f,d)
    h = torch.einsum("ecd,edf->ecf", eb, wi)
    g, u = torch.chunk(h, 2, dim=-1)
    h = F.silu(g) * u
    out = torch.einsum("ecf,efd->ecd", h, wo)                     # (E,C,d)

    out_flat = torch.cat([out.reshape(e_loc * c, d),
                          torch.zeros((1, d), dtype=x_flat.dtype,
                                      device=x_flat.device)])
    gathered = out_flat[slot]                                     # (T*k, d)
    wk = w.reshape(-1, 1).to(x_flat.dtype) * keep[:, None].to(x_flat.dtype)
    return (gathered * wk).reshape(t, k, d).sum(dim=1)


def aux_load_balance_loss(probs: torch.Tensor, idx: torch.Tensor, moe) -> torch.Tensor:
    """Switch-style aux loss ``E * sum_e f_e * p_e`` over the routed
    experts, the hits counted in the probs' dtype."""
    e = moe.n_routed
    hits = F.one_hot(idx, probs.shape[-1]).to(probs.dtype).sum(1)[:, :e]
    f = hits.mean(0) / moe.top_k
    p = probs[:, :e].mean(0)
    return e * torch.sum(f * p)


def moe_block(params: Params, x: torch.Tensor, cfg: Any) -> tuple[torch.Tensor, torch.Tensor]:
    """``x (B, S, d)`` -> ``(y, aux_loss * router_aux_weight)`` on one
    device: routed experts with capacity drops, plus the shared expert."""
    moe = cfg.moe
    b, s, d = x.shape
    x_flat = x.reshape(b * s, d)
    idx, w, probs = _route(params["router"], x_flat, moe)
    e_for_cap = moe.n_routed_padded or moe.n_routed
    cap = max(1, int(math.ceil(moe.top_k * b * s * moe.capacity_factor / e_for_cap)))
    y = _dispatch_compute_combine({**params, "_e_lo": 0}, x_flat, idx, w, cap, moe)
    y = y.reshape(b, s, d)
    aux = aux_load_balance_loss(probs, idx, moe)
    if "shared" in params:
        y = y + mlp(params["shared"], x, gated=True)
    return y, aux * moe.router_aux_weight
