"""Capacity-based MoE routing and dispatch (the port's copy of the routing
and capacity semantics of ``models/moe.py``).

  1. router top-k over (padded) experts; padding experts masked to -inf
  2. position-in-expert via cumsum over one-hot, counted over the
     flattened ``(T*k)`` t-major order; tokens beyond capacity drop
  3. scatter tokens into an ``(E_loc, C, d)`` buffer (a trash row takes the
     dropped ones), batched gated expert FFN, gather back weighted.

``moe_block`` and the auxiliary load-balance loss need the sharding rules
and the model stack, and wait for ROADMAP A11. The scheduler's MoE
workload (``vee/ml_apps.py``) is held to these functions by the tests.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import Params, he_init, init_mlp

__all__ = ["NEG_INF", "init_moe"]

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


def _route(router_w: torch.Tensor, x_flat: torch.Tensor, moe):
    """Returns (expert_idx (T,k), weights (T,k), probs (T,E)) fp32."""
    logits = (x_flat @ router_w.to(x_flat.dtype)).float()
    e_pad = logits.shape[-1]
    if e_pad > moe.n_routed:  # mask padding experts (router never routes there)
        pad = torch.arange(e_pad, device=logits.device) >= moe.n_routed
        logits = torch.where(pad[None, :], torch.full_like(logits, NEG_INF),
                             logits)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, moe.top_k, dim=-1)
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
