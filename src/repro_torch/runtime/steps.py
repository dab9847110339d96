"""Train / serve step builders (the port's copy of ``runtime/steps.py``).

``build_train_step``   (state, batch) -> (state, metrics): AdamW, optional
                       gradient accumulation over microbatches, int8
                       error-feedback compression.
``build_prefill_step`` (params, batch, cache) -> (logits, cache)
``build_decode_step``  (params, tokens, cache, index) -> (logits, cache)

The reference jits these under its mesh's axis rules; the port runs them
eagerly on one device (the mesh waits for ROADMAP A17). Gradients come
from ``torch.autograd.grad`` on detached leaves of the params, so a step
reads ``state`` and returns a new one, as the reference's pure step does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Any

import torch

from ..optim.adamw import (AdamWConfig, apply_updates, init_opt_state, tree_leaves,
                           tree_map)

if TYPE_CHECKING:
    from ..models.model import Model

__all__ = ["TrainState", "init_train_state", "loss_and_grads", "build_train_step",
           "build_prefill_step", "build_decode_step"]


@dataclass
class TrainState:
    params: Any
    opt: Any
    step: Any


def init_train_state(model: "Model", generator: torch.Generator,
                     opt_cfg: AdamWConfig) -> TrainState:
    """Params drawn from ``generator`` (on its device), zero moments, step 0."""
    params = model.init_params(generator)
    device = tree_leaves(params)[0].device
    return TrainState(params=params, opt=init_opt_state(params, opt_cfg),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def loss_and_grads(model: "Model", params, batch: dict):
    """``(loss, metrics, grads)`` of ``model.train_loss`` at ``params``:
    ``jax.value_and_grad(..., has_aux=True)``. The grads are fp32, shaped
    as ``params``."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = model.train_loss(leaves, batch)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(p): (torch.zeros_like(p) if g is None else g) for p, g in zip(flat, grads)}
    grads = tree_map(lambda p: by_id[id(p)], leaves)
    metrics = {k: (v.detach() if isinstance(v, torch.Tensor) else torch.tensor(v))
               for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def build_train_step(model: "Model", opt_cfg: AdamWConfig, n_microbatches: int = 1,
                     in_place: bool = False):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``in_place``: the step writes the new params and moments over the old
    state's (``apply_updates(in_place=True)``: the same bits), which the
    caller gives up; the launcher steps so. A failure before the first
    write leaves the state as it was, and ``run_loop`` may retry the step;
    one after raises ``PartialUpdateError``, which it does not retry.

    ``n_microbatches > 1`` splits the batch into equal microbatches along
    its first axis and averages their gradients and losses, the metrics
    then ``{'ce': loss, 'aux': 0}`` as the reference's. (The reference
    also takes ``microbatch_sizes`` and leaves it unused; the port has no
    such argument.)
    """

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        params = state.params
        if n_microbatches <= 1:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        else:
            grads, loss = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                                   params), None
            for i in range(n_microbatches):
                sub = {k: a[i * (a.shape[0] // n_microbatches):
                            (i + 1) * (a.shape[0] // n_microbatches)]
                       for k, a in batch.items()}
                l_i, _, g_i = loss_and_grads(model, params, sub)
                grads = tree_map(torch.add, grads, g_i)
                loss = l_i if loss is None else loss + l_i
            grads = tree_map(lambda g: g / n_microbatches, grads)
            loss = loss / n_microbatches
            metrics = {"ce": loss, "aux": torch.zeros((), device=loss.device)}
        new_params, new_opt, opt_metrics = apply_updates(params, grads, state.opt, opt_cfg,
                                                         in_place=in_place)
        new_state = TrainState(params=new_params, opt=new_opt, step=state.step + 1)
        return new_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def build_prefill_step(model: "Model"):
    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache)
    return prefill_step


def build_decode_step(model: "Model"):
    def decode_step(params, tokens, cache, cache_index):
        return model.decode_step(params, tokens, cache, cache_index)
    return decode_step
