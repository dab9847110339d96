"""AdamW with fp32 master weights, global-norm clipping, the LR schedule and
optional int8 error-feedback gradient compression (the port's copy of
``optim/adamw.py``).

Plain functions on trees of tensors (nested dicts and lists, as the port's
params are), not ``torch.optim.AdamW``: the update is the reference's,
leaf by leaf, with clipping on the global norm, bias correction and
decoupled weight decay on every leaf (norms and biases included), all in
fp32. ``compress`` quantizes each gradient to int8 with a per-tensor scale
and keeps the quantization error in an error-feedback buffer (``err``),
as the reference does before its all-reduce; on one card there is no
all-reduce, so it only changes the numbers the update sees, as there.

The functions are pure, as the reference's: ``apply_updates`` returns new
params and a new state and leaves its arguments as they were. With
``in_place`` it copies each leaf's new values over the params and moments
it is given (the same arithmetic, so the same bits) and returns them: a
step then holds one copy of the weights and moments, not two, which
RWKV6-3B's 36.9 GB of fp32 weights and moments beside 12.3 GB of
gradients need on one 80 GB card. A failure after the first copy leaves
the state part new and part old: it raises ``PartialUpdateError``, which
is not retried.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

__all__ = ["AdamWConfig", "lr_schedule", "init_opt_state", "global_norm",
           "apply_updates", "PartialUpdateError", "tree_map", "tree_leaves"]

Params = Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    compress: bool = False   # int8 error-feedback gradient compression


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (dicts and lists), with the
    matching leaves of each tree in ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree``: dict entries by sorted key (``jax.tree``'s
    order), list entries in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``: a float32
    scalar, each operation in float32 as the reference's."""
    device = step.device if isinstance(step, torch.Tensor) else None
    step = _f32(step, device)
    warm = step / _f32(max(1.0, cfg.warmup_steps), device)
    prog = (step - _f32(cfg.warmup_steps, device)) / _f32(
        max(1.0, cfg.total_steps - cfg.warmup_steps), device)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = _f32(cfg.min_lr_ratio, device) + _f32((1 - cfg.min_lr_ratio) * 0.5, device) * (
        1 + torch.cos(_f32(math.pi, device) * prog))
    return _f32(cfg.lr, device) * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Params, cfg: AdamWConfig) -> dict:
    """Zero ``mu`` and ``nu`` (and ``err`` under ``compress``) in fp32,
    shaped as ``params``, and step 0 (an int32 scalar)."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    device = tree_leaves(params)[0].device
    state = {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.compress:
        state["err"] = tree_map(zeros, params)
    return state


def _stacked_map(fn: Callable, tree, *rest, path: tuple = ()):
    """``tree_map`` whose ``fn`` also takes the leaf's stacked path: its dict
    keys without list indices, the path of the reference's leaf that stacks
    the port's per-layer leaves (``layers/attn/wq`` for every layer's)."""
    if isinstance(tree, dict):
        return {k: _stacked_map(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_stacked_map(fn, v, *(r[i] for r in rest), path=path)
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def _quantize_int8(g: torch.Tensor, err: torch.Tensor, amax: torch.Tensor | None = None):
    """Error-feedback int8 quantization of one gradient tensor:
    ``(dequantized, new error)``. The per-tensor scale is ``max|g + err| /
    127``, or ``amax / 127`` where the caller gives the largest ``|g +
    err|`` of the stacked tensor ``g`` belongs to."""
    g = g + err
    scale = torch.clamp(g.abs().max() if amax is None else amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, g - deq


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares (fp32)."""
    total = None
    for leaf in tree_leaves(tree):
        sq = torch.sum(torch.square(leaf.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


class PartialUpdateError(RuntimeError):
    """An in-place update that failed after writing some leaves: the state
    holds new values for those and old ones for the rest, so the step must
    not run again on it (``retryable`` False: ``runtime/fault.py:run_loop``
    raises it at once)."""

    retryable = False


def apply_updates(params: Params, grads: Params, state: dict, cfg: AdamWConfig,
                  in_place: bool = False):
    """One AdamW step: ``(new_params, new_state, {'grad_norm', 'lr'})``.
    ``grad_norm`` is the norm before clipping (after compression). Under
    ``compress`` the int8 scale is per stacked tensor, as the reference's:
    the reference stacks each layer leaf over the layers, so one scale
    serves e.g. every layer's ``attn/wq`` (``_stacked_map``). ``in_place``
    (fp32 params, no ``compress``): each leaf's new param and moments are
    copied over ``params`` and ``state``'s moments (see the module's note),
    which the caller gives up; a failure after the first copy raises
    ``PartialUpdateError``."""
    if in_place and (cfg.compress or any(p.dtype != torch.float32
                                         for p in tree_leaves(params))):
        raise ValueError("apply_updates in place takes float32 params and no compress")
    grads = tree_map(lambda g: g.float(), grads)
    new_err = None
    if cfg.compress:
        amax: dict = {}

        def track(path, g, e):
            m = (g + e).abs().max()
            amax[path] = m if path not in amax else torch.maximum(amax[path], m)

        _stacked_map(track, grads, state["err"])
        pairs = _stacked_map(lambda path, g, e: _quantize_int8(g, e, amax[path]),
                             grads, state["err"])
        grads = tree_map(lambda g, p: p[0], grads, pairs)
        new_err = tree_map(lambda g, p: p[1], grads, pairs)

    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)

    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.float()
    bc1 = 1 - torch.pow(_f32(b1, step.device), stepf)
    bc2 = 1 - torch.pow(_f32(b2, step.device), stepf)

    def upd(p, g, mu, nu):
        g = g * scale
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        mhat = mu / bc1
        nhat = nu / bc2
        p32 = p.float()
        p32 = p32 - lr * (mhat / (torch.sqrt(nhat) + cfg.eps) + cfg.weight_decay * p32)
        return p32.to(p.dtype), mu, nu

    written = []

    def write(p, g, mu, nu):  # upd's results copied over its inputs
        new = upd(p, g, mu, nu)
        written.append(p)
        for old, t in zip((p, mu, nu), new):
            old.copy_(t)
        return p, mu, nu

    try:
        out = tree_map(write if in_place else upd, params, grads, state["mu"], state["nu"])
    except Exception as e:
        if written:
            raise PartialUpdateError(f"AdamW failed after writing {len(written)} leaves in "
                                     "place; resume from a checkpoint") from e
        raise
    pick = lambda i: tree_map(lambda p, t: t[i], params, out)  # noqa: E731
    new_state = {"mu": pick(1), "nu": pick(2), "step": step}
    if cfg.compress:
        new_state["err"] = new_err
    return pick(0), new_state, {"grad_norm": gnorm, "lr": lr}
