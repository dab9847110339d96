"""Model assembly for the dense decoder family (the port's copy of the dense
path of ``models/model.py``): init, caches, prefill and decode.

The reference stacks the layers on a leading axis and runs them with
``lax.scan``; the port keeps one params dict per layer and runs them in a
Python loop. The KV cache keeps the reference's stacked layout, ``{'k',
'v'}`` of ``(L, B, KV, S_max, dh)``, and each layer writes its slice in
place. ``model_params_from_reference`` turns the reference's params (numpy
arrays, layers stacked) into the port's.

Other families raise ``NotImplementedError`` naming their ROADMAP item:
MoE layers (A11.1), MLA (A11.2), Zamba2's Mamba2 layers with K5 (A11.3),
RWKV6 with K6 (A11.4), Whisper's encoder-decoder (A11.5) and the InternVL2
vision frontend (A11.6). Training (``train_loss``, ``cross_entropy``) waits
for A12.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from . import blocks
from .blocks import ZERO
from .layers import Params, embed, he_init, init_embedding, rms_norm, unembed

__all__ = ["NEG_INF", "Model", "unported_part", "mask_vocab_padding",
           "param_shapes", "count_params", "count_active_params",
           "model_params_from_reference"]

NEG_INF = -1e30


def unported_part(cfg) -> str | None:
    """What of ``cfg``'s architecture the port lacks (with its ROADMAP
    item), or None for the dense family."""
    if cfg.rwkv is not None:
        return "RWKV6 layers and their scan K6 (ROADMAP A11.4)"
    if cfg.ssm is not None:
        return "Zamba2's Mamba2 layers and their scan K5 (ROADMAP A11.3)"
    if cfg.encdec is not None:
        return "Whisper's encoder-decoder (ROADMAP A11.5)"
    if cfg.mla is not None:
        return "MLA attention (ROADMAP A11.2)"
    if cfg.moe is not None:
        return "the MoE layer, moe_block (ROADMAP A11.1)"
    if cfg.frontend:
        return f"the {cfg.frontend} frontend (ROADMAP A11.6)"
    return None


def mask_vocab_padding(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Logits with the padded vocab entries set to ``NEG_INF``."""
    v_pad = logits.shape[-1]
    if v_pad == vocab_size:
        return logits
    mask = torch.arange(v_pad, device=logits.device) < vocab_size
    return torch.where(mask, logits, torch.full_like(logits, NEG_INF))


@dataclass
class Model:
    """Config-driven dense GQA decoder: init / prefill / decode_step."""

    cfg: Any

    def __post_init__(self):
        missing = unported_part(self.cfg)
        if missing is not None:
            raise NotImplementedError(
                f"{self.cfg.name}: the port has only the dense decoder family; "
                f"{missing} is not ported")

    # ---- init ------------------------------------------------------------------
    def init_params(self, generator: torch.Generator | None,
                    device=None) -> Params:
        """fp32 params drawn from ``generator`` on ``device`` (the
        generator's by default; ``"meta"`` gives shapes only)."""
        cfg = self.cfg
        device = generator.device if device is None else torch.device(device)
        params: Params = {
            "embed": init_embedding(generator, cfg.padded_vocab, cfg.d_model, device),
            "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                     device=device),
        }
        if not cfg.tie_embeddings:
            params["head"] = {"w": he_init(generator, (cfg.d_model, cfg.padded_vocab),
                                           cfg.d_model, device)}
        params["layers"] = [blocks.init_dense_layer(generator, cfg, device)
                            for _ in range(cfg.n_layers)]
        return params

    # ---- caches ----------------------------------------------------------------
    def init_cache(self, batch: int, s_max: int, dtype=torch.bfloat16,
                   device=None) -> Params:
        """Zeroed ``{'k', 'v'}`` of ``(L, B, KV, S_max, dh)``."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, s_max, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    # ---- trunk -----------------------------------------------------------------
    def _embed_inputs(self, params: Params, batch_inputs: dict) -> torch.Tensor:
        """Token embeddings, bf16 from here on."""
        return embed(params["embed"], batch_inputs["tokens"]).to(torch.bfloat16)

    def _impl(self, s: int) -> str:
        """Prefill attention for an ``s``-token prompt."""
        if s <= 1024:
            return "full"
        return getattr(self.cfg, "attn_impl", "chunked")

    def _trunk(self, params: Params, x: torch.Tensor, positions: torch.Tensor,
               cache: Params | None = None, cache_index=None, impl: str | None = None):
        """Run the layer stack. Returns ``(x, cache, aux_sum)``."""
        cfg = self.cfg
        impl = impl or self._impl(x.shape[1])
        aux = ZERO
        for i, lp in enumerate(params["layers"]):
            c = None if cache is None else {"k": cache["k"][i], "v": cache["v"][i]}
            x, _, a = blocks.apply_dense_layer(lp, x, cfg, positions=positions,
                                               impl=impl, cache=c,
                                               cache_index=cache_index)
            aux = aux + a
        return x, cache, aux

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """bf16 logits over the padded vocab."""
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        if cfg.tie_embeddings:
            return unembed({}, x, table=params["embed"]["table"])
        return unembed(params["head"], x)

    # ---- public API ----------------------------------------------------------
    def prefill(self, params: Params, batch: dict, cache: Params):
        """Run a prompt, fill the cache's head, return last-position logits."""
        tokens = batch["tokens"]
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = self._embed_inputs(params, batch)
        x, cache, _ = self._trunk(params, x, positions, cache=cache, cache_index=None)
        return self._logits(params, x[:, -1:]), cache

    def decode_step(self, params: Params, tokens: torch.Tensor, cache: Params,
                    cache_index: int):
        """tokens ``(B, 1)`` at position ``cache_index``; the cache is
        updated in place and returned."""
        positions = torch.full((1,), int(cache_index), dtype=torch.int32,
                               device=tokens.device)
        x = self._embed_inputs(params, {"tokens": tokens})
        x, cache, _ = self._trunk(params, x, positions, cache=cache,
                                  cache_index=cache_index)
        return self._logits(params, x), cache


# ---------------------------------------------------------------------------
# parameter accounting (for MODEL_FLOPS = 6 N D)
# ---------------------------------------------------------------------------

def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def param_shapes(cfg) -> Params:
    """The params tree on the ``meta`` device: shapes, no storage."""
    return Model(cfg).init_params(None, device="meta")


def count_params(cfg) -> int:
    """Total parameters, embeddings included."""
    return sum(int(math.prod(t.shape)) for t in _leaves(param_shapes(cfg)))


def count_active_params(cfg) -> int:
    """Active params per token: all of them in the dense family (the MoE
    scaling of routed experts comes with ROADMAP A11.1)."""
    return count_params(cfg)


def model_params_from_reference(tree, device: str | torch.device = "cuda") -> Params:
    """The reference's ``Model.init_params`` tree (arrays as numpy) as the
    port's params on ``device``: the same names and layouts, with the
    stacked ``layers`` split into one dict per layer. Arrays are copied
    (JAX hands out read-only buffers)."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return torch.from_numpy(np.array(t)).to(device)

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    stacked = conv(tree["layers"])
    n_layers = next(_leaves(stacked)).shape[0]

    def pick(t, i):
        if isinstance(t, dict):
            return {k: pick(v, i) for k, v in t.items()}
        return t[i].clone()

    out["layers"] = [pick(stacked, i) for i in range(n_layers)]
    return out
