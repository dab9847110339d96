"""Model assembly for every family of ``configs`` (the port's copy of
``models/model.py``): the dense decoder, MoE (Qwen1.5-MoE), MLA
(DeepSeek-V2-Lite), RWKV6, Zamba2, Whisper's encoder-decoder and the
InternVL2 vision frontend: init, caches, prefill, decode and the loss.

The reference stacks the layers on a leading axis and runs them with
``lax.scan``; the port keeps one params dict per layer and runs them in a
Python loop (Zamba2's ``mamba_main`` is a list of super-blocks, each a list
of ``attn_every`` Mamba2 layers, then ``mamba_tail``; the shared attention
block is one dense layer; DeepSeek's dense first layer is ``layer0``, one
dict beside the list of its MoE ``layers``; Whisper's ``enc_layers`` and
``dec_layers`` are lists of layer dicts). The caches keep the
reference's stacked layouts — dense and MoE ``{'k', 'v'}`` of ``(L, B, KV,
S_max, dh)``; MLA ``{'ckv': (L, B, S_max, r), 'kpe': (L, B, 1, S_max,
dr)}`` (``layer0`` on slice 0); RWKV6 ``{'shift_tm', 'shift_cm',
'state'}`` with a leading L; Zamba2 ``{'mamba_main': {'conv', 'state'}}``
with leading ``(n_sb, attn_every)``, ``'attn'`` (one KV cache per
super-block) and ``'mamba_tail'``; Whisper ``{'self', 'cross'}``, two KV
caches, the cross one at the encoder's length, and ``'has_cross'`` — and
each layer writes its slice in place. ``model_params_from_reference``
turns the reference's params (numpy arrays, layers stacked) into the
port's.

Training (ROADMAP A12.1): ``Model.train_loss`` (next-token cross entropy
plus the MoE aux loss) runs the same trunk with each layer wrapped by
``_remat`` in ``torch.utils.checkpoint`` (``cfg.remat_policy`` "full"
recomputes the layer, "dots" keeps its unbatched matrix products), as the
reference wraps its scan bodies in ``jax.checkpoint``. On the card the
attention's gradient is K4's backward kernel and the scans' are K5' and
K6' (``kernels/ssm_scan.py:_SsmScan``, ``kernels/rwkv6_scan.py:
_Rwkv6Scan``), so every served family trains there too.

The frontends are stubs, as in the reference: Whisper's encoder takes
``frames`` ``(B, S_enc, 128)``, projected by ``params['frontend']`` and
given sinusoidal positions, and its decoder tokens get sinusoidal
positions too; InternVL2 projects ``patch_embeds`` ``(B, n, 1024)`` in
bf16 and puts them in place of the first n token embeddings (a prefill or
loss without them runs text only). At prefill the encoder runs once and
each decoder layer's cross k and v go to the cache; ``train_loss`` takes
them from the encoder's output directly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import blocks
from .blocks import ZERO
from .attention import _split_heads
from .layers import (Params, dense, embed, he_init, init_embedding, layer_norm,
                     rms_norm, unembed)
from .rwkv import init_rwkv6_cache
from .ssm import init_mamba2_cache

__all__ = ["NEG_INF", "FRONTEND_DIM", "Model", "sinusoidal_positions",
           "mask_vocab_padding", "cross_entropy", "param_shapes", "count_params",
           "count_active_params", "model_params_from_reference"]

NEG_INF = -1e30

#: the stub frontends' input widths: InternVL2's patch embeddings, Whisper's
#: frame embeddings
FRONTEND_DIM = {"vision": 1024, "audio": 128}


def sinusoidal_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """``(S,)`` positions -> ``(S, d)`` fp32 Whisper-style embedding: the
    sines, then the cosines, of ``positions * 10000^(-i / max(1, d/2 - 1))``."""
    half = d // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=positions.device)
                      * math.log(10000.0) / max(1, half - 1))
    ang = positions[:, None].to(torch.float32) * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def mask_vocab_padding(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Logits with the padded vocab entries set to ``NEG_INF``."""
    v_pad = logits.shape[-1]
    if v_pad == vocab_size:
        return logits
    pad = torch.arange(v_pad, device=logits.device) >= vocab_size
    return logits.masked_fill(pad, NEG_INF)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Mean next-token cross entropy over ``labels >= 0``: logits ``(B, S,
    Vp)`` in fp32 with the vocab padding masked, labels ``(B, S)``, -1
    masked. The reference's ``vp_cross_entropy`` is this on one device;
    its vocab-parallel branch waits for the mesh layer (ROADMAP A17)."""
    logits = mask_vocab_padding(logits.float(), vocab_size)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = labels >= 0
    nll = torch.where(mask, lse - ll, torch.zeros_like(lse))
    return nll.sum() / mask.sum().clamp_min(1)


def _save_dots(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the outputs of unbatched matrix products, recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg, fn):
    """``fn`` (a layer apply) under ``torch.utils.checkpoint`` per
    ``cfg.remat`` / ``cfg.remat_policy``: "full" saves the layer's inputs
    and recomputes the rest in the backward, "dots" also keeps its
    unbatched matrix products."""
    if not cfg.remat:
        return fn
    kw = {}
    if getattr(cfg, "remat_policy", "full") == "dots":
        kw["context_fn"] = partial(create_selective_checkpoint_contexts, _save_dots)

    def wrapped(*args, **kwargs):
        return checkpoint(fn, *args, use_reentrant=False, **kw, **kwargs)

    return wrapped


@dataclass
class Model:
    """Config-driven LM (dense GQA, MoE, MLA, RWKV6, Zamba2, Whisper's
    encoder-decoder, InternVL2's frontend): init / train_loss / prefill /
    decode_step."""

    cfg: Any

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
        if cfg.frontend:
            df = FRONTEND_DIM[cfg.frontend]
            params["frontend"] = {
                "w": he_init(generator, (df, cfg.d_model), df, device),
                "b": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)}
        if cfg.rwkv is not None:
            params["layers"] = [blocks.init_rwkv_layer(generator, cfg, device)
                                for _ in range(cfg.n_layers)]
        elif cfg.ssm is not None:
            n_sb, ae, tail = self._hybrid_dims()
            params["mamba_main"] = [[blocks.init_mamba_layer(generator, cfg, device)
                                     for _ in range(ae)] for _ in range(n_sb)]
            if tail:
                params["mamba_tail"] = [blocks.init_mamba_layer(generator, cfg, device)
                                        for _ in range(tail)]
            params["shared_attn"] = blocks.init_dense_layer(generator, cfg, device)
        elif cfg.encdec is not None:
            params["enc_layers"] = [blocks.init_whisper_layer(generator, cfg, False, device)
                                    for _ in range(cfg.encdec.n_enc_layers)]
            params["dec_layers"] = [blocks.init_whisper_layer(generator, cfg, True, device)
                                    for _ in range(cfg.n_layers)]
            for name, value in (("enc_norm", 1.0), ("enc_norm_b", 0.0),
                                ("final_norm_b", 0.0)):
                params[name] = torch.full((cfg.d_model,), value, dtype=torch.float32,
                                          device=device)
        elif cfg.mla is not None:
            n_moe = cfg.n_layers - 1 if cfg.first_layer_dense else cfg.n_layers
            if cfg.first_layer_dense:
                params["layer0"] = blocks.init_mla_layer(generator, cfg, True, device)
            params["layers"] = [blocks.init_mla_layer(generator, cfg, False, device)
                                for _ in range(n_moe)]
        elif cfg.moe is not None:
            params["layers"] = [blocks.init_moe_layer(generator, cfg, device)
                                for _ in range(cfg.n_layers)]
        else:
            params["layers"] = [blocks.init_dense_layer(generator, cfg, device)
                                for _ in range(cfg.n_layers)]
        return params

    def _hybrid_dims(self) -> tuple[int, int, int]:
        """Zamba2's super-blocks, Mamba2 layers per super-block, tail layers."""
        ae = self.cfg.ssm.attn_every
        n_sb = self.cfg.n_layers // ae
        return n_sb, ae, self.cfg.n_layers - n_sb * ae

    # ---- caches ----------------------------------------------------------------
    def init_cache(self, batch: int, s_max: int, dtype=torch.bfloat16,
                   device=None) -> Params:
        """The zeroed cache of the family, stacked as the reference's."""
        cfg = self.cfg

        def kv_cache(n: int, length: int = s_max):
            shape = (n, batch, cfg.n_kv_heads, length, cfg.head_dim)
            return {"k": torch.zeros(shape, dtype=dtype, device=device),
                    "v": torch.zeros(shape, dtype=dtype, device=device)}

        def stacked(one: Params, *lead: int) -> Params:
            return {k: torch.zeros((*lead, *t.shape), dtype=t.dtype, device=t.device)
                    for k, t in one.items()}

        if cfg.rwkv is not None:
            return stacked(init_rwkv6_cache(cfg, batch, dtype, device), cfg.n_layers)
        if cfg.ssm is not None:
            n_sb, ae, tail = self._hybrid_dims()
            one = init_mamba2_cache(cfg, batch, dtype, device)
            cache = {"mamba_main": stacked(one, n_sb, ae), "attn": kv_cache(n_sb)}
            if tail:
                cache["mamba_tail"] = stacked(one, tail)
            return cache
        if cfg.encdec is not None:
            return {"self": kv_cache(cfg.n_layers),
                    "cross": kv_cache(cfg.n_layers, cfg.encdec.n_enc_positions),
                    "has_cross": torch.zeros((), dtype=torch.int32, device=device)}
        if cfg.mla is not None:
            r, dr = cfg.mla.kv_lora_rank, cfg.mla.rope_head_dim
            shapes = {"ckv": (cfg.n_layers, batch, s_max, r),
                      "kpe": (cfg.n_layers, batch, 1, s_max, dr)}
            return {k: torch.zeros(s, dtype=dtype, device=device)
                    for k, s in shapes.items()}
        return kv_cache(cfg.n_layers)

    # ---- trunk -----------------------------------------------------------------
    def _embed_inputs(self, params: Params, batch_inputs: dict) -> torch.Tensor:
        """Token embeddings, bf16 from here on; InternVL2's projected
        ``patch_embeds`` in place of the first tokens' where given."""
        x = embed(params["embed"], batch_inputs["tokens"]).to(torch.bfloat16)
        if self.cfg.frontend == "vision" and "patch_embeds" in batch_inputs:
            pe = dense(batch_inputs["patch_embeds"].to(x.dtype), params["frontend"]["w"],
                       params["frontend"]["b"])
            n = min(pe.shape[1], x.shape[1])
            x = torch.cat([pe[:, :n], x[:, n:]], dim=1)
        return x

    def _trunk_inputs(self, params: Params, batch_inputs: dict,
                      positions: torch.Tensor) -> torch.Tensor:
        """``_embed_inputs``, with Whisper's sinusoidal ``positions`` added
        (the reference's ``_embed_inputs``)."""
        x = self._embed_inputs(params, batch_inputs)
        if self.cfg.encdec is not None:
            x = x + sinusoidal_positions(positions, self.cfg.d_model).to(x.dtype)[None]
        return x

    def _encoder(self, params: Params, frames: torch.Tensor,
                 remat: bool = False) -> torch.Tensor:
        """Whisper's encoder: frames ``(B, S_enc, 128)`` -> ``(B, S_enc, d)``,
        its layers under ``_remat`` when ``remat`` (training)."""
        cfg = self.cfg
        x = dense(frames.to(torch.bfloat16), params["frontend"]["w"], params["frontend"]["b"])
        pos = torch.arange(x.shape[1], device=x.device)
        x = x + sinusoidal_positions(pos, cfg.d_model).to(x.dtype)[None]
        apply = _remat(cfg, blocks.apply_whisper_enc_layer) if remat \
            else blocks.apply_whisper_enc_layer
        impl = self._impl(x.shape[1])
        for lp in params["enc_layers"]:
            x = apply(lp, x, cfg, impl=impl)
        return layer_norm(x, params["enc_norm"], params["enc_norm_b"], cfg.norm_eps)

    def _cross_kv(self, dec_layers: list, enc_out: torch.Tensor) -> list:
        """Each decoder layer's cross k and v from the encoder's output:
        ``[(k, v)]``, each ``(B, KV, S_enc, dh)`` (``_split_heads``' views)."""
        cfg = self.cfg
        return [tuple(_split_heads(dense(enc_out, lp["cross"][w], lp["cross"].get(b)),
                                   cfg.n_kv_heads, cfg.head_dim)
                      for w, b in (("wk", "bk"), ("wv", "bv")))
                for lp in dec_layers]

    def _impl(self, s: int) -> str:
        """Prefill attention for an ``s``-token prompt."""
        if s <= 1024:
            return "full"
        return getattr(self.cfg, "attn_impl", "chunked")

    def _trunk(self, params: Params, x: torch.Tensor, positions: torch.Tensor,
               cache: Params | None = None, cache_index=None, impl: str | None = None,
               remat: bool = False, enc_out: torch.Tensor | None = None):
        """Run the layer stack. Returns ``(x, cache, aux_sum)``. ``remat``
        (training, no cache) wraps each layer per ``_remat``. Whisper's
        decoder takes its cross k and v from the cache, or without one from
        ``enc_out``."""
        cfg = self.cfg
        impl = impl or self._impl(x.shape[1])
        wrap = partial(_remat, cfg) if remat else (lambda fn: fn)
        aux = ZERO
        if cfg.rwkv is not None:
            rwkv = wrap(blocks.apply_rwkv_layer)
            for i, lp in enumerate(params["layers"]):
                x, _, a = _recurrent(rwkv, lp, x, cfg, cache, (i,), cache_index)
                aux = aux + a
            return x, cache, aux
        if cfg.ssm is not None:
            mamba, shared = wrap(blocks.apply_mamba_layer), wrap(blocks.apply_dense_layer)
            main = None if cache is None else cache["mamba_main"]
            for sb, layers in enumerate(params["mamba_main"]):
                for j, lp in enumerate(layers):
                    x, _, a = _recurrent(mamba, lp, x, cfg, main, (sb, j), cache_index)
                    aux = aux + a
                c = None if cache is None else {"k": cache["attn"]["k"][sb],
                                                "v": cache["attn"]["v"][sb]}
                x, _, a = shared(params["shared_attn"], x, cfg, positions=positions,
                                 impl=impl, cache=c, cache_index=cache_index)
                aux = aux + a
            tail = None if cache is None else cache.get("mamba_tail")
            for i, lp in enumerate(params.get("mamba_tail", [])):
                x, _, a = _recurrent(mamba, lp, x, cfg, tail, (i,), cache_index)
                aux = aux + a
            return x, cache, aux
        if cfg.encdec is not None:
            dec = wrap(blocks.apply_whisper_dec_layer)
            if cache is None:
                cross = self._cross_kv(params["dec_layers"], enc_out)
            else:
                cross = list(zip(cache["cross"]["k"], cache["cross"]["v"]))
            for i, lp in enumerate(params["dec_layers"]):
                c = None if cache is None else {k: t[i] for k, t in cache["self"].items()}
                x, _, a = dec(lp, x, cfg, positions=positions, impl=impl, cache=c,
                              cache_index=cache_index, cross_kv=cross[i])
                aux = aux + a
            return x, cache, aux
        if cfg.mla is not None:
            apply = blocks.apply_mla_layer
        elif cfg.moe is not None:
            apply = blocks.apply_moe_layer
        else:
            apply = blocks.apply_dense_layer
        apply = wrap(apply)
        # DeepSeek's dense layer0 on cache slice 0, the MoE layers on 1:
        stack = ([params["layer0"]] if "layer0" in params else []) + params["layers"]
        for i, lp in enumerate(stack):
            c = None if cache is None else {k: t[i] for k, t in cache.items()}
            x, _, a = apply(lp, x, cfg, positions=positions, impl=impl, cache=c,
                            cache_index=cache_index)
            aux = aux + a
        return x, cache, aux

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """bf16 logits over the padded vocab (Whisper's final norm is a
        layer norm)."""
        cfg = self.cfg
        if cfg.encdec is None:
            x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        else:
            x = layer_norm(x, params["final_norm"], params["final_norm_b"], cfg.norm_eps)
        if cfg.tie_embeddings:
            return unembed({}, x, table=params["embed"]["table"])
        return unembed(params["head"], x)

    # ---- public API ----------------------------------------------------------
    def train_loss(self, params: Params, batch: dict):
        """batch: tokens ``(B, S + 1)`` (and Whisper's ``frames`` or
        InternVL2's ``patch_embeds``). Next-token cross entropy over the
        first S positions plus the layers' MoE aux loss: ``(loss, {'ce',
        'aux'})``. The layers run under ``_remat``; the reference's
        ``vp_cross_entropy`` is ``cross_entropy`` on one device (its mesh
        branch waits for ROADMAP A17)."""
        cfg = self.cfg
        tokens, labels = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = self._trunk_inputs(params, {**batch, "tokens": tokens}, positions)
        enc_out = None
        if cfg.encdec is not None:
            enc_out = self._encoder(params, batch["frames"], remat=True)
        x, _, aux = self._trunk(params, x, positions, remat=True, enc_out=enc_out)
        ce = cross_entropy(self._logits(params, x), labels, cfg.vocab_size)
        loss = ce + aux
        return loss, {"ce": ce, "aux": aux}

    def prefill(self, params: Params, batch: dict, cache: Params):
        """Run a prompt (``batch``: tokens, and Whisper's ``frames`` or
        InternVL2's ``patch_embeds``), fill the cache's head, return
        last-position logits. Whisper's encoder runs here, once, and its
        cross k and v fill the cache's ``cross``."""
        tokens = batch["tokens"]
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = self._trunk_inputs(params, batch, positions)
        if self.cfg.encdec is not None:
            enc_out = self._encoder(params, batch["frames"])
            for i, (k, v) in enumerate(self._cross_kv(params["dec_layers"], enc_out)):
                cache["cross"]["k"][i].copy_(k)
                cache["cross"]["v"][i].copy_(v)
            cache["has_cross"].fill_(1)
        x, cache, _ = self._trunk(params, x, positions, cache=cache, cache_index=None)
        return self._logits(params, x[:, -1:]), cache

    def decode_step(self, params: Params, tokens: torch.Tensor, cache: Params,
                    cache_index: int):
        """tokens ``(B, 1)`` at position ``cache_index``; the cache is
        updated in place and returned."""
        positions = torch.full((1,), int(cache_index), dtype=torch.int32,
                               device=tokens.device)
        x = self._trunk_inputs(params, {"tokens": tokens}, positions)
        x, cache, _ = self._trunk(params, x, positions, cache=cache,
                                  cache_index=cache_index)
        return self._logits(params, x), cache


def _recurrent(apply, lp: Params, x: torch.Tensor, cfg, cache: Params | None,
               index: tuple, cache_index):
    """Apply a Mamba2 or RWKV6 layer on its slice ``index`` of a stacked
    cache and write the entries it returns into that slice, in place."""
    c = None if cache is None else {k: t[index] for k, t in cache.items()}
    x, new, a = apply(lp, x, cfg, cache=c, cache_index=cache_index)
    for k, t in (new or {}).items():
        c[k].copy_(t)
    return x, c, a


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
    """Active params per token: routed experts scaled by ``top_k / E``.

    The reference scales each leaf of its stacked tree and truncates it to
    an int; a port leaf path over the per-layer list (``layers`` and the
    like) is that stacked leaf, so each path's total is scaled and
    truncated once, as the reference does.
    """
    totals: dict[tuple, int] = {}

    def walk(tree, path: tuple) -> None:
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        elif isinstance(tree, list):
            for v in tree:
                walk(v, path)
        else:
            totals[path] = totals.get(path, 0) + int(math.prod(tree.shape))

    walk(param_shapes(cfg), ())
    total = 0
    for path, n in totals.items():
        if "experts" in path and cfg.moe is not None:
            e = cfg.moe.n_routed_padded or cfg.moe.n_routed
            n = int(n * cfg.moe.top_k / e)
        total += n
    return total


def model_params_from_reference(tree, device: str | torch.device = "cuda") -> Params:
    """The reference's ``Model.init_params`` tree (arrays as numpy) as the
    port's params on ``device``: the same names and layouts, with the
    stacked ``layers``, ``mamba_tail``, ``enc_layers`` and ``dec_layers``
    split into one dict per layer and
    ``mamba_main`` (stacked ``(n_sb, attn_every, ...)``) into a list of
    super-blocks of such lists; DeepSeek's ``layer0`` stays one dict.
    Arrays are copied (JAX hands out read-only buffers)."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return torch.from_numpy(np.array(t)).to(device)

    def pick(t, i):
        if isinstance(t, dict):
            return {k: pick(v, i) for k, v in t.items()}
        return t[i].clone()

    def split(t, depth: int):
        if depth == 0:
            return t
        n = next(_leaves(t)).shape[0]
        return [split(pick(t, i), depth - 1) for i in range(n)]

    depths = {"layers": 1, "mamba_tail": 1, "enc_layers": 1, "dec_layers": 1,
              "mamba_main": 2}
    return {k: split(conv(v), depths.get(k, 0)) for k, v in tree.items()}
