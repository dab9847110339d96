"""GQA attention: full, chunked (K4), banded (K4) and decode, with the KV
cache, and MLA (the port's copy of the GQA and MLA parts of
``models/attention.py``).

Prefill implementations, chosen per call by ``Model._impl``:

  full     masked S x S softmax (prompts of up to 1,024 tokens): plain
           PyTorch, as the reference computes it outside any kernel;
  chunked  flash-style online softmax over kv blocks: K4
           (``kernels/flash_attention.py``) — the kernel on a CUDA
           tensor, its plain version on a CPU tensor;
  banded   causal flash over the lower-triangular block pairs: K4 too
           (the kernel skips the kv tiles above the diagonal).

The reference's chunked and banded scans take the q.k^T product in bf16
and round each block's p.v to bf16; K4 keeps both in fp32, so the two
differ by that rounding. Decode (one query against the cache) is plain.
GQA never materialises expanded KV.

The KV cache is updated in place: ``cache_insert`` writes into the cache
tensor and returns it, where the reference returns a new array (a donated
functional update under ``jit``); the values are the same.

MLA (DeepSeek-V2's multi-head latent attention) caches the compressed KV
``{'ckv': (B, S_max, r), 'kpe': (B, 1, S_max, dr)}``. Its prefill
reconstructs K and V from the latent and takes the same three impls, so a
long prompt's attention is K4 at q and k ``dn + dr`` wide and v ``dv``
wide (192 and 128 in DeepSeek-V2-Lite; v is a view into the reconstructed
``kv``, which K4 reads in place). Its decode is the absorbed form, scores
against the latent cache, in plain PyTorch as the reference's.

Cross attention (Whisper's decoder, ``gqa_attention(cross_kv=...)``)
projects q only, with no RoPE, and attends without a mask to the given
encoder k and v: ``full`` for a decoder prompt of up to 1,024 tokens and
at decode, else ``chunked`` (K4, non-causal, each length's block picked
apart). Still to port: the sequence-sharded attention (the mesh layer,
A17).
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..kernels.flash_attention import flash_attention
from .layers import Params, apply_rope, dense, he_init, rms_norm

__all__ = ["NEG_INF", "cache_insert", "pick_block", "init_attention",
           "qkv_project", "full_attention", "chunked_attention",
           "banded_attention", "decode_attention", "attention_fn",
           "gqa_attention", "init_mla", "mla_attention"]

NEG_INF = -1e30


def cache_insert(cache_arr: torch.Tensor, new: torch.Tensor, index,
                 axis: int) -> torch.Tensor:
    """Write ``new`` (a length-L slice) into ``cache_arr`` at ``index``
    along ``axis``, in place, and return ``cache_arr``.

    A full-length ``new`` overwrites the cache; L = 1 writes position
    ``index``; a longer slice (prefill) writes the cache's head, which
    needs ``index`` 0 or None. Entries past the slice keep their values.
    """
    length = new.shape[axis]
    if length == cache_arr.shape[axis]:
        return cache_arr.copy_(new)
    if length == 1:
        cache_arr.narrow(axis, int(index), 1).copy_(new)
        return cache_arr
    if index not in (0, None):
        raise ValueError(f"slice cache_insert writes at index 0, not {index}")
    cache_arr.narrow(axis, 0, length).copy_(new)
    return cache_arr


def pick_block(s: int, target: int) -> int:
    """Largest divisor of s that is <= target."""
    b = min(target, s)
    while s % b:
        b -= 1
    return b


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_attention(generator: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, d_head: int, bias: bool = False, device=None,
                   dtype=torch.float32) -> Params:
    """``wq``, ``wk``, ``wv``, ``wo`` (He-scaled) and zero QKV biases."""
    p = {
        "wq": he_init(generator, (d_model, n_heads * d_head), d_model, device, dtype),
        "wk": he_init(generator, (d_model, n_kv * d_head), d_model, device, dtype),
        "wv": he_init(generator, (d_model, n_kv * d_head), d_model, device, dtype),
        "wo": he_init(generator, (n_heads * d_head, d_model), n_heads * d_head,
                      device, dtype),
    }
    if bias:
        dev = p["wq"].device
        p["bq"] = torch.zeros((n_heads * d_head,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((n_kv * d_head,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((n_kv * d_head,), dtype=dtype, device=dev)
    return p


def _split_heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """(B, S, n*d) -> (B, n, S, d), a transposed view."""
    b, s, _ = x.shape
    return x.reshape(b, s, n, d).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, n, S, d) -> (B, S, n*d)."""
    b, n, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, n * d)


def qkv_project(params: Params, x: torch.Tensor, n_heads: int, n_kv: int,
                d_head: int, positions: torch.Tensor | None, rope_theta: float):
    """q ``(B, H, S, dh)``, k and v ``(B, KV, S, dh)``, RoPE on q and k."""
    q = _split_heads(dense(x, params["wq"], params.get("bq")), n_heads, d_head)
    k = _split_heads(dense(x, params["wk"], params.get("bk")), n_kv, d_head)
    v = _split_heads(dense(x, params["wv"], params.get("bv")), n_kv, d_head)
    if positions is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# core attention variants (q: (B,H,Sq,dh); k: (B,KV,Skv,dh); v: (B,KV,Skv,dv))
# ---------------------------------------------------------------------------

def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, KV, G, Sq, Skv) scores in q's type, without expanding KV."""
    b, h, sq, dh = q.shape
    kv = k.shape[1]
    qg = q.reshape(b, kv, h // kv, sq, dh)
    return torch.einsum("bkgqd,bkvd->bkgqv", qg, k) / math.sqrt(dh)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, kv_offset: int = 0) -> torch.Tensor:
    """The masked softmax over all keys (scores in q's type, then fp32)."""
    b, h, sq, _ = q.shape
    skv, dv = k.shape[2], v.shape[-1]
    s = _gqa_scores(q, k).float()
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + kv_offset
        kj = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(qi >= kj, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgqv,bkvd->bkgqd", w, v).reshape(b, h, sq, dv)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, q_block: int = 512,
                      kv_block: int = 1024, kv_offset: int = 0) -> torch.Tensor:
    """Flash-style attention over kv blocks of ``kv_block``: K4.

    The blocks must tile both lengths, as the reference requires; each
    query row's recurrence does not depend on ``q_block``. A nonzero
    ``kv_offset`` (the reference's sequence-sharded attention) waits for
    the mesh layer.
    """
    if kv_offset:
        raise NotImplementedError(
            f"chunked_attention with kv_offset={kv_offset} is the sequence-"
            "sharded attention, which waits for the mesh layer (ROADMAP A17)")
    sq, skv = q.shape[2], k.shape[2]
    q_block, kv_block = min(q_block, sq), min(kv_block, skv)
    if sq % q_block or skv % kv_block:
        raise ValueError(f"blocks ({q_block}, {kv_block}) must tile the lengths "
                         f"({sq}, {skv})")
    return flash_attention(q, k, v, causal=causal, tile_k=kv_block)


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_block: int = 512) -> torch.Tensor:
    """Causal self-attention over the lower-triangular block pairs: K4,
    with ``q_block``-long kv blocks (the kv tiles past the diagonal add
    nothing and are skipped)."""
    sq, skv = q.shape[2], k.shape[2]
    blk = min(q_block, sq)
    if sq != skv or sq % blk:
        raise ValueError(f"banded attention is for self-attention prefill with "
                         f"a block tiling the length: Sq={sq}, Skv={skv}, "
                         f"block {blk}")
    return flash_attention(q, k, v, causal=True, tile_k=blk)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len) -> torch.Tensor:
    """q ``(B, H, 1, dh)`` against caches ``(B, KV, S_max, dh)``;
    ``cache_len`` counts the valid entries, the current token included.
    Each product runs in its operands' promoted type, as ``jnp.einsum``
    promotes a bf16 q against a float32 cache."""
    b, h, _, dh = q.shape
    kvh, smax = k_cache.shape[1], k_cache.shape[2]
    dv = v_cache.shape[-1]
    qg = q.reshape(b, kvh, h // kvh, dh)
    dt = torch.promote_types(q.dtype, k_cache.dtype)
    s = torch.einsum("bkgd,bkvd->bkgv", qg.to(dt), k_cache.to(dt)).float() / math.sqrt(dh)
    mask = torch.arange(smax, device=q.device)[None, None, None, :] < cache_len
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1).to(q.dtype)
    dt = torch.promote_types(q.dtype, v_cache.dtype)
    o = torch.einsum("bkgv,bkvd->bkgd", w.to(dt), v_cache.to(dt))
    return o.reshape(b, h, 1, dv)


def attention_fn(impl: str):
    """The prefill attention of ``impl``: full, chunked or banded."""
    return {"full": full_attention, "chunked": chunked_attention,
            "banded": banded_attention}[impl]


def _seq_sharded_attention(*_args, **_kwargs):
    """Causal attention with q's sequence dim sharded over a mesh axis."""
    raise NotImplementedError("sequence-sharded attention needs the mesh layer, "
                              "which is not ported")


# ---------------------------------------------------------------------------
# GQA block-level API (with KV cache plumbing)
# ---------------------------------------------------------------------------

def gqa_attention(params: Params, x: torch.Tensor, cfg: Any, *,
                  positions: torch.Tensor, impl: str = "chunked",
                  cache: Params | None = None, cache_index=None,
                  cross_kv: tuple | None = None, causal: bool = True):
    """Returns ``(y, cache)``. ``cache`` is ``{'k', 'v'}`` of ``(B, KV,
    S_max, dh)``, updated in place: at decode (one token and a
    ``cache_index``) the token's k and v go to position ``cache_index``;
    at prefill the prompt's go to the cache's head. ``cross_kv``, a pair
    ``(k, v)`` of ``(B, KV, S_enc, dh)``, makes it a cross-attention call:
    q alone is projected, without RoPE, k and v are cast to x's type, no
    mask, and the cache is returned untouched."""
    if cross_kv is not None:
        q = _split_heads(dense(x, params["wq"], params.get("bq")), cfg.n_heads,
                         cfg.head_dim)
        k, v = (t.to(x.dtype) for t in cross_kv)
        if impl == "full":
            o = full_attention(q, k, v, causal=False)
        else:
            o = chunked_attention(q, k, v, causal=False,
                                  q_block=pick_block(q.shape[2], cfg.attn_chunk_q),
                                  kv_block=pick_block(k.shape[2], cfg.attn_chunk_kv))
        return dense(_merge_heads(o), params["wo"]), cache
    rope_theta = getattr(cfg, "rope_theta", None)
    q, k, v = qkv_project(params, x, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                          positions if rope_theta is not None else None,
                          rope_theta or 1e4)
    if cache is not None and cache_index is not None and q.shape[2] == 1:
        k_cache = cache_insert(cache["k"], k, cache_index, axis=2)
        v_cache = cache_insert(cache["v"], v, cache_index, axis=2)
        o = decode_attention(q, k_cache, v_cache, cache_index + 1).to(x.dtype)
    else:
        if impl == "chunked":
            o = chunked_attention(q, k, v, causal=causal,
                                  q_block=pick_block(q.shape[2], cfg.attn_chunk_q),
                                  kv_block=pick_block(k.shape[2], cfg.attn_chunk_kv))
        elif impl == "banded":
            o = banded_attention(q, k, v,
                                 q_block=pick_block(q.shape[2], cfg.attn_chunk_q))
        else:
            o = full_attention(q, k, v, causal=causal)
        if cache is not None:
            cache_insert(cache["k"], k, 0, axis=2)
            cache_insert(cache["v"], v, 0, axis=2)
    return dense(_merge_heads(o), params["wo"]), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

def init_mla(generator: torch.Generator, d_model: int, n_heads: int, mla,
             device=None, dtype=torch.float32) -> Params:
    """``wq (d, H*(dn+dr))``, ``wkv_a (d, r+dr)``, ``kv_norm (r)``,
    ``wkv_b (r, H*(dn+dv))`` and ``wo (H*dv, d)``, He-scaled (V2-Lite has
    no Q LoRA)."""
    dn, dr, dv, r = (mla.nope_head_dim, mla.rope_head_dim, mla.v_head_dim,
                     mla.kv_lora_rank)
    wq = he_init(generator, (d_model, n_heads * (dn + dr)), d_model, device, dtype)
    return {
        "wq": wq,
        "wkv_a": he_init(generator, (d_model, r + dr), d_model, device, dtype),
        "kv_norm": torch.ones((r,), dtype=dtype, device=wq.device),
        "wkv_b": he_init(generator, (r, n_heads * (dn + dv)), r, device, dtype),
        "wo": he_init(generator, (n_heads * dv, d_model), n_heads * dv, device, dtype),
    }


def mla_attention(params: Params, x: torch.Tensor, cfg: Any, *, positions,
                  impl: str = "chunked", cache: Params | None = None,
                  cache_index=None):
    """Returns ``(y, cache)``; ``cache`` is ``{'ckv': (B, S_max, r), 'kpe':
    (B, 1, S_max, dr)}``, updated in place as the GQA cache is.

    Prefill reconstructs K and V from the latent (k's rope part broadcast
    over the heads) and attends with ``impl``; chunked and banded take the
    config's blocks as given, as the reference does. Decode (one token and
    a ``cache_index``) uses the absorbed form: ``q_nope W_uk`` against the
    latent cache plus the rope part, masked past ``cache_index + 1``, then
    the context times ``W_uv``.
    """
    mla, h = cfg.mla, cfg.n_heads
    dn, dr, dv, r = (mla.nope_head_dim, mla.rope_head_dim, mla.v_head_dim,
                     mla.kv_lora_rank)
    b, sq, _ = x.shape

    q = dense(x, params["wq"]).reshape(b, sq, h, dn + dr).transpose(1, 2)
    q_nope, q_pe = q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)

    kv_a = dense(x, params["wkv_a"])                                  # (B,S,r+dr)
    ckv = rms_norm(kv_a[..., :r], params["kv_norm"], cfg.norm_eps)
    k_pe = apply_rope(kv_a[..., None, :, r:], positions, cfg.rope_theta)  # (B,1,S,dr)
    wkv_b = params["wkv_b"].reshape(r, h, dn + dv).to(x.dtype)

    if cache is not None and cache_index is not None and sq == 1:
        ckv_c = cache_insert(cache["ckv"], ckv, cache_index, axis=1)
        kpe_c = cache_insert(cache["kpe"], k_pe, cache_index, axis=2)
        q_lat = torch.einsum("bhqd,rhd->bhqr", q_nope, wkv_b[..., :dn])
        s_lat = torch.einsum("bhqr,bsr->bhqs", q_lat, ckv_c)
        s_pe = torch.einsum("bhqd,bzsd->bhqs", q_pe, kpe_c)
        s = (s_lat + s_pe).float() / math.sqrt(dn + dr)
        mask = torch.arange(ckv_c.shape[1], device=x.device)[None, None, None, :] \
            < cache_index + 1
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        w = torch.softmax(s, dim=-1).to(x.dtype)
        ctx_lat = torch.einsum("bhqs,bsr->bhqr", w, ckv_c)             # (B,H,1,r)
        o = torch.einsum("bhqr,rhd->bhqd", ctx_lat, wkv_b[..., dn:]).to(x.dtype)
    else:
        kv = torch.einsum("bsr,rhd->bhsd", ckv, wkv_b)                 # (B,H,S,dn+dv)
        v = kv[..., dn:]
        k = torch.cat([kv[..., :dn], k_pe.expand(b, h, sq, dr)], dim=-1)
        qf = torch.cat([q_nope, q_pe], dim=-1)
        if impl == "full":
            o = full_attention(qf, k, v, causal=True)
        elif impl == "banded":
            o = banded_attention(qf, k, v, q_block=cfg.attn_chunk_q)
        else:
            o = chunked_attention(qf, k, v, causal=True, q_block=cfg.attn_chunk_q,
                                  kv_block=cfg.attn_chunk_kv)
        if cache is not None:
            cache_insert(cache["ckv"], ckv, 0, axis=1)
            cache_insert(cache["kpe"], k_pe, 0, axis=2)
    return dense(_merge_heads(o), params["wo"]), cache
