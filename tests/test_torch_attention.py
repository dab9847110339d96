"""The port's attention and layer functions against the JAX package's.

Inputs are drawn with numpy from a seed and fed to both packages.

Tolerances, with their reasons:

* K4's plain version against the Pallas K4 (``ops.attention``,
  ``interpret=True``): the shapes and tolerances of the reference's own
  kernel tests (``tests/test_kernels.py``), 2e-5 in float32 (the two sum
  in other orders) and 2e-2 in bfloat16 (outputs round to 8 bits);
* float32 layer functions: 1e-5 relative to the largest magnitude (matmul
  and reduction order; no rounding policy is involved);
* bfloat16 layer functions: ``BF16_TOL`` of the largest magnitude. A
  bfloat16 value carries 8 bits, so one step is 2^-7 of the largest
  magnitude at most; XLA and PyTorch round the same operations, but sum
  products in another order and may keep an intermediate in float32 where
  the other rounds, so results may differ by a step or two.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jatt
from repro.models import layers as jlay
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.models import attention as tatt
from repro_torch.models import layers as tlay

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -6

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.ascontiguousarray(a)).to(td)


def _assert_close(got: torch.Tensor, want, rel: float) -> None:
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, rel * scale)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) K4's plain version against the Pallas K4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,s,dh,causal", [
    (1, 2, 256, 64, True), (2, 4, 512, 64, True), (1, 2, 256, 128, False),
    (1, 1, 1024, 64, True),
])
def test_flash_plain_matches_pallas(b, h, s, dh, causal, dtype):
    rng = np.random.default_rng(0)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(_normal(rng, b, h, s, dh), dtype)
                                    for _ in range(3))
    want = jops.attention(jq, jk, jv, causal=causal, tile_q=128, tile_k=128)
    got = tops.attention(tq, tk, tv, causal=causal, tile_k=128)
    assert got.dtype == tq.dtype
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("group", [4, 7])
def test_flash_plain_gqa_matches_pallas_expansion(group):
    """Query head h reads kv head h // group, as the reference's repeat."""
    rng = np.random.default_rng(1)
    q = _normal(rng, 2, 2 * group, 256, 64)
    k, v = _normal(rng, 2, 2, 256, 64), _normal(rng, 2, 2, 256, 64)
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, tile_q=128, tile_k=128)
    got = tops.attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal=True, tile_k=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_flash_ref_matches_reference_oracle():
    rng = np.random.default_rng(2)
    q, k, v = (_normal(rng, 1, 2, 64, 16) for _ in range(3))
    for causal in (True, False):
        want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal)
        got = tref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_flash_plain_kv_offset_and_tile_skipping():
    """Skipping the kv tiles past the last query is exact: the plain version
    equals the masked-softmax oracle, over more keys than queries. A kv
    offset (sequence-sharded attention) is refused until the mesh layer."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_normal(rng, 1, 4, 96, 16))
    k, v = (torch.from_numpy(_normal(rng, 1, 2, 160, 16)) for _ in range(2))
    got = flash_attention_plain(q, k, v, causal=True, tile_k=32)
    kx, vx = k.repeat_interleave(2, dim=1), v.repeat_interleave(2, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), kx.double()) / 4.0
    mask = torch.arange(96)[:, None] >= torch.arange(160)[None, :]
    w = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    want = torch.einsum("bhqk,bhkd->bhqd", w, vx.double())
    torch.testing.assert_close(got.double(), want, atol=2e-6, rtol=0)
    whole = flash_attention_plain(q, k, v, causal=True, tile_k=160)
    torch.testing.assert_close(got, whole, atol=2e-6, rtol=0)
    with pytest.raises(NotImplementedError, match="mesh layer"):
        tatt.chunked_attention(q, k, v, q_block=32, kv_block=32, kv_offset=32)


def test_flash_wrapper_refuses_other_devices_and_shapes():
    q = torch.zeros(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        flash_attention(q, q, q)
    x = torch.zeros(1, 3, 8, 16)
    with pytest.raises(ValueError, match="KV must divide H"):
        flash_attention(x, torch.zeros(1, 2, 8, 16), torch.zeros(1, 2, 8, 16))
    with pytest.raises(ValueError, match="two equal"):
        flash_attention(x, x, torch.zeros(1, 3, 4, 16))


def test_cpu_attention_launches_no_kernel():
    from repro_torch.kernels import _build

    before = dict(_build.FLASH_ATTENTION.launches)
    x = torch.zeros(1, 2, 64, 16)
    flash_attention(x, x, x)
    assert dict(_build.FLASH_ATTENTION.launches) == before


# ---------------------------------------------------------------------------
# (b) layer functions against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_layer_norm(dtype):
    rng = np.random.default_rng(4)
    jx, tx = _pair(_normal(rng, 2, 5, 64), dtype)
    scale = 1.0 + 0.1 * _normal(rng, 64)
    bias = 0.1 * _normal(rng, 64)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    got = tlay.rms_norm(tx, torch.from_numpy(scale), 1e-5)
    assert got.dtype == tx.dtype
    _assert_close(got, jlay.rms_norm(jx, jnp.asarray(scale), 1e-5), tol)
    got = tlay.layer_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias))
    _assert_close(got, jlay.layer_norm(jx, jnp.asarray(scale), jnp.asarray(bias)), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_is_interleaved(dtype):
    rng = np.random.default_rng(5)
    jx, tx = _pair(_normal(rng, 2, 3, 7, 16), dtype)
    pos = np.arange(7, dtype=np.int32) + 5
    want = jlay.apply_rope(jx, jnp.asarray(pos), 1e4)
    got = tlay.apply_rope(tx, torch.from_numpy(pos), 1e4)
    assert got.dtype == tx.dtype
    _assert_close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)
    np.testing.assert_allclose(tlay.rope_freqs(16, 1e4).numpy(),
                               np.asarray(jlay.rope_freqs(16, 1e4)), rtol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
def test_dense_and_mlp(dtype, bias):
    rng = np.random.default_rng(6)
    jx, tx = _pair(_normal(rng, 2, 5, 32), dtype)
    w = _normal(rng, 32, 48) / math.sqrt(32)
    b = _normal(rng, 48) if bias else None
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    got = tlay.dense(tx, torch.from_numpy(w), None if b is None else torch.from_numpy(b))
    assert got.dtype == tx.dtype
    _assert_close(got, jlay.dense(jx, jnp.asarray(w), None if b is None
                                  else jnp.asarray(b)), tol)
    wi, wo = _normal(rng, 32, 48) / math.sqrt(32), _normal(rng, 24, 32) / math.sqrt(24)
    bi, bo = _normal(rng, 48), _normal(rng, 32)
    for gated, act in ((True, "silu"), (True, "gelu"), (False, "gelu")):
        p = {"wi": wi if gated else wi[:, :24], "wo": wo}
        if bias:
            p["bi"], p["bo"] = (bi if gated else bi[:24]), bo
        got = tlay.mlp({k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in p.items()}, tx, gated=gated, act=act)
        want = jlay.mlp({k: jnp.asarray(v) for k, v in p.items()}, jx,
                        gated=gated, act=act)
        _assert_close(got, want, tol)


def test_embed_and_unembed():
    rng = np.random.default_rng(7)
    table = _normal(rng, 50, 16)
    toks = rng.integers(0, 50, (2, 9)).astype(np.int32)
    got = tlay.embed({"table": torch.from_numpy(table)}, torch.from_numpy(toks))
    want = jlay.embed({"table": jnp.asarray(table)}, jnp.asarray(toks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jx, tx = _pair(_normal(rng, 2, 3, 16), "bfloat16")
    w = _normal(rng, 16, 50)
    got = tlay.unembed({"w": torch.from_numpy(w)}, tx)
    assert got.dtype == torch.bfloat16
    _assert_close(got, jlay.unembed({"w": jnp.asarray(w)}, jx), BF16_TOL)
    got = tlay.unembed({}, tx, table=torch.from_numpy(table))
    _assert_close(got, jlay.unembed({}, jx, table=jnp.asarray(table)), BF16_TOL)


def test_cache_insert_prefill_and_decode():
    """Prefill writes the cache's head, decode one position; bitwise."""
    rng = np.random.default_rng(8)
    cache = _normal(rng, 2, 2, 12, 16)
    for new, index in ((_normal(rng, 2, 2, 5, 16), 0),
                       (_normal(rng, 2, 2, 1, 16), 7),
                       (_normal(rng, 2, 2, 12, 16), 0)):
        jc, tc = _pair(cache, "bfloat16")
        jn, tn = _pair(new, "bfloat16")
        want = jatt.cache_insert(jc, jn, index, axis=2)
        got = tatt.cache_insert(tc, tn, index, axis=2)
        assert got is tc  # in place
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    with pytest.raises(ValueError, match="index 0"):
        tatt.cache_insert(torch.zeros(1, 1, 8, 4), torch.ones(1, 1, 3, 4), 2, axis=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,kv_offset", [(True, 0), (False, 0), (True, 4)])
def test_full_attention(dtype, causal, kv_offset):
    rng = np.random.default_rng(9)
    jq, tq = _pair(_normal(rng, 2, 8, 12, 16), dtype)
    jk, tk = _pair(_normal(rng, 2, 2, 12 + kv_offset, 16), dtype)
    jv, tv = _pair(_normal(rng, 2, 2, 12 + kv_offset, 16), dtype)
    want = jatt.full_attention(jq, jk, jv, causal=causal, kv_offset=kv_offset)
    got = tatt.full_attention(tq, tk, tv, causal=causal, kv_offset=kv_offset)
    assert got.dtype == tq.dtype
    _assert_close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention(dtype):
    rng = np.random.default_rng(10)
    jq, tq = _pair(_normal(rng, 2, 8, 1, 16), dtype)
    jk, tk = _pair(_normal(rng, 2, 2, 20, 16), dtype)
    jv, tv = _pair(_normal(rng, 2, 2, 20, 16), dtype)
    want = jatt.decode_attention(jq, jk, jv, jnp.int32(13))
    got = tatt.decode_attention(tq, tk, tv, 13)
    _assert_close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


def test_chunked_and_banded_in_float32_match_the_reference():
    """In float32 the reference's scans round nothing to bf16, so K4's
    plain version and the reference's chunked and banded scans compute
    the same function: they agree to float32 summation order."""
    rng = np.random.default_rng(11)
    q = _normal(rng, 1, 4, 64, 16)
    k, v = _normal(rng, 1, 2, 64, 16), _normal(rng, 1, 2, 64, 16)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for causal in (True, False):
        want = jatt.chunked_attention(jq, jk, jv, causal=causal, q_block=16,
                                      kv_block=32)
        got = tatt.chunked_attention(tq, tk, tv, causal=causal, q_block=16,
                                     kv_block=32)
        _assert_close(got, want, F32_TOL)
    _assert_close(tatt.banded_attention(tq, tk, tv, q_block=16),
                  jatt.banded_attention(jq, jk, jv, q_block=16), F32_TOL)
    with pytest.raises(ValueError, match="tile the lengths"):
        tatt.chunked_attention(tq, tk, tv, q_block=48, kv_block=32)


def test_pick_block_and_split_heads():
    for s, t in ((1500, 512), (2048, 512), (1088, 32), (7, 4)):
        assert tatt.pick_block(s, t) == jatt.pick_block(s, t)
    x = np.arange(2 * 5 * 24, dtype=np.float32).reshape(2, 5, 24)
    got = tatt._split_heads(torch.from_numpy(x), 3, 8)
    want = jatt._split_heads(jnp.asarray(x), 3, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tatt._merge_heads(got).numpy(), x)


def test_gqa_attention_decode_writes_the_cache_in_place():
    from repro_torch.configs import get_config

    cfg = get_config("granite-8b").reduced()
    gen = torch.Generator()
    gen.manual_seed(0)
    p = tatt.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim, device="cpu")
    cache = {"k": torch.zeros(1, cfg.n_kv_heads, 8, cfg.head_dim, dtype=torch.bfloat16),
             "v": torch.zeros(1, cfg.n_kv_heads, 8, cfg.head_dim, dtype=torch.bfloat16)}
    x = torch.randn(1, 1, cfg.d_model, generator=gen).bfloat16()
    y, out = tatt.gqa_attention(p, x, cfg, positions=torch.tensor([3]),
                                cache=cache, cache_index=3)
    assert out is cache and y.shape == x.shape
    assert bool(cache["k"][:, :, 3].abs().sum() > 0)
    assert float(cache["k"][:, :, :3].abs().sum()) == 0.0
    # cross attention (Whisper's decoder): q alone projected, with its bias
    # and without RoPE, k and v given (float32 here) and cast to x's type,
    # no mask; full, and chunked through K4's plain version (non-causal,
    # blocks 10 and 24 picked apart for 40 queries and 24 keys); the cache
    # is returned untouched
    from repro.configs import get_config as jget_config

    pb = tatt.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.head_dim, bias=True, device="cpu")
    pb["bq"] = torch.randn(pb["bq"].shape, generator=gen)
    jp = {k: jnp.asarray(t.numpy()) for k, t in pb.items()}
    xs = torch.randn(1, 40, cfg.d_model, generator=gen).bfloat16()
    ck, cv = (torch.randn(1, cfg.n_kv_heads, 24, cfg.head_dim, generator=gen)
              for _ in range(2))
    before = {k: t.clone() for k, t in cache.items()}
    for impl in ("full", "chunked"):
        y, out = tatt.gqa_attention(pb, xs, cfg, positions=torch.arange(40), impl=impl,
                                    cache=cache, cross_kv=(ck, cv))
        want, _ = jatt.gqa_attention(jp, jnp.asarray(xs.float().numpy()).astype(jnp.bfloat16),
                                     jget_config("granite-8b").reduced(),
                                     positions=jnp.arange(40), impl=impl,
                                     cross_kv=(jnp.asarray(ck.numpy()),
                                               jnp.asarray(cv.numpy())))
        assert out is cache and y.dtype == torch.bfloat16 and y.shape == xs.shape
        assert all(torch.equal(cache[k], before[k]) for k in cache)
        _assert_close(y, want, BF16_TOL)



# ---------------------------------------------------------------------------
# (c) a value width of its own (MLA: q/k nope + rope wide, v v_head_dim)
# ---------------------------------------------------------------------------

# (dh, dv): DeepSeek-V2-Lite's reduced config (nope 16 + rope 8, v 16) and
# its full widths (128 + 64, v 128), at short sequences
MLA_WIDTHS = [(24, 16), (192, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh,dv", MLA_WIDTHS)
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_with_a_value_width_of_its_own(dh, dv, causal, dtype):
    """K4's plain version (through ``chunked_attention``) against the
    reference's jnp ``chunked_attention`` at dv != dh: the Pallas K4 takes
    dv = dh only, so the reference's scan is the oracle."""
    rng = np.random.default_rng(12)
    jq, tq = _pair(_normal(rng, 2, 4, 64, dh), dtype)
    jk, tk = _pair(_normal(rng, 2, 2, 64, dh), dtype)
    jv, tv = _pair(_normal(rng, 2, 2, 64, dv), dtype)
    want = jatt.chunked_attention(jq, jk, jv, causal=causal, q_block=16, kv_block=32)
    got = tatt.chunked_attention(tq, tk, tv, causal=causal, q_block=16, kv_block=32)
    assert got.dtype == tq.dtype and tuple(got.shape) == (2, 4, 64, dv)
    _assert_close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)
    plain = flash_attention_plain(tq, tk, tv, causal=causal, tile_k=32)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh,dv", MLA_WIDTHS)
def test_banded_attention_with_a_value_width_of_its_own(dh, dv, dtype):
    rng = np.random.default_rng(13)
    jq, tq = _pair(_normal(rng, 1, 4, 96, dh), dtype)
    jk, tk = _pair(_normal(rng, 1, 4, 96, dh), dtype)
    jv, tv = _pair(_normal(rng, 1, 4, 96, dv), dtype)
    want = jatt.banded_attention(jq, jk, jv, q_block=32)
    got = tatt.banded_attention(tq, tk, tv, q_block=32)
    assert tuple(got.shape) == (1, 4, 96, dv)
    _assert_close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("dh,dv", MLA_WIDTHS)
def test_flash_plain_value_width_against_float64(dh, dv):
    """The plain version at dv != dh, GQA and more keys than queries,
    against the masked softmax in float64."""
    rng = np.random.default_rng(14)
    q = torch.from_numpy(_normal(rng, 1, 4, 48, dh))
    k = torch.from_numpy(_normal(rng, 1, 2, 80, dh))
    v = torch.from_numpy(_normal(rng, 1, 2, 80, dv))
    got = flash_attention_plain(q, k, v, causal=True, tile_k=32)
    kx, vx = k.repeat_interleave(2, dim=1), v.repeat_interleave(2, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), kx.double()) / math.sqrt(dh)
    mask = torch.arange(48)[:, None] >= torch.arange(80)[None, :]
    w = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    want = torch.einsum("bhqk,bhkd->bhqd", w, vx.double())
    torch.testing.assert_close(got.double(), want, atol=2e-6, rtol=0)


def test_value_width_no_longer_refused_but_bad_heads_are():
    """dv != dh used to raise ``ValueError`` in K4's shape check; a KV head
    count that does not divide H, and k and v of different lengths or
    heads, still raise."""
    q, k = torch.zeros(1, 4, 8, 24), torch.zeros(1, 2, 8, 24)
    out = flash_attention(q, k, torch.zeros(1, 2, 8, 16))
    assert tuple(out.shape) == (1, 4, 8, 16)
    for impl in (tatt.chunked_attention, tatt.banded_attention):
        assert tuple(impl(q, k, torch.zeros(1, 2, 8, 16)).shape) == (1, 4, 8, 16)
    with pytest.raises(ValueError, match="KV must divide H"):
        flash_attention(q, torch.zeros(1, 3, 8, 24), torch.zeros(1, 3, 8, 16))
    with pytest.raises(ValueError, match="two equal"):
        flash_attention(q, k, torch.zeros(1, 2, 6, 16))
    with pytest.raises(ValueError, match="two equal"):
        flash_attention(q, k, torch.zeros(1, 1, 8, 16))
