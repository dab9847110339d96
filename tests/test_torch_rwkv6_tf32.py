"""The arithmetic of the CUDA K6 (``csrc/rwkv6_scan.cu``) on the CPU: the
per-channel gate recentred at 16-step sub-chunks, products as split TF32.

The kernel runs the RWKV6 WKV scan chunk-parallel. A state launch walks
each (batch, head)'s chunks in order: ``U_c = (k exp(cQ - cum))^T v`` and
``state = fmaf(state, exp(cQ), U_c)``, row by row. An output launch forms
each chunk's ``A[t, s]`` (s < t) by blocks of 16-step sub-chunks: the
blocks below the diagonal as products ``(r exp(cum_{t-1} - e_j)) (k
exp(e_j - cum_s))^T`` on the tensor cores, ``e_j`` the cumsum at the last
step of sub-chunk j, so every exponent is <= 0; the diagonal blocks with
the exact gate a pair. Then ``y = (r exp(cum_{t-1})) S_in + A v``. Every
product runs in TF32 with an fp32 operand split into ``big = tf32(a)`` and
``small = tf32(a - big)``; a bfloat16 v is exact in TF32 and is not split.
``kernels/ref.py:rwkv6_scan_split_ref`` emulates that order in float32.

At RWKV6-3B's widths (dh 64, chunk 64; three heads), inputs from a seed
with numpy, the emulation is held to ``chip_smoke.py``'s K6 limits
(``rwkv6_limits``: eps32 sqrt(3 Q) (1 + c) sum|terms| against the float64
oracle, y and the final state) and to twice them against the plain
version, as the smoke holds the kernel, and to ``SCAN_TOL`` of the Pallas
K6 (interpret mode) and of the model's ``_wkv_chunked`` state. Two draws:
``model``, Finch's decay at the model's initial bias (``w_base`` -0.6),
spread by a LoRA term of 0.5 randn, whose chunk cumsums reach about 50;
``fast``, the smoke's fast-decay draw ``max(-exp(4 randn), -30)``, whose
cumsums reach about 900 and widen the limit by (1 + c). The emulation
with the small halves dropped (one TF32 product, the control) fails the
limit on the model draw; on the fast draw the widened limit holds it too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import rwkv as jrwkv
from repro_torch.kernels import ref as tref
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain
from test_torch_rwkv import SCAN_TOL, chip_smoke

DH = Q = 64


def _inputs(seed, bt, h, s, dtype, draw):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((bt, h, s, DH)) for _ in range(3))
    if draw == "model":
        logw = -np.exp(np.minimum(-0.6 + 0.5 * rng.standard_normal((bt, h, s, DH)), 3.4))
    else:
        logw = np.maximum(-np.exp(4.0 * rng.standard_normal((bt, h, s, DH))), -30.0)
    u = rng.standard_normal((h, DH)) * 0.1
    f32 = (lambda a: torch.from_numpy(np.asarray(a, np.float32)))
    return f32(r).to(dtype), f32(k).to(dtype), f32(v).to(dtype), f32(logw), f32(u)


CASES = [(256, torch.bfloat16, "model"), (256, torch.float32, "model"),
         (1024, torch.bfloat16, "model"), (512, torch.bfloat16, "fast"),
         (512, torch.float32, "fast")]


@pytest.mark.parametrize("s,dtype,draw", CASES)
def test_split_tf32_passes_the_smokes_k6_limits(s, dtype, draw):
    smoke = chip_smoke()
    x = _inputs(s, 1, 3, s, dtype, draw)
    oracle, limits, _ = smoke.rwkv6_limits(*x, Q)
    got = tref.rwkv6_scan_split_ref(*x, Q)
    plain = rwkv6_scan_plain(*x, chunk=Q)
    for g, p, o, lim, what in zip(got, plain, oracle, limits, ("y", "state")):
        assert g.dtype == torch.float32 and g.shape == o.shape
        assert bool(torch.isfinite(g).all())
        bad, _, share = smoke.beyond(g, o, lim)
        assert bad == 0 and share < 0.25, (what, bad, share)
        bad, _, share = smoke.beyond(g, p, 2 * lim)
        assert bad == 0, (what, bad, share)


@pytest.mark.parametrize("draw", ["model", "fast"])
def test_split_tf32_agrees_with_the_pallas_kernel_and_wkv_chunked(draw):
    x = _inputs(11, 1, 3, 256, torch.float32, draw)
    y, state = tref.rwkv6_scan_split_ref(*x, Q)
    arrays = [jnp.asarray(t.numpy()) for t in x]
    want = np.asarray(jops.wkv6(*arrays, chunk=Q))
    _, jfinal = jrwkv._wkv_chunked(*arrays, Q)
    np.testing.assert_allclose(y.numpy(), want, atol=SCAN_TOL, rtol=SCAN_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(jfinal), atol=SCAN_TOL,
                               rtol=SCAN_TOL)


@pytest.mark.parametrize("s,dtype", [(256, torch.bfloat16), (256, torch.float32),
                                     (1024, torch.bfloat16)])
def test_one_tf32_product_fails_the_limit(s, dtype):
    """The small halves dropped on the model draw: each split operand (the
    gated r and k, A, the state; v too in float32) keeps 11 bits; entries
    of y and many of the state pass their limit."""
    smoke = chip_smoke()
    x = _inputs(s, 1, 3, s, dtype, "model")
    oracle, limits, _ = smoke.rwkv6_limits(*x, Q)
    got = tref.rwkv6_scan_split_ref(*x, Q, one_tf32=True)
    (bad_y, _, share_y), (bad_s, _, share_s) = (
        smoke.beyond(g, o, lim) for g, o, lim in zip(got, oracle, limits))
    assert bad_y > 0 and share_y > 1.5, (bad_y, share_y)
    assert bad_s > got[1].numel() // 100 and share_s > 2, (bad_s, share_s)


def test_chunk_end_reference_point_overflows_on_the_fast_draw():
    """The Pallas docstring's factored form, one reference point at the
    chunk's end: its factor exp(cum_{t-1} - cum_Q) overflows float32 under
    fast decay, and y comes out inf or nan; the sub-chunk form stays
    finite on the same inputs."""
    x = _inputs(13, 1, 3, 256, torch.bfloat16, "fast")
    y, _, parts = tref.rwkv6_scan_split_ref(*x, Q, ref_point="chunk_end", parts=True)
    assert parts["max_exponent"] > 88.8   # log of float32's largest value
    assert not bool(torch.isfinite(y).all())
    y, state = tref.rwkv6_scan_split_ref(*x, Q)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(state).all())


@pytest.mark.parametrize("draw", ["model", "fast"])
@pytest.mark.parametrize("q", [8, 24, 64])
def test_every_exponent_is_at_most_zero(draw, q):
    """Every exp the kernel takes (the state's decay and K^'s gate, the
    recentred factors of the blocks below the diagonal, the exact gate of
    the diagonal blocks, the carry-in's) has an argument <= 0."""
    x = _inputs(19, 1, 2, 192, torch.bfloat16, draw)
    _, _, parts = tref.rwkv6_scan_split_ref(*x, q, parts=True)
    assert parts["max_exponent"] <= 0.0


@pytest.mark.parametrize("q", [8, 16, 24, 64])
def test_padding_steps_leave_the_state_and_real_rows_bitwise(q):
    """A chunk runs padded to a multiple of 16 steps (a full sub-chunk
    more at 16 and 64 here): the same scan on inputs that carry the
    padding as real steps (logw 0; r, k, v 0) after each chunk, at the
    longer chunk, gives the real rows' y and the final state bitwise."""
    pad = -q % 16 or 16
    x = _inputs(23, 1, 2, 3 * q, torch.bfloat16, "fast")
    y, state = tref.rwkv6_scan_split_ref(*x, q)

    def padded(t):
        c = t.reshape(1, 2, 3, q, DH)
        return torch.cat([c, c.new_zeros((1, 2, 3, pad, DH))], dim=3).reshape(1, 2, -1, DH)

    yp, statep = tref.rwkv6_scan_split_ref(*(padded(t) for t in x[:4]), x[4], q + pad)
    assert torch.equal(yp.reshape(1, 2, 3, q + pad, DH)[:, :, :, :q].reshape(y.shape), y)
    assert torch.equal(statep, state)


def test_state_pass_is_a_sequential_pass_bitwise():
    """The states the output launch reads (the emulation's ``entering``)
    and the final state are bitwise a plain sequential pass over the
    emulated updates, row c of the state decayed by its own exp(cQ_c):
    state_0 = 0, state_c = fmaf(state_{c-1}, exp(cQ), U_c), in numpy with
    the product and sum in float64."""
    x = _inputs(29, 2, 2, 256, torch.bfloat16, "model")
    _, state, parts = tref.rwkv6_scan_split_ref(*x, Q, parts=True)
    U = parts["U"].numpy()
    decay = torch.exp(parts["cum"][..., -1, :]).numpy()      # (Bt, H, nc, dh)
    want = np.zeros(U[:, :, 0].shape, np.float32)
    for c in range(U.shape[2]):
        assert np.array_equal(parts["entering"][:, :, c].numpy().view(np.int32),
                              want.view(np.int32)), c
        want = (want.astype(np.float64) * decay[:, :, c, :, None].astype(np.float64)
                + U[:, :, c].astype(np.float64)).astype(np.float32)
    assert np.array_equal(state.numpy().view(np.int32), want.view(np.int32))


def test_chunk_cumsum_is_in_time_order():
    """``cum`` is logw's inclusive cumsum over each chunk added in time
    order in float32, bitwise a numpy loop; padded steps add nothing."""
    logw = _inputs(31, 1, 2, 96, torch.float32, "fast")[3]
    cum = tref.rwkv6_chunk_cumsum(logw, 24, 32).numpy()
    lw = logw.numpy()
    for h in range(2):
        for c in range(4):
            acc = np.zeros(DH, np.float32)
            for t in range(32):
                if t < 24:
                    acc = (acc + lw[0, h, 24 * c + t]).astype(np.float32)
                assert np.array_equal(cum[0, h, c, t].view(np.int32), acc.view(np.int32))
