"""Split TF32, the arithmetic of the CUDA K5 (``csrc/ssm_scan.cu``), on the CPU.

The kernel runs the Mamba2 SSD scan chunk-parallel: each chunk's update
``U_c = (x w)^T B`` and decay, a pass over the chunks in order
(``state_c = fmaf(state_{c-1}, exp(cum_Q), U_c)``), then each chunk's
output ``fmaf(exp(cum_t), C state^T, G x)``. Its four matrix products run
on the tensor cores in TF32: an fp32 operand is split into ``big =
tf32(a)`` and ``small = tf32(a - big)``; a bfloat16 operand is exact in
TF32 and is not split. ``kernels/ref.py:ssm_scan_split_ref`` emulates
that order in float32 (TF32 rounding by ``tf32_round``, the kernel's
``cvt.rn.tf32.f32``; products of TF32 values are exact in fp32).

At Zamba2's widths (dh 64, N 64, chunk 64; a few heads), inputs from a
seed with numpy, the emulation is held to ``chip_smoke.py``'s K5 limits
(``ssm_limits``: eps32 sqrt(3 Q) (1 + c) sum|terms| against the float64
oracle, for y and the final state) and to twice them against the plain
version, as the smoke holds the kernel. The same emulation with the small
halves dropped (one TF32 product a product, the control) fails the limit,
so the limit tells the two apart. Two draws: ``mamba2``, Mamba2's own
initialisation (dt from softplus around a bias drawn log-uniform in
[1e-3, 0.1], A in [-16, -1]), and ``smoke``, the smoke's randn draw
(dt = softplus(randn), A = -exp(randn / 2)), whose chunk cumsums reach
about 100 and widen the limit by (1 + c).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssm_scan import ssm_scan_plain
from test_torch_rwkv import chip_smoke

DH = N = Q = 64


def _inputs(seed, bt, s, h, dtype, draw):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bt, s, h, DH))
    B, C = rng.standard_normal((bt, s, N)), rng.standard_normal((bt, s, N))
    if draw == "mamba2":
        dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), h))
        bias = dt0 + np.log(-np.expm1(-dt0))          # softplus(bias) = dt0
        dt = np.log1p(np.exp(rng.standard_normal((bt, s, h)) * 0.5 + bias))
        A = -rng.uniform(1.0, 16.0, h)
    else:
        dt = np.log1p(np.exp(rng.standard_normal((bt, s, h))))
        A = -np.exp(rng.standard_normal(h) * 0.5)
    f32 = (lambda a: torch.from_numpy(np.asarray(a, np.float32)))
    return f32(x).to(dtype), f32(dt), f32(A), f32(B).to(dtype), f32(C).to(dtype)


CASES = [(256, torch.bfloat16, "mamba2", 64), (256, torch.float32, "mamba2", 64),
         (2048, torch.bfloat16, "mamba2", 64), (2048, torch.float32, "smoke", 64),
         (1024, torch.bfloat16, "smoke", 64), (256, torch.bfloat16, "mamba2", 16)]


@pytest.mark.parametrize("s,dtype,draw,q", CASES)
def test_split_tf32_passes_the_smokes_k5_limits(s, dtype, draw, q):
    smoke = chip_smoke()
    x, dt, A, B, C = _inputs(s, 1, s, 3, dtype, draw)
    oracle, limits, _ = smoke.ssm_limits(x, dt, A, B, C, q)
    got = tref.ssm_scan_split_ref(x, dt, A, B, C, q)
    plain = ssm_scan_plain(x, dt, A, B, C, q)
    for g, p, o, lim, what in zip(got, plain, oracle, limits, ("y", "state")):
        assert g.dtype == torch.float32 and g.shape == o.shape
        assert bool(torch.isfinite(g).all())
        bad, _, share = smoke.beyond(g, o, lim)
        assert bad == 0 and share < 0.25, (what, bad, share)
        bad, _, share = smoke.beyond(g, p, 2 * lim)
        assert bad == 0, (what, bad, share)


@pytest.mark.parametrize("s,dtype,draw,q", CASES[:4])
def test_one_tf32_product_fails_the_limit(s, dtype, draw, q):
    """The small halves dropped: every fp32 operand (the gated scores,
    x w, the state; x, B, C too in float32) keeps 11 bits, and many
    entries of y and the state pass their limit."""
    smoke = chip_smoke()
    x, dt, A, B, C = _inputs(s, 1, s, 3, dtype, draw)
    oracle, limits, _ = smoke.ssm_limits(x, dt, A, B, C, q)
    got = tref.ssm_scan_split_ref(x, dt, A, B, C, q, one_tf32=True)
    for g, o, lim, what in zip(got, oracle, limits, ("y", "state")):
        bad, _, share = smoke.beyond(g, o, lim)
        assert bad > g.numel() // 100 and share > 2, (what, bad, share)


def test_chunk_state_pass_is_a_sequential_pass_bitwise():
    """The states the output launch reads (the emulation's ``entering``)
    and the final state are bitwise a plain sequential pass over the
    emulated updates: state_0 = 0, state_c = fmaf(state_{c-1}, decay_c,
    U_c), written here in numpy with the product and sum in float64."""
    x, dt, A, B, C = _inputs(7, 2, 512, 3, torch.bfloat16, "mamba2")
    _, state, parts = tref.ssm_scan_split_ref(x, dt, A, B, C, Q, parts=True)
    U, decay = parts["U"].numpy(), parts["decay"].numpy()
    want = np.zeros(U[:, :, 0].shape, np.float32)
    for c in range(U.shape[2]):
        assert np.array_equal(parts["entering"][:, :, c].numpy().view(np.int32),
                              want.view(np.int32)), c
        want = (want.astype(np.float64) * decay[:, :, c, None, None].astype(np.float64)
                + U[:, :, c].astype(np.float64)).astype(np.float32)
    assert np.array_equal(state.numpy().view(np.int32), want.view(np.int32))


def test_chunk_cumsum_is_in_time_order():
    """``cum`` is the inclusive cumsum of the rounded dt * A over each
    chunk, added in time order in float32, bitwise a numpy loop."""
    x, dt, A, B, C = _inputs(8, 2, 256, 3, torch.bfloat16, "smoke")
    cum = tref.ssm_chunk_cumsum(dt, A, 32).numpy()
    da = (dt.numpy() * A.numpy()[None, None, :]).astype(np.float32)
    for b in range(2):
        for h in range(3):
            for c in range(8):
                acc = np.float32(0)
                for t in range(32):
                    acc = np.float32(acc + da[b, c * 32 + t, h])
                    assert cum[b, h, c, t].view(np.int32) == acc.view(np.int32)


def test_split_keeps_bfloat16_operands_whole():
    """A bfloat16 value is exact in TF32 (7 stored mantissa bits of 10):
    its small half is zero, so C B^T in bfloat16 takes one product and a
    product with one fp32 operand two."""
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.standard_normal(4096).astype(np.float32)).bfloat16().float()
    assert torch.equal(tref.tf32_round(a), a)
    assert len(tref._tf32_terms(a[None], a[:, None], True, True, False)) == 1
    assert len(tref._tf32_terms(a[None], a[:, None], True, False, False)) == 2
    assert len(tref._tf32_terms(a[None], a[:, None], False, False, False)) == 3
