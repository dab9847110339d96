"""Split TF32, the arithmetic of the CUDA K5' and K6' (the scans'
gradients, ``csrc/ssm_scan_bwd.cu`` and ``csrc/rwkv6_scan_bwd.cu``), on
the CPU.

Both kernels run every matrix product on the tensor cores in TF32: an
fp32 operand is split into ``big = tf32(a)`` and ``small = tf32(a -
big)``; a bfloat16 operand is exact in TF32 and is not split.
``kernels/ref.py:ssm_scan_bwd_split_ref`` emulates K5''s order of
products (the reverse pass of the state's gradient, each chunk's carry-in,
dx's state term, Y, M^T and the gated tiles in its registers, dB and dC
summed over a group of 8 heads and then folded over the groups in order);
``rwkv6_scan_bwd_split_ref`` emulates K6''s (dA, the gated sums over dA as
16-step block products recentred at sub-chunk reference points, each
sub-chunk's quadrant recentred at its step 7 and only its two 8-step
triangles with the exact gate, A^T formed as the forward forms A).

At full widths (dh = N = 64, chunks of 64 and 16, a few heads, up to
1,024 steps), inputs from a seed with numpy, each emulation is held to
``chip_smoke.py:scan_bwd_limits`` (u |g| + eps32 sqrt(6 Q + k') (1 + c)
sum|terms| against the float64 gradient) and to twice it against the
plain backward, as the smoke holds the kernels. The same emulation with
the small halves dropped (one TF32 product a product, the control) fails
the limit on Mamba2's and the RWKV6 model's draws; under fast decay the
limit's (1 + c) widens it past the control, as for the forward (see
``tests/test_torch_rwkv6_tf32.py``). Every exponent the RWKV6 emulation
takes is <= 0, and padded steps leave the real rows bitwise.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as tref
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_bwd_plain
from repro_torch.kernels.ssm_scan import ssm_scan_bwd_plain

ROOT = Path(__file__).resolve().parents[1]
DH = N = 64


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def chip_smoke():
    """``chip_smoke.py`` as a module: its ``scan_bwd_limits`` and ``beyond``."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def f32(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def ssm_inputs(seed, bt, s, h, dtype, draw):
    """x, dt, A, B, C as ``tests/test_torch_ssm_tf32.py`` draws them
    (``mamba2``: Mamba2's initialisation; ``smoke``: the smoke's randn
    draw), y's and the final state's gradients randn."""
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
    dy, dstate = rng.standard_normal((bt, s, h, DH)), rng.standard_normal((bt, h, DH, N))
    return ((f32(x).to(dtype), f32(dt), f32(A), f32(B).to(dtype), f32(C).to(dtype)),
            f32(dy), f32(dstate))


def rwkv6_inputs(seed, bt, h, s, dtype, draw):
    """r, k, v, logw, u as ``tests/test_torch_rwkv6_tf32.py`` draws them
    (``model``: Finch's decay at the model's bias; ``fast``: down to -30 a
    step), y's and the final state's gradients randn."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((bt, h, s, DH)) for _ in range(3))
    if draw == "model":
        logw = -np.exp(np.minimum(-0.6 + 0.5 * rng.standard_normal((bt, h, s, DH)), 3.4))
    else:
        logw = np.maximum(-np.exp(4.0 * rng.standard_normal((bt, h, s, DH))), -30.0)
    u = rng.standard_normal((h, DH)) * 0.1
    dy, dstate = rng.standard_normal((bt, h, s, DH)), rng.standard_normal((bt, h, DH, DH))
    return ((f32(r).to(dtype), f32(k).to(dtype), f32(v).to(dtype), f32(logw), f32(u)),
            f32(dy), f32(dstate))


SSM_NAMES, RWKV6_NAMES = ("x", "dt", "A", "B", "C"), ("r", "k", "v", "logw", "u")


def shares(kind, args, dy, dstate, q, got):
    """Per gradient: (entries beyond the limit, worst share of it) against
    the float64 gradient."""
    smoke = chip_smoke()
    names = SSM_NAMES if kind == "ssm" else RWKV6_NAMES
    limits = smoke.scan_bwd_limits(kind, dict(zip(names, args)), dy, dstate, q)
    return {name: smoke.beyond(g, limits[name][0], limits[name][1])[::2]
            for name, g in zip(limits, got)}, limits


SSM_CASES = [(256, torch.bfloat16, "mamba2", 64, 11), (256, torch.float32, "mamba2", 64, 3),
             (1024, torch.bfloat16, "mamba2", 64, 3), (512, torch.float32, "smoke", 64, 3),
             (256, torch.bfloat16, "mamba2", 16, 9)]


@pytest.mark.parametrize("s,dtype,draw,q,h", SSM_CASES)
def test_ssm_bwd_split_tf32_within_the_smokes_limits(s, dtype, draw, q, h):
    """K5''s emulation at 11 and 9 heads (a group of 8 and a partial one,
    folded in order) and 3, against the float64 gradient and the plain
    backward; each gradient in its input's dtype."""
    args, dy, dstate = ssm_inputs(s + h, 1, s, h, dtype, draw)
    got = tref.ssm_scan_bwd_split_ref(*args, dy, dstate, q)
    plain = ssm_scan_bwd_plain(*args, dy, dstate, q)
    smoke = chip_smoke()
    out, limits = shares("ssm", args, dy, dstate, q, got)
    for (name, (exact, _, lim_p)), g, p in zip(limits.items(), got, plain):
        assert g.shape == exact.shape and bool(torch.isfinite(g).all()), name
        assert out[name][0] == 0, (name, out[name])
        bad, _, share = smoke.beyond(g, p.to(g.dtype), lim_p)
        assert bad == 0, (name, "vs plain", bad, share)
    assert got[0].dtype == dtype and got[3].dtype == dtype and got[1].dtype == torch.float32


RWKV6_CASES = [(256, torch.bfloat16, "model", 64), (256, torch.float32, "model", 64),
               (1024, torch.bfloat16, "model", 64), (512, torch.bfloat16, "fast", 64),
               (512, torch.float32, "fast", 64), (192, torch.bfloat16, "fast", 16),
               (192, torch.float32, "model", 24)]


@pytest.mark.parametrize("s,dtype,draw,q", RWKV6_CASES)
def test_rwkv6_bwd_split_tf32_within_the_smokes_limits(s, dtype, draw, q):
    """K6''s emulation against the float64 gradient and the plain backward,
    at the model's decay and under fast decay, chunks 64, 16 and 24 (padded
    to 32)."""
    args, dy, dstate = rwkv6_inputs(s + q, 1, 3, s, dtype, draw)
    got = tref.rwkv6_scan_bwd_split_ref(*args, dy, dstate, q)
    plain = rwkv6_scan_bwd_plain(*args, dy, dstate, q)
    smoke = chip_smoke()
    out, limits = shares("rwkv6", args, dy, dstate, q, got)
    for (name, (exact, _, lim_p)), g, p in zip(limits.items(), got, plain):
        assert g.shape == exact.shape and bool(torch.isfinite(g).all()), name
        assert out[name][0] == 0, (name, out[name])
        bad, _, share = smoke.beyond(g, p.to(g.dtype), lim_p)
        assert bad == 0, (name, "vs plain", bad, share)
    assert all(g.dtype == dtype for g in got[:3])


@pytest.mark.parametrize("kind,s,dtype,draw", [("ssm", 1024, torch.bfloat16, "mamba2"),
                                               ("ssm", 256, torch.float32, "mamba2"),
                                               ("rwkv6", 1024, torch.bfloat16, "model"),
                                               ("rwkv6", 512, torch.float32, "model")])
def test_one_tf32_product_fails_the_limit(kind, s, dtype, draw):
    """The small halves dropped: each split operand (dy, the states, the
    gated tiles; x, B, C or r, k, v too in float32) keeps 11 bits, and
    entries of the gradients pass their limits (in bfloat16 the outputs'
    own rounding hides most of it: dx for K5', dv for K6' still fail)."""
    if kind == "ssm":
        args, dy, dstate = ssm_inputs(s, 1, s, 3, dtype, draw)
        got = tref.ssm_scan_bwd_split_ref(*args, dy, dstate, 64, one_tf32=True)
    else:
        args, dy, dstate = rwkv6_inputs(s + 1, 1, 3, s, dtype, draw)
        got = tref.rwkv6_scan_bwd_split_ref(*args, dy, dstate, 64, one_tf32=True)
    out, _ = shares(kind, args, dy, dstate, 64, got)
    assert sum(bad for bad, _ in out.values()) > 0, out
    assert max(share for _, share in out.values()) > 1.1, out


@pytest.mark.parametrize("draw", ["model", "fast"])
@pytest.mark.parametrize("q", [16, 24, 64])
def test_every_rwkv6_exponent_is_at_most_zero(draw, q):
    """Every exp K6' takes (the reverse pass's r exp(cm1) and decay, the
    carry-in's exp(cm1), the blocks' factors and scales, the quadrants'
    recentred factors, the triangles' exact gates, K^ and the state term's
    exp(cQ - cum)) has an argument <= 0."""
    args, dy, dstate = rwkv6_inputs(37, 1, 2, 192, torch.bfloat16, draw)
    *_, parts = tref.rwkv6_scan_bwd_split_ref(*args, dy, dstate, q, parts=True)
    assert parts["max_exponent"] <= 0.0


@pytest.mark.parametrize("q", [24, 8])
def test_rwkv6_padded_steps_leave_the_real_rows_bitwise(q):
    """A chunk of 24 (or 8) runs padded to 32 (16) steps: the same
    gradient on inputs that carry the padding as real steps (logw 0; r,
    k, v and dy 0) after each chunk, at the longer chunk, gives the real
    rows of dr, dk, dv and dlogw bitwise."""
    pad = -q % 16
    args, dy, dstate = rwkv6_inputs(41, 1, 2, 3 * q, torch.bfloat16, "fast")
    got = tref.rwkv6_scan_bwd_split_ref(*args, dy, dstate, q)

    def padded(t):
        c = t.reshape(1, 2, 3, q, DH)
        return torch.cat([c, c.new_zeros((1, 2, 3, pad, DH))], dim=3).reshape(1, 2, -1, DH)

    longer = tref.rwkv6_scan_bwd_split_ref(*(padded(t) for t in args[:4]), args[4], padded(dy),
                                           dstate, q + pad)
    for name, g, w in zip(("dr", "dk", "dv", "dlogw"), got, longer):
        real = w.reshape(1, 2, 3, q + pad, DH)[:, :, :, :q].reshape(g.shape)
        assert torch.equal(real, g), name

