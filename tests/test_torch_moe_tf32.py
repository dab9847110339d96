"""3xTF32, the arithmetic of the CUDA walker's MoE program, on the CPU.

``csrc/dag_walk.cu`` takes each fp32 product of an MoE slab on the tensor
cores as three TF32 products: every operand is split into ``big =
tf32(a)`` and ``small = tf32(a - big)``, and ``small b_big + big b_small +
big b_big`` is summed in fp32. The emulation here rounds to TF32 to
nearest, ties to even, on the fp32 bit pattern (``kernels/ref.py:
tf32_round``, the kernel's ``tf32_rne``); products of TF32 values are
exact in fp32, so an fp32 matrix product of the rounded operands sums
exact products in fp32, as the tensor cores do.

Slabs at Qwen1.5-MoE-A2.7B's widths (d 2,048, f 1,408; a few rows; seeded
numpy, He-scaled weights) are held to ``chip_smoke.py``'s float64 limits
(``moe_limits``): the smoke's limit, and the same limit with its
first-product part added as roundings of either sign add. 3xTF32 passes
both; one TF32 product a slab (``moe_one_tf32``, the smoke's control)
fails the second, so that limit tells the two apart.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import tf32_round
from test_torch_rwkv import chip_smoke

D, FF, ROWS = 2048, 1408, 6


def _rne_numpy(a: np.ndarray) -> np.ndarray:
    """TF32 rounding written out in numpy: the 13 dropped bits against half
    an ulp of the kept 10, ties to the even kept pattern."""
    u = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    low, kept = u & 0x1FFF, u >> 13
    up = (low > 0x1000) | ((low == 0x1000) & (kept & 1 == 1))
    return ((kept + up) << 13).astype(np.uint32).view(np.float32)


def _split(a):
    big = tf32_round(a)
    return big, tf32_round(a - big)


def _mm3(a, b):
    """``a @ b`` by 3xTF32: the two small products, then the big one."""
    ab, as_ = _split(a)
    bb, bs = _split(b)
    return (as_ @ bb + ab @ bs) + ab @ bb


def _slab(seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((ROWS, D)).astype(np.float32)
    wi = (rng.standard_normal((D, 2 * FF)) * math.sqrt(2 / D)).astype(np.float32)
    wo = (rng.standard_normal((FF, D)) * math.sqrt(2 / FF)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(wi), torch.from_numpy(wo)


@pytest.mark.parametrize("values", [
    [1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, 1 + 2 ** -10 + 2 ** -11, -(1 + 2 ** -11 + 2 ** -20)],
    "randn",
])
def test_tf32_round_is_nearest_even_on_the_bit_pattern(values):
    if values == "randn":
        rng = np.random.default_rng(0)
        a = (rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096)).astype(np.float32)
    else:
        a = np.array(values, np.float32)
    got = tf32_round(torch.from_numpy(a)).numpy()
    assert np.array_equal(got.view(np.uint32), _rne_numpy(a).view(np.uint32))
    assert not (got.view(np.uint32) & 0x1FFF).any()
    if values != "randn":   # ties go to the even pattern
        assert got.tolist() == [1.0, 1.0, 1 + 2 ** -9, 1 + 2 ** -9, -(1 + 2 ** -10)]


def test_split_keeps_about_21_bits():
    rng = np.random.default_rng(1)
    a = torch.from_numpy((rng.standard_normal(1 << 16)
                          * 10.0 ** rng.integers(-20, 20, 1 << 16)).astype(np.float32))
    big, small = _split(a)
    assert torch.equal(a - big, (a.double() - big.double()).float())   # exact
    err = (big.double() + small.double() - a.double()).abs()
    assert bool((err <= 2.0 ** -22 * a.double().abs()).all())
    assert float(((big.double() - a.double()).abs() / a.double().abs()).max()) > 2.0 ** -13


@pytest.mark.parametrize("seed", [0, 1])
def test_three_tf32_products_pass_the_smoke_limits(seed):
    smoke = chip_smoke()
    x, wi, wo = _slab(seed)
    ref, lim, lim_rss = smoke.moe_limits(x.double(), wi.double(), wo.double())
    h = _mm3(x, wi)
    out = _mm3(F.silu(h[:, :FF]) * h[:, FF:], wo)
    assert out.shape == (ROWS, D) and bool(torch.isfinite(out).all())
    for limit in (lim, lim_rss):
        bad, _, share = smoke.beyond(out, ref, limit)
        assert bad == 0 and share < 0.1, share


@pytest.mark.parametrize("seed", [0, 1])
def test_one_tf32_product_fails_the_limit_the_kernel_is_held_to(seed):
    """The smoke's control: each product taken once in TF32 keeps 11 bits
    of each operand and fails the limit whose first-product part adds as
    roundings add, on many entries; fp32 products pass it by far. (The
    smoke's first limit, which adds that part as if every rounding had one
    sign, is wide enough for one TF32 product at these widths.)"""
    smoke = chip_smoke()
    x, wi, wo = _slab(seed)
    ref, _, lim_rss = smoke.moe_limits(x.double(), wi.double(), wo.double())
    bad, _, share = smoke.beyond(smoke.moe_one_tf32(x, wi, wo), ref, lim_rss)
    assert bad > ROWS * D // 100 and share > 2, (bad, share)
    h = x @ wi
    fp32 = (F.silu(h[:, :FF]) * h[:, FF:]) @ wo
    assert smoke.beyond(fp32, ref, lim_rss)[2] < 0.1
