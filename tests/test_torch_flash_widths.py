"""K4 and K4' at every head width (ROADMAP B0): the padded route against
the JAX package's attention and its gradient.

The CUDA kernels are compiled for the (dh, dv) pairs of
``kernels/flash_attention.py:WIDTHS``; any other pair up to (192, 128)
runs on the smallest compiled pair that covers it, q, k and v zero-padded
and the launch given the true width's ``1/sqrt(dh)``. Here the route runs
with the kernels' plain versions in their places (``_forward(plain=True)``,
``flash_attention_bwd(plain=True)``), the same padding, scale and slicing,
on the CPU. Inputs are drawn with numpy from a seed and fed to both
packages, in float32.

Tolerances, with their reasons:

* against the Pallas K4 (``ops.attention``, ``interpret=True``; it takes
  dv = dh only) and the reference's jnp ``chunked_attention``: 2e-5 of the
  largest |output|, the reference's own kernel tests' float32 tolerance
  (the two sum in other orders);
* the gradient against ``jax.vjp`` of ``chunked_attention``: 2e-5 of each
  gradient's largest magnitude, for the same reason (XLA differentiates
  the scan op by op; the port's backward recomputes P from the LSE);
* the padded route against the unpadded plain versions: the padded columns
  add exact zeros, so only the grouping of the fp32 sums may move: 2^-20
  of the largest magnitude (a few float32 roundings).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import attention as jatt
from repro_torch.kernels import flash_attention as tfa

REF_TOL = 2e-5
ROUTE_TOL = 2.0 ** -20

# (dh, dv) off the compiled pairs and their covering pair, the compiled
# pairs themselves, and the widths above (192, 128)
COVERING = [((8, 8), (16, 16)), ((16, 16), (16, 16)), ((24, 16), (64, 64)),
            ((64, 32), (64, 64)), ((80, 80), (96, 96)), ((96, 96), (96, 96)),
            ((96, 100), (112, 112)), ((100, 64), (112, 112)), ((112, 112), (112, 112)),
            ((120, 128), (128, 128)), ((128, 128), (128, 128)), ((130, 64), (192, 128)),
            ((192, 100), (192, 128)), ((192, 128), (192, 128))]
TOO_WIDE = [(193, 128), (128, 129), (256, 256)]
# the train_lm example's ~100M heads (96, on their own pair), DeepSeek-V2-
# Lite's reduced MLA (24, 16, padded to 64), an odd width (80, padded to 96)
CASES = [(96, 96), (24, 16), (80, 80)]


@pytest.mark.parametrize("width,pair", COVERING)
def test_compiled_widths_picks_the_smallest_covering_pair(width, pair):
    assert tfa.compiled_widths(*width) == pair
    assert pair in tfa.WIDTHS


@pytest.mark.parametrize("width", TOO_WIDE)
def test_compiled_widths_refuses_above_the_widest_pair_naming_b0(width):
    with pytest.raises(ValueError, match="ROADMAP B0"):
        tfa.compiled_widths(*width)


def _inputs(dh: int, dv: int, seed: int, b=1, h=4, kv=2, s=128):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, dh), (b, kv, s, dh), (b, kv, s, dv), (b, h, s, dv))]


def _route(q, k, v, dout, causal: bool):
    """The padded route's forward and backward with the plain versions."""
    out, lse = tfa._forward(q, k, v, causal, with_lse=True, plain=True, tile_k=32)
    return out, tfa.flash_attention_bwd(q, k, v, out, dout, lse, causal, plain=True,
                                        tile_k=32)


def _close(got: torch.Tensor, want, tol: float) -> None:
    want = np.asarray(want, np.float64)
    got = got.double().numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * float(np.abs(want).max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh,dv", CASES)
def test_padded_route_against_the_reference_and_its_gradient(dh, dv, causal):
    """The route's output against the Pallas K4 in interpret mode (where
    dv = dh) and the reference's ``chunked_attention``, and its dq, dk, dv
    against ``jax.vjp`` of ``chunked_attention``, GQA group 2."""
    arrays = _inputs(dh, dv, dh + dv + int(causal))
    q, k, v, dout = (torch.from_numpy(a) for a in arrays)
    copies = dict(tfa.PAD_COPIES)
    out, grads = _route(q, k, v, dout, causal)
    padded = tfa.compiled_widths(dh, dv) != (dh, dv)
    assert (dict(tfa.PAD_COPIES) != copies) == padded
    assert tuple(out.shape) == (1, 4, 128, dv)

    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrays)

    def ref(q_, k_, v_):
        return jatt.chunked_attention(q_, k_, v_, causal=causal, q_block=32, kv_block=32)

    want, vjp = jax.vjp(ref, jq, jk, jv)
    _close(out, want, REF_TOL)
    if dh == dv:
        _close(out, jops.attention(jq, jk, jv, causal=causal, tile_q=64, tile_k=64), REF_TOL)
    for got, exact in zip(grads, vjp(jdo)):
        _close(got, exact, REF_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh,dv", CASES)
def test_padded_route_is_the_unpadded_plain_function(dh, dv, causal):
    """The padded route against the plain versions run at the true width:
    the output and LSE, then dq, dk and dv, within fp32 rounding."""
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(dh, dv, 7 + dh))
    out, grads = _route(q, k, v, dout, causal)
    want, lse = tfa.flash_attention_lse_plain(q, k, v, causal, 32)
    _close(out, want.numpy(), ROUTE_TOL)
    _, lse_route = tfa._forward(q, k, v, causal, with_lse=True, plain=True, tile_k=32)
    _close(lse_route, lse.numpy(), ROUTE_TOL)
    plain = tfa.flash_attention_bwd_plain(q, k, v, want, dout, lse, causal, 32)
    for got, exact in zip(grads, plain):
        assert got.shape == exact.shape
        _close(got, exact.numpy(), ROUTE_TOL)


def test_plain_versions_take_an_explicit_scale():
    """``scale`` given as ``1/sqrt(dh)`` is the default; another scale is
    the same function on q scaled by its ratio to the default."""
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(64, 64, 3))
    default = tfa.flash_attention_lse_plain(q, k, v, True, 32)
    given = tfa.flash_attention_lse_plain(q, k, v, True, 32, scale=1 / math.sqrt(64))
    assert all(torch.equal(a, b) for a, b in zip(default, given))
    half = tfa.flash_attention_lse_plain(q, k, v, True, 32, scale=0.5 / math.sqrt(64))
    torch.testing.assert_close(half[0], tfa.flash_attention_lse_plain(q * 0.5, k, v, True,
                                                                      32)[0])
    grads = tfa.flash_attention_bwd_plain(q, k, v, half[0], dout, half[1], True, 32,
                                          scale=0.5 / math.sqrt(64))
    want = tfa.flash_attention_bwd_plain(q * 0.5, k, v, half[0], dout, half[1], True, 32)
    torch.testing.assert_close(grads[0], want[0] * 0.5)
    torch.testing.assert_close(grads[1], want[1])
    torch.testing.assert_close(grads[2], want[2])
