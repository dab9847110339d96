"""K4's gradient on the CPU: ``flash_attention_bwd_plain`` (the recurrences
the backward kernel runs) against ``jax.vjp`` of the reference's
``models/attention.py:chunked_attention`` and a float64 gradient of the
same inputs.

Inputs are numpy draws from a seed: one batch, 7 query heads over one kv
head (GQA group 7), causal and not, 1,088 and 1,100 keys (the kernel's
last 64- and 128-key tiles partial at 1,100), at (dh, dv) = (16, 16) and
(192, 128), in float32 and bfloat16: eight of the sixteen combinations
(``CASES``), each value of each of the four in four of them, to keep the
suite's time.

Tolerances:

* against the float64 gradient, each entry within ``chip_smoke.
  k4_grad_oracle``'s limit, the one the card holds the kernel to: the
  final rounding to the inputs' type and D's reading of the rounded
  output (``u`` = 2^-8 in bfloat16, 2^-24 in float32) plus 2^-14 of the
  entry's sum of |terms| for the fp32 sums, exp and LSE; in bfloat16 the
  plain version rounds P and dS as the kernel does, and the limit carries
  ``u`` of the sum of |terms| for those roundings (without it dv fails);
* against the reference's ``jax.vjp``: in float32 within 1e-4 of each
  gradient's largest magnitude (both are fp32 end to end and differ in
  the order of sums and in tiling; seen 1e-6); in bfloat16 within 2^-4 of it: the
  reference rounds each block's scores to bf16 before the softmax and its
  p.v to bf16 (``test_torch_attention.py``), and differentiates through
  those roundings, where K4 keeps both in fp32; seen 0.015, under 2^-6. The
  reference's own distance from the float64 gradient is reported by the
  same measure, and K4's must be no larger than twice it.
* The plain forward's LSE is ``m + log l`` of its own recurrence; the
  plain pair's gradients equal autograd's of the plain forward to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jatt
from repro_torch.kernels import flash_attention as tfa
from test_torch_rwkv import chip_smoke
from test_torch_train import one_thread  # noqa: F401  (autouse)

SMOKE = chip_smoke()
VJP_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -4}
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(dh: int, dv: int, s: int, dtype, seed: int):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32) for shape in
              ((1, 7, s, dh), (1, 1, s, dh), (1, 1, s, dv), (1, 7, s, dv))]
    torch_in = [torch.from_numpy(a).to(dtype) for a in arrays]
    jax_in = [jnp.asarray(a).astype(JDTYPE[dtype]) for a in arrays]
    return torch_in, jax_in


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


CASES = [(True, 16, 16, 1088, torch.float32), (True, 192, 128, 1100, torch.bfloat16),
         (False, 16, 16, 1100, torch.bfloat16), (False, 192, 128, 1088, torch.float32),
         (True, 16, 16, 1100, torch.float32), (False, 192, 128, 1100, torch.bfloat16),
         (True, 192, 128, 1088, torch.bfloat16), (False, 16, 16, 1088, torch.float32)]


@pytest.mark.parametrize("causal,dh,dv,s,dtype", CASES)
def test_bwd_plain_matches_reference_vjp_and_float64(causal, dh, dv, s, dtype):
    (q, k, v, do), (jq, jk, jv, jdo) = _inputs(dh, dv, s, dtype, dh + s + int(causal))
    blk = 64 if s % 64 == 0 else 100
    out, lse = tfa.flash_attention_lse_plain(q, k, v, causal, blk)
    got = tfa.flash_attention_bwd_plain(q, k, v, out, do, lse, causal, blk)
    oracle = SMOKE.k4_grad_oracle(q, k, v, do, causal)
    for name, g in zip(("dq", "dk", "dv"), got):
        exact, lim, _ = oracle[name]
        assert g.dtype == dtype
        assert SMOKE.beyond(g, exact, lim)[0] == 0, name
    jout, vjp = jax.vjp(lambda a, b_, c: jatt.chunked_attention(
        a, b_, c, causal=causal, q_block=blk, kv_block=blk), jq, jk, jv)
    want = vjp(jdo)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w32 = np.asarray(w.astype(jnp.float32))
        err = _rel(g.float().numpy(), w32)
        assert err <= VJP_TOL[dtype], (name, err)
        exact = oracle[name][0].numpy()
        assert _rel(g.float().numpy(), exact) <= 2 * _rel(w32, exact) + 1e-6, name


@pytest.mark.parametrize("dh,dv", [(64, 64), (192, 128)])
def test_bf16_operand_rounding_needs_its_limit_term(dh, dv):
    """The bf16 plain backward, which rounds P and dS to bfloat16 as the
    kernel's operands, is within ``k4_grad_oracle``'s limit, and the same
    limit without the derived ``u T`` term (``rounded_operands=False``)
    fails in dv (GQA group 7, 300 keys, causal; seen 2,745 and 5,781
    entries beyond it)."""
    (q, k, v, do), _ = _inputs(dh, dv, 300, torch.bfloat16, 11 + dh)
    out, lse = tfa.flash_attention_lse_plain(q, k, v, True, 128)
    got = tfa.flash_attention_bwd_plain(q, k, v, out, do, lse, True, 128)
    oracle = SMOKE.k4_grad_oracle(q, k, v, do, True)
    for name, g in zip(("dq", "dk", "dv"), got):
        assert SMOKE.beyond(g, oracle[name][0], oracle[name][1])[0] == 0, name
    old = SMOKE.k4_grad_oracle(q, k, v, do, True, rounded_operands=False)
    assert SMOKE.beyond(got[2], old["dv"][0], old["dv"][1])[0] > 0


def test_lse_and_plain_pair_match_autograd():
    """The LSE of the plain forward is log sum exp of its masked scores,
    and the plain pair's gradients are autograd's through the plain
    forward (float32, GQA group 7, 300 keys, kv tile 128)."""
    (q, k, v, do), _ = _inputs(64, 64, 300, torch.float32, 5)
    for causal in (True, False):
        _, lse = tfa.flash_attention_lse_plain(q, k, v, causal, 128)
        s = torch.einsum("bhqd,bhkd->bhqk", q, k.expand(-1, 7, -1, -1)) / 8.0
        if causal:
            s = s.masked_fill(torch.ones(300, 300).triu(1).bool(), -1e30)
        torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=0, atol=1e-5)
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        auto = torch.autograd.grad(tfa.flash_attention_plain(*qkv, causal, 128), qkv, do)
        pair = torch.autograd.grad(tfa.flash_attention_plain_pair(*qkv, causal, 128), qkv, do)
        for a, p in zip(auto, pair):
            torch.testing.assert_close(p, a, rtol=0, atol=1e-5 * float(a.abs().max()))


def test_no_d_term_fails_the_float64_limit():
    """The control the card runs against the kernel: the plain backward
    with a zero output (no D term) is beyond the float64 limit."""
    (q, k, v, do), _ = _inputs(64, 64, 300, torch.bfloat16, 7)
    out, lse = tfa.flash_attention_lse_plain(q, k, v, True, 128)
    oracle = SMOKE.k4_grad_oracle(q, k, v, do, True)
    no_d = tfa.flash_attention_bwd_plain(q, k, v, torch.zeros_like(out), do, lse, True, 128)
    assert sum(SMOKE.beyond(g, oracle[n][0], oracle[n][1])[0]
               for n, g in zip(("dq", "dk"), no_d)) > 0


def test_cpu_flash_attention_has_no_function():
    """On the CPU ``flash_attention`` is the plain forward, differentiated
    by autograd op by op (no ``_FlashAttention`` node); nothing launches."""
    from repro_torch.kernels import _build

    (q, k, v, _), _ = _inputs(16, 16, 40, torch.float32, 9)
    q.requires_grad_(True)
    before = dict(_build.FLASH_ATTENTION.launches), dict(_build.FLASH_ATTENTION_BWD.launches)
    out = tfa.flash_attention(q, k, v, True, 16)
    assert out.grad_fn is not None and "FlashAttention" not in type(out.grad_fn).__name__
    out.sum().backward()
    assert (dict(_build.FLASH_ATTENTION.launches),
            dict(_build.FLASH_ATTENTION_BWD.launches)) == before
