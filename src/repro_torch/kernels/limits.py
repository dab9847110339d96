"""Limits that hold a kernel's float sums to another version of the same sums.

A kernel and its plain version (or the host pool's ops) add the same terms
in another order, so on the card their float ``sum`` outputs agree to
float32 rounding, not bitwise. These helpers give each entry its limit, as
``chip_smoke.py`` and the examples (``repro_torch.examples``) hold them:

* ``excess`` / ``beyond``: eps32 * sqrt(adds) * sum|terms| per entry;
* ``moe_limits``: an MoE expert slab's float64 oracle and its two limits,
  and ``moe_combined_limit``: those carried through the token-side combine;
* ``hold``: bitwise where both sides ran the same operations (the CPU's
  plain versions), else within ``excess``'s limit, raising otherwise.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["EPS32", "MIGRATED_FACTOR", "SILU_SLOPE", "beyond", "excess", "hold",
           "moe_combined_limit", "moe_limits"]

# A sum's kernel and plain versions add the same terms in a different order
# (sequential FMA vs PyTorch's reduction), so they agree to float32 rounding,
# not bitwise. Each of the k additions into an entry's accumulator rounds
# by at most one float32 eps of the accumulator, which never exceeds the
# entry's sum of |terms| A; with random rounding the two versions part by
# about eps * sqrt(k) * A. That is each entry's limit. For a `sum` stage k
# is its slot count (one fold per 64-row tile): 7.4 on a linreg `moments`
# entry and 15 on a `syrk_gemv` diagonal entry, below the 21-64 that one
# dropped tile moves them by. The limit holds for a sum of the same terms,
# so `syrk_gemv`, whose terms are standardized by the `moments` the walk
# read, is held to the plain stage on those same moments (`solo_walk` in
# chip_smoke.py, the host op in the examples) and to a float64 oracle;
# against the plain walk's own moments it would also take the moments'
# rounding, which the variance's cancellation (E[x^2] - mean^2) magnifies.
EPS32 = 2.0 ** -23

# A migrated run's sum entry comes from two summers (the host's PyTorch
# tile sums and the kernel's), and the never-preempted walk it is held to
# rounds too: both sides round, so the limit doubles.
MIGRATED_FACTOR = 2.0

# an MoE slab entry is two products: h = x wi over d terms, then
# out = (silu(g) * u) wo over f terms. Its limit is eps * sqrt(f) * sum|terms|
# of the second product, plus the first product's limit eps * sqrt(d) *
# sum|terms| carried through silu(g) * u (|silu'| <= 1.1) and wo, plus
# 4 eps of |silu(g) * u| for the gating's own roundings (exp, add, divide,
# multiply). Against the float64 oracle the kernel takes the limit; against
# the plain version both sides round, so twice it. That limit carries the
# first product's limit through wo as if every h entry erred with one sign,
# which is sqrt(f) too wide for roundings of either sign: one TF32 product
# (11-bit operands) stays inside it. So the slabs are also held to the
# limit with that part added as roundings add, eps * sqrt(d) *
# sqrt(B^2 @ wo^2) (`moe_limits`); a one-TF32-product control on the same
# inputs must fail it, where the 3xTF32 kernel passes.
SILU_SLOPE = 1.1


def beyond(got, want, limit) -> tuple[int, float, float]:
    """Entries where ``|got - want|`` passes ``limit``: their count, the
    largest absolute error, and the largest share of its limit an entry's
    error takes."""
    diff = (got.double() - want.double()).abs()
    return (int((diff > limit).sum()), float(diff.max()),
            float((diff / limit.clamp_min(1e-300)).max()))


def excess(kernel, plain, abs_sum, adds: int, factor: float = 1.0):
    """Entries of a sum output beyond their limit against another version.

    ``abs_sum`` holds each entry's sum of |terms| and ``adds`` the number of
    additions into its accumulator (see EPS32); the limit is ``factor``
    times eps * sqrt(adds) * sum|terms|. Returns the count of entries beyond
    it, the largest absolute error, and the largest share of its limit that
    an entry's error takes.
    """
    return beyond(kernel, plain, factor * EPS32 * math.sqrt(adds) * abs_sum.double())


def hold(got, want, abs_sum, adds: int, what: str, exact: bool,
         factor: float = MIGRATED_FACTOR):
    """Hold a sum output to another version of it: bitwise when ``exact``
    (both sides ran the same operations in the same order, as the plain
    versions do on the CPU), else within ``factor`` times ``excess``'s
    limit. Raises AssertionError naming ``what`` when it fails; returns
    ``"bitwise"`` or the worst share of the limit an entry takes."""
    got = torch.as_tensor(got)
    want = torch.as_tensor(want).to(got.device)
    if exact:
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: not bitwise equal "
                                 f"(max abs err {float((got - want).abs().max()):.3g})")
        return "bitwise"
    bad, err, share = excess(got, want, abs_sum.to(got.device), adds, factor)
    if bad:
        raise AssertionError(f"{what}: {bad} entries beyond {factor:g}*eps*sqrt({adds})"
                             f"*sum|terms|; max abs err {err:.3g}")
    return share


def moe_limits(x, wi, wo) -> tuple:
    """One MoE slab's float64 oracle and each entry's limits (see
    SILU_SLOPE): ``(ref, lim, lim_rss)`` for ``x (C, d)``, ``wi (d, 2f)``
    and ``wo (f, d)`` in float64."""
    d, f = x.shape[1], wo.shape[0]
    h, A = x @ wi, x.abs() @ wi.abs()
    s, u = F.silu(h[:, :f]), h[:, f:]
    a = s * u
    B = SILU_SLOPE * u.abs() * A[:, :f] + s.abs() * A[:, f:]
    own = (math.sqrt(f) + 4) * (a.abs() @ wo.abs())
    return (a @ wo, EPS32 * (own + math.sqrt(d) * (B @ wo.abs())),
            EPS32 * (own + math.sqrt(d) * ((B * B) @ (wo * wo)).sqrt()))


def moe_combined_limit(lim, slabs, idx: np.ndarray, w: np.ndarray, pos: np.ndarray,
                       capacity: int):
    """The limit of the token-side combine ``(T, d)`` of two versions of the
    expert slabs: each slab entry's limit ``lim`` (float64, ``(E * C, d)``)
    carried through the weighted gather, plus the gather's own roundings
    (k terms a token) on ``slabs``, both sides rounding: twice their sum."""
    from ..vee.ml_apps import _combine

    k = idx.shape[1]
    aw = abs(w).astype("float64")
    return 2 * (_combine(lim, idx, aw, pos, capacity)
                + EPS32 * math.sqrt(k) * _combine(slabs.double().abs(), idx, aw, pos,
                                                  capacity))
