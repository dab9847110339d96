"""The walker's recommendation rows, on the CPU: ``user_bias``'s order of
additions and ``scores``' denominator against the plain bodies and the JAX
package.

The CUDA program (csrc/dag_walk.cu: Recommendation) adds a row's entries
in its own order, which ``kernels/ref.py:user_bias_ref`` emulates in
float32. The smoke holds the card's ``user_bias`` to the plain body within
eps32 * sqrt(n_items) * sum|R[r]| / n_items (``chip_smoke.py``'s
``close``); here the emulation is held to the same limit against the
port's plain body and the reference's ``jnp.mean``, on rows drawn as the
smoke's 65,536 x 2,048 data (density 0.3). ``scores`` divides by one
denominator an item, sqrt(norm) + 1e-9 in float32 with IEEE rounding:
bitwise the reference's.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.vee import apps as japps
from repro_torch.kernels import ref as tref
from repro_torch.vee import apps as tapps

EPS32 = 2.0 ** -23


def _rows(n_rows, n_items, seed=0, density=0.3):
    """Rows drawn as the recommendation lowering draws R."""
    rng = np.random.default_rng(seed)
    R = rng.uniform(0.0, 1.0, size=(n_rows, n_items))
    return (R * (rng.uniform(size=(n_rows, n_items)) < density)).astype(np.float32)


def _limit(R):
    n_items = R.shape[1]
    return EPS32 * math.sqrt(n_items) * np.abs(R.astype(np.float64)).sum(1) / n_items


@pytest.mark.parametrize("n_items", [2048, 2050, 260, 130])
def test_user_bias_order_within_the_smokes_limit(n_items):
    """512 rows of the smoke's draw (n_items 2,048: 16-byte vectors; 2,050
    and 130: scalars; 260: a partial last vector batch)."""
    R = _rows(512, n_items, seed=n_items)
    got = tref.user_bias_ref(torch.from_numpy(R)).numpy().astype(np.float64)
    lim = _limit(R)
    plain = tapps._bias_tile(torch.from_numpy(R)).numpy()
    ref = np.asarray(jnp.mean(jnp.asarray(R), axis=1))
    assert (np.abs(got - plain) <= lim).all()
    assert (np.abs(got - ref) <= lim).all()
    exact = R.astype(np.float64).mean(1)
    assert (np.abs(got - exact) <= lim).all()


def test_user_bias_order_is_the_lanes_and_the_tree():
    """Hand-checked: one row of 256 ones and a spike of 2^30 at column 5.
    Lane l adds columns 4l .. 4l + 3 and 4l + 128 .. 4l + 131, so lane 1
    holds the spike, and the ones it adds after it round away; the tree
    then adds the 32 lane sums."""
    R = torch.ones((1, 256), dtype=torch.float32)
    R[0, 5] = 2.0 ** 30
    s = torch.full((32,), 8.0)
    s[1] = 2.0 ** 30 + 1.0           # 1 + 2^30 rounds to 2^30; so does every later 1
    for off in (16, 8, 4, 2, 1):
        s = s + s[torch.arange(32) ^ off]
    assert torch.equal(tref.user_bias_ref(R), s[:1] / 256)


def test_user_bias_scalar_order_when_asked():
    """The scalar order (rows that are not 16-byte aligned) differs from the
    vector order on some row, and both stay within the limit."""
    R = _rows(256, 2048, seed=3)
    t = torch.from_numpy(R)
    vec, sca = tref.user_bias_ref(t), tref.user_bias_ref(t, vectors=False)
    assert not torch.equal(vec, sca)
    lim = _limit(R)
    exact = R.astype(np.float64).mean(1)
    for got in (vec, sca):
        assert (np.abs(got.numpy().astype(np.float64) - exact) <= lim).all()


def test_scores_denominator_is_the_references():
    """The port's CPU denominator (``scores_den``, which ``scores_plain``
    divides by) is bitwise the reference's jnp.sqrt(norms) + 1e-9 and the
    kernel's den (an IEEE square root and add in float32; numpy's float32
    sqrt rounds correctly, as __fsqrt_rn does), planted zeros and tiny
    norms too. PyTorch's CPU float32 sqrt is not correctly rounded on
    every entry, so ``sqrt_rn`` takes the root in float64 and rounds it
    once; on the card torch.sqrt rounds correctly, and the smoke holds
    scores bitwise to the plain body there."""
    R = _rows(1024, 2048, seed=7)
    norms = (R * R).sum(0)
    norms[:6] = [0.0, 1e-30, 1e-18, 3.0, 0.0, 2.0 ** -140]
    den = np.sqrt(norms) + np.float32(1e-9)
    den_j = np.asarray(jnp.sqrt(jnp.asarray(norms)) + 1e-9)
    assert den.dtype == np.float32 and den_j.dtype == np.float32
    assert np.array_equal(den.view(np.int32), den_j.view(np.int32))
    rounded = np.sqrt(norms.astype(np.float64)).astype(np.float32)
    assert np.array_equal(np.sqrt(norms).view(np.int32), rounded.view(np.int32))
    den_t = tapps.scores_den(torch.from_numpy(norms))
    assert den_t.dtype == torch.float32
    assert np.array_equal(den_t.numpy().view(np.int32), den_j.view(np.int32))


def test_sqrt_rn_is_the_correctly_rounded_root():
    """``sqrt_rn`` (the scores denominator's root and linreg's std) is
    bitwise jnp.sqrt on float32 values over the whole normal exponent
    range and zeros, and numpy's IEEE root on subnormals too (XLA on the
    CPU flushes a subnormal to zero; a denominator never sees the
    difference, since such a root lies below half an ulp of 1e-9)."""
    rng = np.random.default_rng(21)
    a = rng.uniform(1.0, 2.0, 100_000) * 2.0 ** rng.integers(-126, 128, 100_000)
    a = np.concatenate([a.astype(np.float32), np.float32([0.0, 1.0, 4.0])])
    got = tapps.sqrt_rn(torch.from_numpy(a)).numpy()
    assert np.array_equal(got.view(np.int32), np.asarray(jnp.sqrt(jnp.asarray(a))).view(np.int32))
    assert np.array_equal(got.view(np.int32), np.sqrt(a).view(np.int32))
    sub = np.float32([2.0 ** -149, 3 * 2.0 ** -140, 2.0 ** -127])
    assert np.array_equal(tapps.sqrt_rn(torch.from_numpy(sub)).numpy(), np.sqrt(sub))


def test_scores_plain_is_the_references_body_on_near_ties():
    """A draw where a one-ulp denominator moves the top item: rows whose two
    largest quotients tie exactly when the root is correctly rounded (R =
    2 den on both items), on items whose norms PyTorch's CPU float32 sqrt
    rounds the wrong way where it does so. The port's ``scores_plain`` on
    the CPU is bitwise the reference lowering's own ``scores`` body; with
    ``torch.sqrt`` for the root it is not, wherever that root is off."""
    rng = np.random.default_rng(5)
    n_users, n_items = 128, 260
    R = rng.uniform(0.0, 1.0, (n_users, n_items)).astype(np.float32)
    cand = (rng.uniform(1.0, 64.0, 200_000)).astype(np.float32)
    right = np.sqrt(cand)
    off = torch.sqrt(torch.from_numpy(cand)).numpy() != right
    norms = rng.uniform(1.0, 64.0, n_items).astype(np.float32)
    planted = cand[off][:n_items // 2]
    norms[1::2][:planted.size] = planted
    norms[0::2][:planted.size] = cand[~off][:planted.size]
    den = np.sqrt(norms) + np.float32(1e-9)
    for r in range(n_users):      # items 2k and 2k + 1 tie at 2 on row r
        k = r % (n_items // 2)
        R[r, [2 * k, 2 * k + 1]] = 2 * den[[2 * k, 2 * k + 1]]
    bias = R.mean(1)
    jlow = japps.recommendation_device_lowering(n_users, n_items, tile=64, seed=0)
    body = next(st.body for st in jlow.stages if st.name == "scores")
    want = np.zeros(n_users, np.int32)
    body(None, {"R": R, "item_norms": norms, "user_bias": bias}, want)
    got = tapps.scores_plain(*(torch.from_numpy(a) for a in (R, norms, bias)))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, 2 * (np.arange(n_users) % (n_items // 2)))
    den_torch = (torch.sqrt(torch.from_numpy(norms)) + 1e-9).numpy()
    old = torch.argmax(torch.from_numpy(R / den_torch - bias[:, None]), dim=1).numpy()
    flips = den_torch[want + 1] < den[want + 1]     # the second quotient above 2
    assert np.array_equal(old, np.where(flips, want + 1, want))
    assert flips.any() == bool((den_torch[1::2][:planted.size] < den[1::2][:planted.size]).any())


def _plant_ties(R, rng, n_rows):
    """Rows 0 .. n_rows - 1 each get 2 or 3 columns of their own, 1.0 in
    that row and 0 elsewhere: the columns' norms are 1, so their scores tie
    at the row's maximum. Returns each planted row's first such column."""
    cols = rng.permutation(R.shape[1])[:3 * n_rows].reshape(n_rows, 3)
    R[:, cols.ravel()] = 0.0
    first = []
    for r, c in enumerate(cols):
        c = c[:2 + r % 2]
        R[r, c] = 1.0
        first.append(int(c.min()))
    return np.array(first)


def test_scores_on_the_denominator_match_the_reference():
    """The scores body divided by the per-item denominator (what the
    kernel does) gives the reference lowering's top items, the first
    index on rows with planted ties."""
    R = _rows(256, 260, seed=11)
    first = _plant_ties(R, np.random.default_rng(11), 64)
    norms = (R * R).sum(0)
    bias = R.mean(1)
    t = tapps.scores_plain(torch.from_numpy(R), torch.from_numpy(norms),
                           torch.from_numpy(bias))
    den = torch.sqrt(torch.from_numpy(norms)) + 1e-9
    mine = torch.argmax(torch.from_numpy(R) / den - torch.from_numpy(bias)[:, None], 1)
    j = np.asarray(jnp.argmax(jnp.asarray(R) / (jnp.sqrt(jnp.asarray(norms)) + 1e-9)
                              - jnp.asarray(bias)[:, None], axis=1))
    assert torch.equal(t, mine.to(torch.int32))
    assert np.array_equal(t.numpy(), j)
    assert np.array_equal(t[:64].numpy(), first)


def test_reference_lowering_draws_the_same_rows():
    """The rows these tests draw are the lowerings' R (both packages)."""
    low = tapps.recommendation_device_lowering(128, 260, tile=64, seed=4, device="cpu")
    jlow = japps.recommendation_device_lowering(128, 260, tile=64, seed=4)
    R = _rows(128, 260, seed=4)
    assert np.array_equal(low.values["R"].numpy(), R)
    assert np.array_equal(np.asarray(jlow.values["R"]), R)


def test_smoke_chain_is_the_function_and_its_bytes_two_reads():
    """``chip_smoke.py``'s yardstick chain computes the walk's answer (the
    plain scores on the plain norms and biases), for one R and a stack of
    two; its byte count reads R twice."""
    from test_torch_rwkv import chip_smoke

    smoke = chip_smoke()
    low = tapps.recommendation_device_lowering(256, 260, tile=64, seed=2, device="cpu")
    R = low.values["R"]
    want = tapps.scores_plain(R, (R * R).sum(0), R.mean(1))
    assert torch.equal(smoke.rec_chain(R).to(torch.int32), want)
    stacked = smoke.rec_chain(torch.stack([R, R.flip(0)]))
    assert torch.equal(stacked[0].to(torch.int32), want)
    assert smoke.rec_bytes(65536, 2048) == 4 * (2 * 65536 * 2048 + 2048 + 2 * 65536)
