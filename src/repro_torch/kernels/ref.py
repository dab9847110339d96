"""Plain PyTorch oracles for the kernels (the ground truth of the tests)."""

from __future__ import annotations

import math

import torch

from .ssm_scan import HEAD_GROUP


def cc_propagate_ref(G: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """u[i] = max(max_{j: G[i,j] != 0} c[j], c[i]).  G: (n, n) dense {0,1}."""
    neigh = torch.where(G > 0, c[None, :], torch.zeros((), dtype=c.dtype,
                                                       device=c.device))
    return torch.maximum(neigh.amax(dim=1), c)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q, k, v: (B, H, S, dh) (same H; GQA expansion happens in ops).

    The masked S x S softmax: scores in q's type, then fp32, masked with
    -1e30, softmax, weights rounded to q's type for the product with v.
    """
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float()
    s = s / math.sqrt(q.shape[-1])
    if causal:
        sq, sk = s.shape[-2:]
        mask = torch.arange(sq, device=q.device)[:, None] >= torch.arange(
            sk, device=q.device)[None, :]
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w.to(q.dtype), v)


def ssm_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                 dtype=torch.float32, return_state: bool = False):
    """Sequential Mamba2 (SSD) recurrence oracle.

    x ``(Bt, S, H, dh)``; dt ``(Bt, S, H)``; A ``(H,)`` (negative); B and C
    ``(Bt, S, N)``. Returns ``(Bt, S, H, dh)`` in ``dtype`` (float64 for a
    card check), and with ``return_state`` the final state ``(Bt, H, dh,
    N)`` too.
    """
    bt, s, h, dh = x.shape
    n = B.shape[-1]
    xf, dtf, Af = x.to(dtype), dt.to(dtype), A.to(dtype)
    Bf, Cf = B.to(dtype), C.to(dtype)
    state = torch.zeros((bt, h, dh, n), dtype=dtype, device=x.device)
    ys = []
    for t in range(s):
        dA = torch.exp(dtf[:, t] * Af[None, :])                           # (Bt, H)
        upd = (dtf[:, t, :, None, None] * xf[:, t, :, :, None]) \
            * Bf[:, t, None, None, :]
        state = state * dA[..., None, None] + upd
        ys.append(torch.einsum("bhdn,bn->bhd", state, Cf[:, t]))
    y = torch.stack(ys, dim=1) + D.to(dtype)[None, None, :, None] * xf
    return (y, state) if return_state else y


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   logw: torch.Tensor, u: torch.Tensor, dtype=torch.float32,
                   return_state: bool = False):
    """Sequential RWKV6 recurrence oracle.

    r, k, v, logw ``(Bt, H, S, dh)`` (logw <= 0); u ``(H, dh)``.
    ``y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)``,
    ``S_t = diag(w_t) S_{t-1} + k_t v_t^T``. Returns ``(Bt, H, S, dh)`` in
    ``dtype``, and with ``return_state`` the final state ``(Bt, H, dh, dh)``.
    """
    bt, h, s, dh = r.shape
    rf, kf, vf, lwf = (t.to(dtype) for t in (r, k, v, logw))
    uf = u.to(dtype)
    state = torch.zeros((bt, h, dh, dh), dtype=dtype, device=r.device)
    ys = []
    for t in range(s):
        r_t, k_t, v_t = rf[:, :, t], kf[:, :, t], vf[:, :, t]
        ys.append(torch.einsum("bhc,bhcd->bhd", r_t, state)
                  + (r_t * uf[None] * k_t).sum(-1, keepdim=True) * v_t)
        state = state * torch.exp(lwf[:, :, t])[..., None] \
            + k_t[..., :, None] * v_t[..., None, :]
    y = torch.stack(ys, dim=2)
    return (y, state) if return_state else y


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """float32 ``a`` rounded to TF32 (10 stored mantissa bits), to nearest
    with ties to even, on the bit pattern; the low 13 bits come out zero.
    The walker's MoE program rounds its operands so (csrc/dag_walk.cu:
    tf32_rne)."""
    u = a.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32).view(torch.float32)


def _split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``a = big + small`` to about 21 bits: ``big = tf32(a)``, ``small =
    tf32(a - big)`` (the subtraction is exact)."""
    big = tf32_round(a)
    return big, tf32_round(a - big)


def _tf32_terms(a: torch.Tensor, b: torch.Tensor, a_exact: bool, b_exact: bool,
                one: bool) -> list:
    """The TF32 products that stand for the fp32 product ``a @ b``, in the
    order csrc/ssm_scan.cu issues them: an operand exact in TF32 (bfloat16
    data) is not split; one split operand takes ``small b + big b``; two
    take ``a_small b_big + a_big b_small + a_big b_big``. ``one`` keeps
    only the big halves (one TF32 product: the control)."""
    if one:
        return [(a if a_exact else tf32_round(a), b if b_exact else tf32_round(b))]
    if a_exact and b_exact:
        return [(a, b)]
    if a_exact:
        bb, bs = _split(b)
        return [(a, bs), (a, bb)]
    ab, as_ = _split(a)
    if b_exact:
        return [(as_, b), (ab, b)]
    bb, bs = _split(b)
    return [(as_, bb), (ab, bs), (ab, bb)]


def _mma_sum(terms: list, acc: torch.Tensor | None = None) -> torch.Tensor:
    """fp32 sum of the products in ``terms`` over k-steps of 8, as the
    tensor cores' m16n8k8 steps add them: each step adds every term's
    eight products into the one accumulator (``acc``, or none), the terms
    in their order. Products of TF32 values are exact in fp32."""
    k = terms[0][0].shape[-1]
    for k0 in range(0, k, 8):
        for a, b in terms:
            p = a[..., k0:k0 + 8] @ b[..., k0:k0 + 8, :]
            acc = p if acc is None else acc + p
    return acc


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``fmaf(a, b, c)`` on float32 tensors: the product is exact in
    float64, the sum rounds once there and again to float32, which is the
    single rounding of fmaf but where the float64 sum falls on a float32
    tie (a 2^-29 chance a value)."""
    return (a.double() * b.double() + c.double()).float()


def ssm_chunk_cumsum(dt: torch.Tensor, A: torch.Tensor, q: int) -> torch.Tensor:
    """The inclusive cumsum of ``dt * A`` over each chunk of ``q`` steps, in
    time order, in float32 with the product rounded before the add (the
    kernel's ``__fadd_rn(acc, __fmul_rn(dt, a))``): ``(Bt, H, nc, q)`` for
    dt ``(Bt, S, H)``."""
    bt, s, h = dt.shape
    da = (dt.float() * A.float()[None, None, :]).permute(0, 2, 1).reshape(bt, h, s // q, q)
    cum = torch.empty_like(da)
    acc = torch.zeros_like(da[..., 0])
    for t in range(q):
        acc = acc + da[..., t]
        cum[..., t] = acc
    return cum


def chunk_state_pass(U: torch.Tensor, decay: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunk-state pass, chunks in order: ``state_c = fmaf(state_{c-1},
    decay_c, U_c)`` from a zero state. ``U`` ``(Bt, H, nc, rows, cols)``,
    decay ``(Bt, H, nc)`` (K5: one a chunk) or ``(Bt, H, nc, rows)`` (K6:
    one a row). Returns the states entering each chunk ``(Bt, H, nc, rows,
    cols)`` (chunk 0's zero) and the final state."""
    state = torch.zeros_like(U[:, :, 0])
    entering = []
    for c in range(U.shape[2]):
        entering.append(state)
        d = decay[:, :, c]
        d = d.reshape(d.shape + (1,) * (state.dim() - d.dim()))
        state = fma32(state, d.expand_as(state), U[:, :, c])
    return torch.stack(entering, dim=2), state


def ssm_scan_split_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, q: int, one_tf32: bool = False,
                       parts: bool = False):
    """K5's arithmetic on the CPU (csrc/ssm_scan.cu): the chunk-parallel
    SSD order with every matrix product on split TF32, in float32.

    Per chunk of ``q`` steps, with ``cum`` from ``ssm_chunk_cumsum``:
    the update ``U = (x w)^T B`` (``w_s = exp(cum_Q - cum_s) dt_s``) and the
    decay ``exp(cum_Q)``; the state pass (``chunk_state_pass``); then the
    output ``y = fmaf(exp(cum_t), C state^T, G x)`` with the gated scores
    ``G[t, s] = (C B^T)[t, s] exp(cum_t - cum_s) dt_s`` for s <= t. Each
    product's TF32 terms and their order are ``_tf32_terms``' (x, B and C
    exact when bfloat16); ``one_tf32`` keeps only the big halves. Returns
    ``(y, state)`` as ``ssm_scan_state`` does, and with ``parts`` also the
    dict of ``cum``, ``U``, ``decay`` and the entering states."""
    bt, s, h, dh = x.shape
    n = B.shape[-1]
    nc = s // q
    exact = x.dtype == torch.bfloat16
    xc = x.float().reshape(bt, nc, q, h, dh).permute(0, 3, 1, 2, 4)   # (Bt, H, nc, q, dh)
    Bc = B.float().reshape(bt, 1, nc, q, n)
    Cc = C.float().reshape(bt, 1, nc, q, n)
    dtc = dt.float().permute(0, 2, 1).reshape(bt, h, nc, q)
    cum = ssm_chunk_cumsum(dt, A, q)
    # the state launch: each chunk's update and decay
    w = torch.exp(cum[..., -1:] - cum) * dtc
    xw = xc * w[..., None]
    U = _mma_sum(_tf32_terms(xw.transpose(-1, -2), Bc.expand(bt, h, nc, q, n),
                             False, exact, one_tf32))
    decay = torch.exp(cum[..., -1])
    entering, state = chunk_state_pass(U, decay)
    # the output launch: each chunk's intra-chunk part and carry-in
    cb = _mma_sum(_tf32_terms(Cc, Bc.transpose(-1, -2), exact, exact, one_tf32))
    tri = torch.arange(q)[:, None] >= torch.arange(q)[None, :]
    diff = cum[..., :, None] - cum[..., None, :]
    G = torch.where(tri, cb * torch.exp(torch.where(tri, diff, 0.0)) * dtc[..., None, :],
                    torch.zeros(()))
    intra = _mma_sum(_tf32_terms(G, xc, False, exact, one_tf32))
    carry = _mma_sum(_tf32_terms(Cc.expand(bt, h, nc, q, n), entering.transpose(-1, -2),
                                 exact, False, one_tf32))
    y = fma32(torch.exp(cum)[..., None].expand_as(carry), carry, intra)
    y = y.permute(0, 2, 3, 1, 4).reshape(bt, s, h, dh)
    if parts:
        return y, state, dict(cum=cum, U=U, decay=decay, entering=entering)
    return y, state


def rwkv6_chunk_cumsum(logw: torch.Tensor, q: int, pad: int) -> torch.Tensor:
    """The inclusive cumsum of ``logw`` over each chunk of ``q`` steps, in
    time order, in float32 (the kernels' sequential fp32 adds; PyTorch's
    CPU ``cumsum`` accumulates in float64): ``(Bt, H, nc, pad, dh)`` for
    logw ``(Bt, H, S, dh)``, each chunk's steps past ``q`` padded with
    ``logw = 0``, so their cumsum stays the chunk's last."""
    bt, h, s, dh = logw.shape
    lw = logw.float().reshape(bt, h, s // q, q, dh)
    cum = torch.empty((bt, h, s // q, pad, dh), dtype=torch.float32)
    acc = torch.zeros_like(lw[..., 0, :])
    for t in range(pad):
        if t < q:
            acc = acc + lw[..., t, :]
        cum[..., t, :] = acc
    return cum


def _rwkv6_diag_pairs(rc, kc, cm1, cum, uf, i: int, exps: list, halves: int = 1):
    """Sub-chunk ``i``'s pairs with the exact gate, as csrc/rwkv6_scan.cu's
    lanes add them: ``A[t, s]`` for s < t in one of its two 8-step runs,
    ``sum_c fmaf(r k, exp(cm1_t - cum_s), acc)`` over channels c = 4 m + p,
    m ascending, into four sums (p = 0..3) added as ``(a_0 + a_1) + (a_2 +
    a_3)``, and the bonus ``sum_c fmaf(r u, k, acc)`` in the same order.
    With ``halves`` 2 (csrc/rwkv6_scan_bwd.cu, two warps) each half of the
    channels is summed so and the two sums are added, the first half's
    first. Returns the (.., 16, 16) block ``[t, s]`` (0 off the triangles)
    and the bonus (.., 16); appends the largest exponent to ``exps``."""
    dh = rc.shape[-1]
    ti = slice(16 * i, 16 * i + 16)
    steps = torch.arange(16)
    tri = (steps[:, None] > steps[None, :]) & (steps[:, None] // 8 == steps[None, :] // 8)
    diff = cm1[..., ti, None, :] - cum[..., None, ti, :]         # (.., t, s, c)
    exps.append(diff[..., tri, :].max())
    g = torch.exp(torch.where(tri[..., None], diff, 0.0))
    rk = rc[..., ti, None, :] * kc[..., None, ti, :]
    ru = rc[..., ti, :] * uf
    width = dh // halves
    pairs = bonuses = None
    for h in range(halves):
        pair, bonus = [], []
        for p in range(4):
            acc = torch.zeros_like(rk[..., 0])
            accb = torch.zeros_like(ru[..., 0])
            for c in range(h * width + p, (h + 1) * width, 4):
                acc = fma32(rk[..., c], g[..., c], acc)
                accb = fma32(ru[..., c], kc[..., ti, c], accb)
            pair.append(acc)
            bonus.append(accb)
        pair = (pair[0] + pair[1]) + (pair[2] + pair[3])
        bonus = (bonus[0] + bonus[1]) + (bonus[2] + bonus[3])
        pairs = pair if pairs is None else pairs + pair
        bonuses = bonus if bonuses is None else bonuses + bonus
    return torch.where(tri, pairs, 0.0), bonuses


def rwkv6_scan_split_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         logw: torch.Tensor, u: torch.Tensor, q: int,
                         one_tf32: bool = False, ref_point: str = "sub_chunk",
                         parts: bool = False):
    """K6's arithmetic on the CPU (csrc/rwkv6_scan.cu): the chunk-parallel
    form with the per-channel gate recentred at 16-step sub-chunks, every
    matrix product on split TF32, in float32.

    Each chunk of ``q`` steps is padded with zero steps (logw 0, r, k, v
    0) to a multiple of 16, P steps, in sub-chunks of 16; ``cum`` is
    ``rwkv6_chunk_cumsum``, ``cm1`` its exclusive form (``cum_{t-1}``,
    0 at step 0), ``cQ`` the chunk's last. The state launch: ``K^ = k
    exp(cQ - cum)``, ``U = K^T v``, the state pass ``state = fmaf(state,
    exp(cQ), U)`` row by row (``chunk_state_pass``). The output launch:
    ``A[t, s]`` for s < t, in blocks of sub-chunks (i, j):

    * j < i on the tensor cores, ``A_ij = R~ K~^T`` with ``R~ = r exp(cm1
      - e_j)`` and ``K~ = k exp(e_j - cum)``, ``e_j`` the cumsum at the
      last step of sub-chunk j (``ref_point="chunk_end"`` puts the
      reference at the chunk's end, the Pallas docstring's form, whose
      first factor overflows under fast decay; it moves ``e'`` below
      too);
    * j = i: its lower-left quadrant (steps 8..15 against 0..7) the same
      way on the tensor cores, recentred at ``e'``, the cumsum at the
      sub-chunk's step 7; its two 8-step triangles exactly, ``sum_c
      fmaf(r k, exp(cm1_t - cum_s), acc)`` over channels c = 4 m + p, m
      ascending, into four sums (p = 0..3) added as ``(a_0 + a_1) + (a_2
      + a_3)``; the diagonal the bonus ``sum_c fmaf(r u, k, acc)`` in the
      same order;

    then ``y = (r exp(cm1)) S_in + A v``, one accumulator, the carry-in's
    k-steps first. Each product's TF32 terms and their order are
    ``_tf32_terms``' (v exact when bfloat16); ``one_tf32`` keeps only the
    big halves. Returns ``(y, state)`` as ``rwkv6_scan_state`` does, and
    with ``parts`` also a dict of ``cum``, ``U``, the entering states, A
    and ``max_exponent``, the largest argument any exp takes."""
    bt, h, s, dh = r.shape
    nc = s // q
    P = 16 * -(-q // 16)
    exact = v.dtype == torch.bfloat16

    def chunks(t):
        t = t.float().reshape(bt, h, nc, q, dh)
        return torch.cat([t, t.new_zeros((bt, h, nc, P - q, dh))], dim=3)

    rc, kc, vc = chunks(r), chunks(k), chunks(v)
    cum = rwkv6_chunk_cumsum(logw, q, P)
    cm1 = torch.cat([torch.zeros_like(cum[..., :1, :]), cum[..., :-1, :]], dim=3)
    cQ = cum[..., -1, :]
    exps = []

    def gate(x):
        exps.append(x.max())
        return torch.exp(x)

    # the state launch
    kh = kc * gate(cQ[..., None, :] - cum)
    U = _mma_sum(_tf32_terms(kh.transpose(-1, -2), vc, False, exact, one_tf32))
    entering, state = chunk_state_pass(U, gate(cQ))
    # the output launch: A by blocks of 16-step sub-chunks
    A = torch.zeros((bt, h, nc, P, P), dtype=torch.float32)
    uf = u.float()[None, :, None, None, :]
    for i in range(P // 16):
        ti = slice(16 * i, 16 * i + 16)
        for j in range(i):
            tj = slice(16 * j, 16 * j + 16)
            e = cQ if ref_point == "chunk_end" else cum[..., 16 * j + 15, :]
            rt = rc[..., ti, :] * gate(cm1[..., ti, :] - e[..., None, :])
            kt = kc[..., tj, :] * gate(e[..., None, :] - cum[..., tj, :])
            A[..., ti, tj] = _mma_sum(_tf32_terms(rt, kt.transpose(-1, -2), False, False,
                                                  one_tf32))
        blk, bonus = _rwkv6_diag_pairs(rc, kc, cm1, cum, uf, i, exps)
        e = cQ if ref_point == "chunk_end" else cum[..., 16 * i + 7, :]
        lo, hi = slice(16 * i, 16 * i + 8), slice(16 * i + 8, 16 * i + 16)
        rt = rc[..., hi, :] * gate(cm1[..., hi, :] - e[..., None, :])
        kt = kc[..., lo, :] * gate(e[..., None, :] - cum[..., lo, :])
        blk[..., 8:, :8] = _mma_sum(_tf32_terms(rt, kt.transpose(-1, -2), False, False,
                                                one_tf32))
        A[..., ti, ti] = blk + torch.diag_embed(bonus)
    rh = rc * gate(cm1)
    y = _mma_sum(_tf32_terms(rh, entering, False, False, one_tf32))
    y = _mma_sum(_tf32_terms(A, vc, False, exact, one_tf32), acc=y)
    y = y[..., :q, :].reshape(bt, h, s, dh)
    if parts:
        return y, state, dict(cum=cum, U=U, entering=entering, A=A,
                              max_exponent=float(torch.stack(exps).max()))
    return y, state


def reverse_cumsum32(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The reverse inclusive cumsum of ``x`` along ``dim``, added from the
    last entry down in float32, one rounding an add (PyTorch's CPU
    ``cumsum`` accumulates in float64)."""
    x = x.movedim(dim, -1)
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[..., 0])
    for j in reversed(range(x.shape[-1])):
        acc = acc + x[..., j]
        out[..., j] = acc
    return out.movedim(-1, dim)


def ssm_scan_bwd_split_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                           B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                           dstate: torch.Tensor | None, q: int, one_tf32: bool = False):
    """K5''s arithmetic on the CPU (csrc/ssm_scan_bwd.cu): ``(dx, ddt, dA,
    dB, dC)`` for y's gradient ``dy`` and the final state's ``dstate``
    (None: zero), every matrix product on split TF32, in float32.

    The forward's scratch (``cum``, the entering states) is
    ``ssm_scan_split_ref``'s. The reverse pass: ``U = (dy exp(cum))^T C``,
    ``dS = fmaf(dS, exp(cum_Q), U)`` over the chunks in reverse order. Per
    chunk and head, in the kernel's order: (a) the carry-in ``Cr =
    exp(cum_t) (dy S_in)``, added to the head group's dC; (b) dx's start
    ``wdt_s (B dS^T)`` (``wdt = exp(cum_Q - cum) dt``), ``Y = x dS``, ``P =
    B . Y``, ``dB = fmaf(wdt, Y, dB)``; (c) ``M^T = x dy^T``, ``C B^T`` once
    a group, the gated tiles ``G^T = (B C^T) E^T dt_s``, ``Ml^T = M^T E^T
    dt_s``, ``Z^T = M^T (B C^T) E^T``, ``dx += G^T dy``, ``dB += Ml^T C``;
    (d) ``dC += Ml B``. dB and dC sum over the ``HEAD_GROUP`` heads of a
    CTA in ascending order, then over the groups in order (the fold). Each
    product's TF32 terms and their order are ``_tf32_terms``' (x, B, C
    exact when bfloat16); ``one_tf32`` keeps only the big halves. The
    scalar sums (Z's row and column sums, P, the reverse cumsum of dcum)
    are float32 sums whose order the kernel's shuffle trees set and this
    emulation does not follow (the reverse cumsum runs from the chunk's
    end, ``reverse_cumsum32``)."""
    bt, s, h, dh = x.shape
    n = B.shape[-1]
    nc = s // q
    exact, one = x.dtype == torch.bfloat16, one_tf32
    _, _, fwd = ssm_scan_split_ref(x, dt, A, B, C, q, parts=True)
    cum, s_in = fwd["cum"], fwd["entering"]                             # the forward's scratch
    xc = x.float().reshape(bt, nc, q, h, dh).permute(0, 3, 1, 2, 4)     # (Bt, H, nc, q, dh)
    dyc = dy.float().reshape(bt, nc, q, h, dh).permute(0, 3, 1, 2, 4)
    Bc = B.float().reshape(bt, 1, nc, q, n)
    Cc = C.float().reshape(bt, 1, nc, q, n)
    dtc = dt.float().permute(0, 2, 1).reshape(bt, h, nc, q)
    Bh, Ch = Bc.expand(bt, h, nc, q, n), Cc.expand(bt, h, nc, q, n)
    # the reverse pass: the gradient of the state leaving each chunk
    e = torch.exp(cum)
    U = _mma_sum(_tf32_terms((dyc * e[..., None]).transpose(-1, -2), Ch, False, exact, one))
    ds = torch.zeros((bt, h, dh, n)) if dstate is None else dstate.float().clone()
    leaving = [ds] * nc
    for c in reversed(range(nc)):
        leaving[c] = ds
        ds = fma32(ds, torch.exp(cum[:, :, c, -1])[..., None, None].expand_as(ds), U[:, :, c])
    so = torch.stack(leaving, dim=2)                                    # (Bt, H, nc, dh, n)
    w = torch.exp(cum[..., -1:] - cum)
    wdt = w * dtc
    # (a) rows t: the carry-in
    cr = e[..., None] * _mma_sum(_tf32_terms(dyc, s_in, False, False, one))
    cc = (Ch * cr).sum(-1)
    dot = (so * s_in).sum((-1, -2))
    # (b) rows s: dx's state term, Y and P
    dx = _mma_sum(_tf32_terms(Bh, so.transpose(-1, -2), exact, False, one)) * wdt[..., None]
    Y = _mma_sum(_tf32_terms(xc, so, exact, False, one))
    P = (Bh * Y).sum(-1)
    # (c) rows s: the gated tiles, columns t >= s
    MT = _mma_sum(_tf32_terms(xc, dyc.transpose(-1, -2), exact, False, one))
    CBT = _mma_sum(_tf32_terms(Bc, Cc.transpose(-1, -2), exact, exact, one))
    up = torch.arange(q)[:, None] <= torch.arange(q)[None, :]
    diff = cum[..., None, :] - cum[..., :, None]                        # [s, t]: cum_t - cum_s
    ET = torch.where(up, torch.exp(torch.where(up, diff, 0.0)), torch.zeros(()))
    dts = dtc[..., :, None]
    GT, MlT, ZT = CBT * ET * dts, MT * ET * dts, MT * CBT * ET
    zs, row = ZT.sum(-1), (ZT * dts).sum(-2)
    dx = _mma_sum(_tf32_terms(GT, dyc, False, False, one), acc=dx)
    # dB and dC: the heads of a group in order in one accumulator, then the groups
    dB = dC = None
    for g0 in range(0, h, HEAD_GROUP):
        accB = torch.zeros((bt, nc, q, n))
        accC = torch.zeros((bt, nc, q, n))
        for hh in range(g0, min(h, g0 + HEAD_GROUP)):
            accC = accC + cr[:, hh]
            accB = fma32(wdt[:, hh, ..., None].expand_as(accB), Y[:, hh], accB)
            accB = _mma_sum(_tf32_terms(MlT[:, hh], Cc[:, 0], False, exact, one), acc=accB)
            accC = _mma_sum(_tf32_terms(MlT[:, hh].transpose(-1, -2), Bc[:, 0], False, exact,
                                        one), acc=accC)
        dB = accB if dB is None else dB + accB
        dC = accC if dC is None else dC + accC
    # ddt, dA: dcum, the chunk-end terms and the reverse cumsum
    dcum = (row - dtc * zs) + cc - wdt * P
    end = torch.exp(cum[..., -1]) * dot + (wdt * P).sum(-1)
    dcum = torch.cat([dcum[..., :-1], dcum[..., -1:] + end[..., None]], dim=-1)
    dda = reverse_cumsum32(dcum, -1)
    a = A.float()[None, :, None, None].expand_as(dda)
    ddt = fma32(a, dda, fma32(w, P, zs))
    dA = (dtc * dda).sum((0, 2, 3))
    return (dx.permute(0, 2, 3, 1, 4).reshape(bt, s, h, dh).to(x.dtype),
            ddt.permute(0, 2, 3, 1).reshape(bt, s, h), dA,
            dB.reshape(bt, s, n).to(B.dtype), dC.reshape(bt, s, n).to(C.dtype))


def rwkv6_scan_bwd_split_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             logw: torch.Tensor, u: torch.Tensor, dy: torch.Tensor,
                             dstate: torch.Tensor | None, q: int, one_tf32: bool = False,
                             parts: bool = False):
    """K6''s arithmetic on the CPU (csrc/rwkv6_scan_bwd.cu): ``(dr, dk, dv,
    dlogw, du)`` for y's gradient ``dy`` and the final state's ``dstate``
    (None: zero), the gate at 16-step sub-chunk reference points, every
    matrix product on split TF32, in float32.

    Chunks are padded to P steps as in ``rwkv6_scan_split_ref``, whose
    entering and final states stand for the forward's scratch; ``e_j`` is
    the cumsum at sub-chunk j's last step. The reverse pass: ``U = (r
    exp(cm1))^T dy``, ``dS = fmaf(dS, exp(cQ), U)`` row by row, chunks in
    reverse order. Phase 1: ``dA = dy v^T``; ``drg = exp(cm1) (dy
    S_in^T)``, then for each block j < i in order ``drg = fmaf(exp(cm1_t -
    e_j), dA_ij K~_j, drg)`` (``K~_j = k exp(e_j - cum)``), then sub-chunk
    i's quadrant (steps 8..15 against 0..7) the same way recentred at e',
    the cumsum at its step 7; ``dkg`` from 0 by its blocks i > j in order,
    ``fmaf(exp(e_{i-1} - cum_s), dA_ij^T R~_i, dkg)`` (``R~_i = r exp(cm1
    - e_{i-1})``), then j's quadrant at e'; then the pairs of the 8-step
    triangles, ``fmaf(dA k, exp(cm1_t - cum_s), drg)`` s ascending and
    ``fmaf(dA r, exp(cm1_t - cum_s), dkg)`` t ascending. Phase 2: A^T as
    the forward forms A (blocks ``K~ R~^T``, ``R~ = r exp(cm1 - e_j)``;
    the diagonal block's quadrant at e' and its exact pairs,
    ``_rwkv6_diag_pairs`` over two channel halves); ``dv = K^ dS`` then
    ``+ A^T dy``; ``dkg =
    fmaf(exp(cQ - cum), v dS^T, dkg)``. Each
    product's TF32 terms and their order are ``_tf32_terms``' (v exact
    when bfloat16); ``one_tf32`` keeps only the big halves. du is a float32
    sum; dcum's reverse cumsum runs in time order, as the kernel's
    (``reverse_cumsum32``). With ``parts``, also a dict with
    ``max_exponent``, the largest argument any exp takes."""
    bt, h, s, dh = r.shape
    nc = s // q
    P = 16 * -(-q // 16)
    nsub = P // 16
    exact, one = v.dtype == torch.bfloat16, one_tf32
    _, final, fwd = rwkv6_scan_split_ref(r, k, v, logw, u, q, parts=True)
    s_in = fwd["entering"]
    s_out = torch.cat([s_in[:, :, 1:], final[:, :, None]], dim=2)

    def chunks(t):
        t = t.float().reshape(bt, h, nc, q, dh)
        return torch.cat([t, t.new_zeros((bt, h, nc, P - q, dh))], dim=3)

    rc, kc, vc, dyc = chunks(r), chunks(k), chunks(v), chunks(dy)
    cum = rwkv6_chunk_cumsum(logw, q, P)
    cm1 = torch.cat([torch.zeros_like(cum[..., :1, :]), cum[..., :-1, :]], dim=3)
    cQ = cum[..., -1, :]
    uf = u.float()[None, :, None, None, :]
    exps = []

    def gate(x):
        exps.append(x.max())
        return torch.exp(x)

    def sub(i):
        return slice(16 * i, 16 * i + 16)

    # the reverse pass
    U = _mma_sum(_tf32_terms((rc * gate(cm1)).transpose(-1, -2), dyc, False, False, one))
    ds = torch.zeros((bt, h, dh, dh)) if dstate is None else dstate.float().clone()
    leaving = [ds] * nc
    for c in reversed(range(nc)):
        leaving[c] = ds
        ds = fma32(ds, gate(cQ[:, :, c])[..., None].expand_as(ds), U[:, :, c])
    so = torch.stack(leaving, dim=2)                                    # (Bt, H, nc, dh, dh)
    # phase 1: dA; drg and dkg's gated sums over it
    dA = _mma_sum(_tf32_terms(dyc, vc.transpose(-1, -2), False, exact, one))
    drg = gate(cm1) * _mma_sum(_tf32_terms(dyc, s_in.transpose(-1, -2), False, False, one))
    dkg = torch.zeros_like(drg)
    steps = torch.arange(8)
    for i in range(nsub):
        ti = sub(i)
        for j in range(i):                       # drg's blocks j < i
            e = cum[..., 16 * j + 15, None, :]
            kt = kc[..., sub(j), :] * gate(e - cum[..., sub(j), :])
            acc = _mma_sum(_tf32_terms(dA[..., ti, sub(j)], kt, False, False, one))
            drg[..., ti, :] = fma32(gate(cm1[..., ti, :] - e), acc, drg[..., ti, :])
        lo, hi = slice(16 * i, 16 * i + 8), slice(16 * i + 8, 16 * i + 16)
        ep = cum[..., 16 * i + 7, None, :]
        kq = kc[..., lo, :] * gate(ep - cum[..., lo, :])
        acc = _mma_sum(_tf32_terms(dA[..., hi, lo], kq, False, False, one))
        drg[..., hi, :] = fma32(gate(cm1[..., hi, :] - ep), acc, drg[..., hi, :])
    for j in range(nsub):
        tj = sub(j)
        for i in range(j + 1, nsub):             # dkg's blocks i > j
            e = cum[..., 16 * i - 1, None, :]
            rt = rc[..., sub(i), :] * gate(cm1[..., sub(i), :] - e)
            acc = _mma_sum(_tf32_terms(dA[..., sub(i), tj].transpose(-1, -2), rt, False, False,
                                       one))
            dkg[..., tj, :] = fma32(gate(e - cum[..., tj, :]), acc, dkg[..., tj, :])
        lo, hi = slice(16 * j, 16 * j + 8), slice(16 * j + 8, 16 * j + 16)
        ep = cum[..., 16 * j + 7, None, :]
        rq = rc[..., hi, :] * gate(cm1[..., hi, :] - ep)
        acc = _mma_sum(_tf32_terms(dA[..., hi, lo].transpose(-1, -2), rq, False, False, one))
        dkg[..., lo, :] = fma32(gate(ep - cum[..., lo, :]), acc, dkg[..., lo, :])
    for i in range(nsub):                        # the 8-step triangles, a pair at a time
        for o in (16 * i, 16 * i + 8):
            run = slice(o, o + 8)
            for x in range(7):
                later = (steps > x)[:, None]     # drg: rows t > s = o + x
                arg = cm1[..., run, :] - cum[..., o + x, None, :]
                exps.append(arg[..., steps > x, :].max())
                term = dA[..., run, o + x, None] * kc[..., o + x, None, :]
                drg[..., run, :] = torch.where(
                    later, fma32(term, torch.exp(torch.where(later, arg, 0.0)), drg[..., run, :]),
                    drg[..., run, :])
                earlier = (steps < x + 1)[:, None]   # dkg: rows s < t = o + x + 1
                arg = cm1[..., o + x + 1, None, :] - cum[..., run, :]
                exps.append(arg[..., steps < x + 1, :].max())
                term = dA[..., o + x + 1, run, None] * rc[..., o + x + 1, None, :]
                dkg[..., run, :] = torch.where(
                    earlier, fma32(term, torch.exp(torch.where(earlier, arg, 0.0)),
                                   dkg[..., run, :]), dkg[..., run, :])
    db = torch.diagonal(dA, dim1=-2, dim2=-1)[..., None]
    dr = fma32(db * uf, kc, drg)
    rdrg = rc * drg
    # phase 2: A^T, dv, dkg's state term
    AT = torch.zeros((bt, h, nc, P, P))
    for j in range(nsub):
        e = cum[..., 16 * j + 15, None, :]
        kt = kc[..., sub(j), :] * gate(e - cum[..., sub(j), :])
        for i in range(j + 1, nsub):
            rt = rc[..., sub(i), :] * gate(cm1[..., sub(i), :] - e)
            AT[..., sub(j), sub(i)] = _mma_sum(_tf32_terms(kt, rt.transpose(-1, -2), False,
                                                           False, one))
        blk, bonus = _rwkv6_diag_pairs(rc, kc, cm1, cum, uf, j, exps, halves=2)
        blk = blk.transpose(-1, -2) + torch.diag_embed(bonus)
        ep = cum[..., 16 * j + 7, None, :]
        lo, hi = slice(16 * j, 16 * j + 8), slice(16 * j + 8, 16 * j + 16)
        kq = kc[..., lo, :] * gate(ep - cum[..., lo, :])
        rq = rc[..., hi, :] * gate(cm1[..., hi, :] - ep)
        blk[..., :8, 8:] = _mma_sum(_tf32_terms(kq, rq.transpose(-1, -2), False, False, one))
        AT[..., sub(j), sub(j)] = blk
    dv = _mma_sum(_tf32_terms(kc * gate(cQ[..., None, :] - cum), so, False, False, one))
    dv = _mma_sum(_tf32_terms(AT, dyc, False, False, one), acc=dv)
    dkg = fma32(gate(cQ[..., None, :] - cum),
                _mma_sum(_tf32_terms(vc, so.transpose(-1, -2), exact, False, one)), dkg)
    dk = fma32(db * uf, rc, dkg)
    kdkg = kc * dkg
    # du, dcum and its reverse cumsum over the real steps
    du = (db * rc * kc)[..., :q, :].sum((0, 2, 3))
    end = (so * s_out).sum(-1)
    dcum = torch.cat([rdrg[..., 1:q, :], torch.zeros_like(rdrg[..., :1, :])], dim=3) \
        - kdkg[..., :q, :]
    dcum = torch.cat([dcum[..., :-1, :], dcum[..., -1:, :] + end[..., None, :]], dim=3)
    dlogw = reverse_cumsum32(dcum, 3)

    def steps_of(t):
        return t[..., :q, :].reshape(bt, h, s, dh)

    out = (steps_of(dr).to(r.dtype), steps_of(dk).to(k.dtype), steps_of(dv).to(v.dtype),
           steps_of(dlogw), du)
    if parts:
        return (*out, dict(max_exponent=float(torch.stack(exps).max())))
    return out


def user_bias_ref(R: torch.Tensor, vectors: bool | None = None) -> torch.Tensor:
    """The walker's ``user_bias`` row means in its own order of additions,
    in float32 (csrc/dag_walk.cu: Recommendation): lane l of a warp adds
    its columns c = 4 (l + 32 k) + e (16-byte vectors; ``vectors``, the
    default when n_items % 4 == 0) or c = l + 32 k (scalars), k and e
    ascending, into one accumulator; an xor tree over lane offsets 16, 8,
    4, 2, 1 adds the lanes; the sum is divided by n_items. Columns past
    the row add zeros, which leave a sum unchanged."""
    n, m = R.shape
    if vectors is None:
        vectors = m % 4 == 0
    width = 128 if vectors else 32
    Rp = torch.zeros((n, -(-m // width) * width), dtype=torch.float32)
    Rp[:, :m] = R.float().cpu()
    Rp = Rp.view(n, -1, 32, 4) if vectors else Rp.view(n, -1, 32, 1)
    s = torch.zeros((n, 32), dtype=torch.float32)
    for k in range(Rp.shape[1]):
        for e in range(Rp.shape[3]):
            s = s + Rp[:, k, :, e]
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        s = s + s[:, lanes ^ off]
    return (s[:, 0] / m).to(R.device)
