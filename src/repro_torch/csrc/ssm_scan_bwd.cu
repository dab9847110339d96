// The gradient of the Mamba2 SSD chunked scan (K5'): dx, ddt, dA, dB, dC
// from dy and the final state's gradient.
//
// Replaces no Pallas kernel: the Pallas kernel repro/kernels/ssm_scan.py:
// ssm_scan has no backward, and the reference trains through
// jax.value_and_grad of its plain chunk recurrence
// (repro/models/ssm.py:116 chunk_step, under jax.checkpoint at :141).
// This is that gradient for K5's function (csrc/ssm_scan.cu), per chunk
// of Q steps of a (batch, head), with cum the inclusive cumsum of dt a
// (a = A[h]), E[t,s] = exp(cum_t - cum_s) for s <= t, w_s = exp(cum_Q -
// cum_s), S_in the state entering the chunk and dS the gradient of the
// state leaving it:
//   dS entering chunk c  = exp(cum_Q) dS + sum_t exp(cum_t) dy_t C_t^T;
//   dx_s  = sum_{t>=s} G[t,s] dy_t + w_s dt_s dS B_s,
//           G[t,s] = (C_t . B_s) E[t,s] dt_s;
//   dC_t  = sum_{s<=t} Ml[t,s] B_s + exp(cum_t) S_in^T dy_t,
//   dB_s  = sum_{t>=s} Ml[t,s] C_t + w_s dt_s Y_s,
//           Ml[t,s] = (dy_t . x_s) E[t,s] dt_s, Y_s = dS^T x_s;
//   ddt_s = sum_{t>=s} Z[t,s] + w_s P_s + a dda_s,
//           Z[t,s] = (dy_t . x_s)(C_t . B_s) E[t,s], P_s = B_s . Y_s;
//   dcum_j = sum_{s<=j} Z[j,s] dt_s - dt_j sum_{t>=j} Z[t,j]
//            + C_j . (exp(cum_j) S_in^T dy_j) - w_j dt_j P_j,
//            and at the chunk's last step also exp(cum_Q) <dS, S_in>
//            + sum_s w_s dt_s P_s;
//   dda   = the reverse cumsum of dcum within the chunk (the gradient of
//           dt a), dA = sum over (batch, step) of dt dda.
// kernels/ssm_scan.py:ssm_scan_bwd_plain is the plain version of the same
// recurrences.
//
// Bound on an H100 (NVIDIA's data sheet: 3.35 TB/s, 495 TFLOP/s TF32):
// at Zamba2-7B's training shape (4 x 2,048 steps x 112 heads, dh = N = 64,
// bf16 x, B, C) the function reads x, dt, B, C and dy and writes dx, ddt,
// dB, dC (about 480 MB, 0.14 ms); its products as split TF32 take a
// little longer, 0.19 ms (chip_smoke.py reckons both and states which one
// binds).
//
// Design: three launches, no atomics and no grid barrier, so two calls
// give the same bits; the wrapper counts the call once.
//   ssm_bwd_states, one CTA of 4 warps per (batch, head), the mirror of
//     K5's ssm_states: the chunks in reverse order, each one's dy rows, C
//     and cumsum staged by cp.async while the one after computes; dS
//     written to scratch before the chunk's term is added; the term U =
//     (dy exp(cum))^T C on the tensor cores (rows d, k = t), and dS =
//     fmaf(dS, exp(cum_Q), U) in registers, one rounding, as ssm_states.
//   ssm_bwd_chunks, one CTA of 4 warps per (chunk, batch, group of 8
//     heads), as K5's ssm_outputs: C and B staged once for the group in
//     their own type (bf16 tiles of 144 bytes a row) and C B^T formed once
//     on the tensor cores; then per head, with x, dy, S_in and dS staged
//     (each head's S_in, dS and x, dy loaded by cp.async as soon as the
//     head before is done with that tile):
//       (a) rows t: the carry-in Cr = exp(cum_t) (dy S_in) (k = d), added
//           to the group's dC, and C_t . Cr_t;
//       (b) rows s: dx's state term wdt_s (B dS^T) (k = n), Y = x dS
//           (k = d), P_s = B_s . Y_s, dB += wdt_s Y;
//       (c) rows s: M^T = x dy^T (k = d) on the tensor cores, and in its
//           registers G^T, Ml^T and Z^T (as ssm_outputs keeps G from C B^T
//           to G x): dx += G^T dy and dB += Ml^T C (k = t), Ml^T written
//           to shared memory, Z^T's row sums and dt-weighted column sums
//           by warp shuffles in a fixed order;
//       (d) rows t: dC += Ml B (k = s, Ml read transposed from shared
//           memory); then one warp runs the head's tail: dcum, its
//           reverse cumsum by a shuffle scan of fixed order, ddt, and the
//           chunk's part of dA.
//     Warp w owns rows 16 w..16 w + 15 in both orientations; dB (rows s)
//     and dC (rows t) are summed over the group's heads in registers, the
//     heads in ascending order, and written once a group.
//   ssm_bwd_fold: dB and dC summed over the H / 8 head groups in order,
//     dA over (batch, chunk) in order.
// Products: split TF32 on mma.sync (tf32_mma.cuh gives the order of the
// TF32 products); x, B and C exact when bf16, dy, the states and the
// gated tiles split. kernels/ref.py:ssm_scan_bwd_split_ref emulates this
// order on the CPU. 100 KB of shared memory in bf16: two CTAs an SM.

#include "tf32_mma.cuh"

namespace {

constexpr int DH = 64, N = 64, QMAX = 64, THREADS = 128, HG = 8, FOLD_THREADS = 256;
// fp32 tile pitches in floats, multiples of 16 bytes for cp.async: dy and
// Ml^T are read as A fragments with rows by g (68, distinct banks); the
// states as B fragments with k by t (72). The states kernel reads dy as A
// with k by t (72).
constexpr int LDY = 68, LDS = 72, LDYS = 72;
// Row pitch of a staged x, B or C tile in elements: 144 bytes in bf16,
// 272 in fp32.
template <class T> constexpr int kPitch = std::is_same<T, float>::value ? 68 : 72;

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* cum;          // the forward's scratch (Bt, H, S)
  const float* chunk_state;  // the forward's scratch (Bt, H, nc, DH, N): state entering chunk c
  const float* dy;           // (Bt, S, H, DH), strides ys, last axis contiguous
  const float* dstate;       // (Bt, H, DH, N) contiguous, or null (zero)
  float* ds;                 // scratch (Bt, H, nc, DH, N): gradient of the state leaving chunk c
  float* dBg;                // scratch (Bt, ng, S, N): each head group's share of dB
  float* dCg;                // scratch (Bt, ng, S, N)
  float* dApart;             // scratch (Bt, H, nc)
  void* dx;                  // contiguous (Bt, S, H, DH), x's type
  float* ddt;                // contiguous (Bt, S, H)
  float* dA;                 // (H,)
  void* dB;                  // contiguous (Bt, S, N), B's type
  void* dC;
  long long xs[3], ds_[3], bs[2], cs[2], ys[3];
  int Bt, H, S, Q, nc, ng;
  int vec;   // x, B and C rows start on 16 bytes: 16-byte cp.async
  int yvec;  // dy rows start on 16 bytes
};

// ------------------------------------------------------- reverse dS pass

template <class T>
struct StatesSmem {
  float DY[2][QMAX * LDYS];
  T Cm[2][QMAX * kPitch<T>];
  float cum[2][QMAX];
  float e[QMAX];  // exp(cum_t), 0 past Q
};

template <class T>
__global__ void __launch_bounds__(THREADS, 3) ssm_bwd_states(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<StatesSmem<T>*>(smem_raw);
  constexpr int LD = kPitch<T>;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H, tid = threadIdx.x;
  const int Q = p.Q, nc = p.nc;
  const T* Cg = static_cast<const T*>(p.C) + b * p.cs[0];
  const float* dyg = p.dy + b * p.ys[0] + h * p.ys[2];
  const float* cumg = p.cum + (long long)bh * p.S;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int d0 = 16 * warp + g, d1 = d0 + 8;  // this thread's rows of dS
  const int ksteps = (Q + 7) / 8;

  for (int i = 0; i < 2; ++i) {  // rows past Q: 0 (cp.async writes rows below Q)
    zero_tile_rows<float, THREADS>(sm.DY[i], LDYS, Q, QMAX);
    zero_tile_rows<T, THREADS>(sm.Cm[i], LD, Q, QMAX);
  }
  auto stage = [&](int c, int buf) {
    const long long s0 = (long long)c * Q;
    stage_tile<float, THREADS>(sm.DY[buf], LDYS, dyg + s0 * p.ys[1], p.ys[1], Q, DH, p.yvec);
    stage_tile<T, THREADS>(sm.Cm[buf], LD, Cg + s0 * p.cs[1], p.cs[1], Q, N, p.vec);
    if (tid < Q) cp4(&sm.cum[buf][tid], cumg + s0 + tid);
  };

  float st[8][4];
  const float* dst = p.dstate ? p.dstate + (long long)bh * DH * N : nullptr;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = 8 * j + 2 * t4;
    st[j][0] = dst ? dst[d0 * N + n] : 0.f;
    st[j][1] = dst ? dst[d0 * N + n + 1] : 0.f;
    st[j][2] = dst ? dst[d1 * N + n] : 0.f;
    st[j][3] = dst ? dst[d1 * N + n + 1] : 0.f;
  }
  float* ds = p.ds + (long long)bh * nc * DH * N;

  stage(nc - 1, 0);
  cp_commit();
  for (int c = nc - 1; c >= 0; --c) {
    const int buf = (nc - 1 - c) & 1;
    cp_wait<0>();
    __syncthreads();  // chunk c staged; every warp is done with chunk c + 1
    if (c > 0) stage(c - 1, buf ^ 1);
    cp_commit();
    if (tid < QMAX) sm.e[tid] = tid < Q ? expf(sm.cum[buf][tid]) : 0.f;
    __syncthreads();
    const float decay = expf(sm.cum[buf][Q - 1]);
    const float* DY = sm.DY[buf];
    const T* Cm = sm.Cm[buf];

    // U = (dy exp(cum))^T C: rows d, columns n, k = t
    float u[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) u[j][i] = 0.f;
    for (int ks = 0; ks < ksteps; ++ks) {
      const int t0 = 8 * ks + t4, t1 = t0 + 4;
      const float e0 = sm.e[t0], e1 = sm.e[t1];
      const FragA fa = frag_a<false>(DY[t0 * LDYS + d0] * e0, DY[t0 * LDYS + d1] * e0,
                                     DY[t1 * LDYS + d0] * e1, DY[t1 * LDYS + d1] * e1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mma_step<false, kExact<T>>(u[j], fa, to_f(Cm[t0 * LD + 8 * j + g]),
                                   to_f(Cm[t1 * LD + 8 * j + g]));
    }
    float* out = ds + (long long)c * DH * N;  // the gradient of the state leaving chunk c
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = 8 * j + 2 * t4;
      store2(out + d0 * N + n, st[j][0], st[j][1]);
      store2(out + d1 * N + n, st[j][2], st[j][3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) st[j][i] = fmaf(st[j][i], decay, u[j][i]);
    }
  }
}

// ------------------------------------------------------- every chunk

template <class T>
struct ChunkSmem {
  T Cm[QMAX * kPitch<T>], Bm[QMAX * kPitch<T>];  // the group's C and B
  T X[QMAX * kPitch<T>];                         // this head's x
  float DY[QMAX * LDY];                          // this head's dy
  float Si[DH * LDS], So[DH * LDS];              // S_in and dS, [d][n]
  float MlT[QMAX * LDY];                         // Ml^T, [s][t]
  float cum[2][QMAX], dt[2][QMAX];               // this head's and the next one's
  float zs[QMAX], P[QMAX], cc[QMAX];             // per step: sum_t Z[t,s], P_s, C_t . Cr_t
  float colz[4][QMAX];                           // per warp: sum over its rows s of Z[t,s] dt_s
  float red[4];                                  // per warp: its share of <dS, S_in>
};

template <class T>
__global__ void __launch_bounds__(THREADS, 2) ssm_bwd_chunks(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<ChunkSmem<T>*>(smem_raw);
  constexpr int LD = kPitch<T>;
  constexpr bool CX = kExact<T>;
  const int c = blockIdx.x, b = blockIdx.y, grp = blockIdx.z, h0 = grp * HG, tid = threadIdx.x;
  const int Q = p.Q, nh = min(HG, p.H - h0);
  const long long s0 = (long long)c * Q;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int r0 = 16 * warp + g, r1 = r0 + 8;  // this thread's rows (s or t)
  const bool active = 16 * warp < Q;
  const int jmin = 2 * warp, jlast = (Q - 1) / 8;  // rows s: the column tiles t >= s reaches
  const int kmax = min(2 * warp + 1, jlast);       // rows t: the k tiles s <= t reaches
  const T* Bg = static_cast<const T*>(p.B) + b * p.bs[0] + s0 * p.bs[1];
  const T* Cg = static_cast<const T*>(p.C) + b * p.cs[0] + s0 * p.cs[1];

  zero_tile_rows<T, THREADS>(sm.Cm, LD, Q, QMAX);
  zero_tile_rows<T, THREADS>(sm.Bm, LD, Q, QMAX);
  zero_tile_rows<T, THREADS>(sm.X, LD, Q, QMAX);
  zero_tile_rows<float, THREADS>(sm.DY, LDY, Q, QMAX);
  zero_tile_rows<float, THREADS>(sm.MlT, LDY, 0, QMAX);
  if (tid < QMAX - Q)
    for (int i = 0; i < 2; ++i) sm.cum[i][Q + tid] = sm.dt[i][Q + tid] = 0.f;

  auto head = [&](int hi) { return (long long)b * p.H + h0 + hi; };
  auto stage_x_dy = [&](int hi, int buf) {
    const int h = h0 + hi;
    stage_tile<T, THREADS>(sm.X, LD, static_cast<const T*>(p.x) + b * p.xs[0] + h * p.xs[2] +
                                         s0 * p.xs[1], p.xs[1], Q, DH, p.vec);
    stage_tile<float, THREADS>(sm.DY, LDY, p.dy + b * p.ys[0] + h * p.ys[2] + s0 * p.ys[1],
                               p.ys[1], Q, DH, p.yvec);
    if (tid < Q) {
      cp4(&sm.dt[buf][tid], p.dt + b * p.ds_[0] + h * p.ds_[2] + (s0 + tid) * p.ds_[1]);
      cp4(&sm.cum[buf][tid], p.cum + head(hi) * p.S + s0 + tid);
    }
  };
  auto stage_state = [&](float* dst, const float* src) {
    for (int e = tid; e < DH * N / 4; e += THREADS) {
      const int d = e / (N / 4), q4 = e % (N / 4);
      cp16(dst + d * LDS + 4 * q4, src + d * N + 4 * q4);
    }
  };
  auto stage_si = [&](int hi) {
    if (c > 0) stage_state(sm.Si, p.chunk_state + (head(hi) * p.nc + c) * DH * N);
  };
  auto stage_so = [&](int hi) { stage_state(sm.So, p.ds + (head(hi) * p.nc + c) * DH * N); };

  stage_tile<T, THREADS>(sm.Cm, LD, Cg, p.cs[1], Q, N, p.vec);
  stage_tile<T, THREADS>(sm.Bm, LD, Bg, p.bs[1], Q, N, p.vec);
  stage_x_dy(0, 0);
  stage_si(0);
  stage_so(0);
  cp_commit();

  float cb[8][4];  // C B^T, rows s, columns t (kept for the group)
  float dB[8][4], dC[8][4];  // the group's dB (rows s) and dC (rows t), columns n
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) cb[j][i] = dB[j][i] = dC[j][i] = 0.f;

  for (int hi = 0; hi < nh; ++hi) {
    const int buf = hi & 1, h = h0 + hi;
    const long long bh = head(hi);
    cp_wait<0>();
    __syncthreads();  // head hi staged (with C and B for head 0); head hi - 1 done
    const float* cum = sm.cum[buf];
    const float* dts = sm.dt[buf];
    const T* X = sm.X;
    const float* DY = sm.DY;

    if (hi == 0 && active) {  // B C^T: rows s, columns t, k = n; once for the group
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const int n0 = 8 * ks + t4, n1 = n0 + 4;
        const FragA fb = frag_a<CX>(to_f(sm.Bm[r0 * LD + n0]), to_f(sm.Bm[r1 * LD + n0]),
                                    to_f(sm.Bm[r0 * LD + n1]), to_f(sm.Bm[r1 * LD + n1]));
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j >= jmin && j <= jlast)
            mma_step<CX, CX>(cb[j], fb, to_f(sm.Cm[(8 * j + g) * LD + n0]),
                             to_f(sm.Cm[(8 * j + g) * LD + n1]));
      }
    }

    // (a) rows t: the carry-in Cr = exp(cum_t) (dy S_in), k = d; dC += Cr;
    // C_t . Cr_t; and this thread's share of <dS, S_in>
    float dot = 0.f;
    if (c > 0) {
      if (active) {
        float cv[8][4];
#pragma unroll
        for (int m = 0; m < 8; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[m][i] = 0.f;
#pragma unroll 2
        for (int ks = 0; ks < 8; ++ks) {
          const int d0 = 8 * ks + t4, d1 = d0 + 4;
          const FragA fa = frag_a<false>(DY[r0 * LDY + d0], DY[r1 * LDY + d0],
                                         DY[r0 * LDY + d1], DY[r1 * LDY + d1]);
#pragma unroll
          for (int m = 0; m < 8; ++m)
            mma_step<false, false>(cv[m], fa, sm.Si[d0 * LDS + 8 * m + g],
                                   sm.Si[d1 * LDS + 8 * m + g]);
        }
        const float e0 = expf(cum[r0]), e1 = expf(cum[r1]);
        float c0 = 0.f, c1 = 0.f;
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int n = 8 * m + 2 * t4;
          const float a0 = e0 * cv[m][0], a1 = e0 * cv[m][1];
          const float a2 = e1 * cv[m][2], a3 = e1 * cv[m][3];
          dC[m][0] += a0;
          dC[m][1] += a1;
          dC[m][2] += a2;
          dC[m][3] += a3;
          c0 = fmaf(to_f(sm.Cm[r0 * LD + n]), a0, c0);
          c0 = fmaf(to_f(sm.Cm[r0 * LD + n + 1]), a1, c0);
          c1 = fmaf(to_f(sm.Cm[r1 * LD + n]), a2, c1);
          c1 = fmaf(to_f(sm.Cm[r1 * LD + n + 1]), a3, c1);
        }
        c0 += __shfl_xor_sync(0xffffffffu, c0, 1);
        c0 += __shfl_xor_sync(0xffffffffu, c0, 2);
        c1 += __shfl_xor_sync(0xffffffffu, c1, 1);
        c1 += __shfl_xor_sync(0xffffffffu, c1, 2);
        if (t4 == 0) {
          sm.cc[r0] = c0;
          sm.cc[r1] = c1;
        }
      }
      for (int e = tid; e < DH * N; e += THREADS) {
        const int i = (e / N) * LDS + e % N;
        dot = fmaf(sm.So[i], sm.Si[i], dot);
      }
    }
    for (int off = 16; off > 0; off /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (lane == 0) sm.red[warp] = dot;
    __syncthreads();  // every warp is done with S_in
    if (hi + 1 < nh) stage_si(hi + 1);
    cp_commit();

    // (b) rows s: dx's state term wdt_s (B dS^T), k = n; Y = x dS, k = d;
    // P_s = B_s . Y_s; dB += wdt_s Y
    const float cq = cum[Q - 1];
    const float cs0 = cum[r0], cs1 = cum[r1], dt0 = dts[r0], dt1 = dts[r1];
    const float wdt0 = r0 < Q ? expf(cq - cs0) * dt0 : 0.f;
    const float wdt1 = r1 < Q ? expf(cq - cs1) * dt1 : 0.f;
    float dxv[8][4];
    if (active) {
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) dxv[m][i] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < 8; ++ks) {
        const int n0 = 8 * ks + t4, n1 = n0 + 4;
        const FragA fb = frag_a<CX>(to_f(sm.Bm[r0 * LD + n0]), to_f(sm.Bm[r1 * LD + n0]),
                                    to_f(sm.Bm[r0 * LD + n1]), to_f(sm.Bm[r1 * LD + n1]));
#pragma unroll
        for (int m = 0; m < 8; ++m)
          mma_step<CX, false>(dxv[m], fb, sm.So[(8 * m + g) * LDS + n0],
                              sm.So[(8 * m + g) * LDS + n1]);
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        dxv[m][0] *= wdt0;
        dxv[m][1] *= wdt0;
        dxv[m][2] *= wdt1;
        dxv[m][3] *= wdt1;
      }
      float yv[8][4];
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) yv[m][i] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < 8; ++ks) {
        const int d0 = 8 * ks + t4, d1 = d0 + 4;
        const FragA fx = frag_a<CX>(to_f(X[r0 * LD + d0]), to_f(X[r1 * LD + d0]),
                                    to_f(X[r0 * LD + d1]), to_f(X[r1 * LD + d1]));
#pragma unroll
        for (int m = 0; m < 8; ++m)
          mma_step<CX, false>(yv[m], fx, sm.So[d0 * LDS + 8 * m + g], sm.So[d1 * LDS + 8 * m + g]);
      }
      float P0 = 0.f, P1 = 0.f;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int n = 8 * m + 2 * t4;
        P0 = fmaf(to_f(sm.Bm[r0 * LD + n]), yv[m][0], P0);
        P0 = fmaf(to_f(sm.Bm[r0 * LD + n + 1]), yv[m][1], P0);
        P1 = fmaf(to_f(sm.Bm[r1 * LD + n]), yv[m][2], P1);
        P1 = fmaf(to_f(sm.Bm[r1 * LD + n + 1]), yv[m][3], P1);
        dB[m][0] = fmaf(wdt0, yv[m][0], dB[m][0]);
        dB[m][1] = fmaf(wdt0, yv[m][1], dB[m][1]);
        dB[m][2] = fmaf(wdt1, yv[m][2], dB[m][2]);
        dB[m][3] = fmaf(wdt1, yv[m][3], dB[m][3]);
      }
      P0 += __shfl_xor_sync(0xffffffffu, P0, 1);
      P0 += __shfl_xor_sync(0xffffffffu, P0, 2);
      P1 += __shfl_xor_sync(0xffffffffu, P1, 1);
      P1 += __shfl_xor_sync(0xffffffffu, P1, 2);
      if (t4 == 0) {
        sm.P[r0] = P0;
        sm.P[r1] = P1;
      }
    }
    __syncthreads();  // every warp is done with dS
    if (hi + 1 < nh) stage_so(hi + 1);
    cp_commit();

    // (c) rows s: M^T = x dy^T (columns t, k = d); G^T, Ml^T, Z^T from its
    // registers; dx += G^T dy and dB += Ml^T C (k = t)
    if (active) {
      float mv[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) mv[j][i] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < 8; ++ks) {
        const int d0 = 8 * ks + t4, d1 = d0 + 4;
        const FragA fx = frag_a<CX>(to_f(X[r0 * LD + d0]), to_f(X[r1 * LD + d0]),
                                    to_f(X[r0 * LD + d1]), to_f(X[r1 * LD + d1]));
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j >= jmin && j <= jlast)
            mma_step<CX, false>(mv[j], fx, DY[(8 * j + g) * LDY + d0],
                                DY[(8 * j + g) * LDY + d1]);
      }
      float zs0 = 0.f, zs1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < jmin || j > jlast) continue;
        // this thread's columns t: ta = 8 j + 2 t4 and tb = ta + 1; as an
        // A fragment, k-slot t4 stands for ta and t4 + 4 for tb
        const int ta = 8 * j + 2 * t4, tb = ta + 1;
        const float cta = cum[ta], ctb = cum[tb];
        const float E00 = r0 <= ta && ta < Q ? expf(cta - cs0) : 0.f;
        const float E01 = r0 <= tb && tb < Q ? expf(ctb - cs0) : 0.f;
        const float E10 = r1 <= ta && ta < Q ? expf(cta - cs1) : 0.f;
        const float E11 = r1 <= tb && tb < Q ? expf(ctb - cs1) : 0.f;
        const float g00 = cb[j][0] * E00 * dt0, g01 = cb[j][1] * E01 * dt0;
        const float g10 = cb[j][2] * E10 * dt1, g11 = cb[j][3] * E11 * dt1;
        const float l00 = mv[j][0] * E00 * dt0, l01 = mv[j][1] * E01 * dt0;
        const float l10 = mv[j][2] * E10 * dt1, l11 = mv[j][3] * E11 * dt1;
        const float z00 = mv[j][0] * cb[j][0] * E00, z01 = mv[j][1] * cb[j][1] * E01;
        const float z10 = mv[j][2] * cb[j][2] * E10, z11 = mv[j][3] * cb[j][3] * E11;
        store2(sm.MlT + r0 * LDY + ta, l00, l01);
        store2(sm.MlT + r1 * LDY + ta, l10, l11);
        zs0 = zs0 + z00 + z01;
        zs1 = zs1 + z10 + z11;
        // sum over this warp's rows s of Z[t,s] dt_s: rows g, g + 8 of the
        // thread, then the eight g by an xor tree
        float ca = fmaf(z10, dt1, z00 * dt0), cbv = fmaf(z11, dt1, z01 * dt0);
#pragma unroll
        for (int off = 4; off < 32; off *= 2) {
          ca += __shfl_xor_sync(0xffffffffu, ca, off);
          cbv += __shfl_xor_sync(0xffffffffu, cbv, off);
        }
        if (g == 0) {
          sm.colz[warp][ta] = ca;
          sm.colz[warp][tb] = cbv;
        }
        const FragA fg = frag_a<false>(g00, g10, g01, g11);
        const FragA fm = frag_a<false>(l00, l10, l01, l11);
#pragma unroll
        for (int m = 0; m < 8; ++m)
          mma_step<false, false>(dxv[m], fg, DY[ta * LDY + 8 * m + g], DY[tb * LDY + 8 * m + g]);
#pragma unroll
        for (int m = 0; m < 8; ++m)
          mma_step<false, CX>(dB[m], fm, to_f(sm.Cm[ta * LD + 8 * m + g]),
                              to_f(sm.Cm[tb * LD + 8 * m + g]));
      }
      zs0 += __shfl_xor_sync(0xffffffffu, zs0, 1);
      zs0 += __shfl_xor_sync(0xffffffffu, zs0, 2);
      zs1 += __shfl_xor_sync(0xffffffffu, zs1, 1);
      zs1 += __shfl_xor_sync(0xffffffffu, zs1, 2);
      if (t4 == 0) {
        sm.zs[r0] = zs0;
        sm.zs[r1] = zs1;
      }
      T* dx = static_cast<T*>(p.dx) + ((b * (long long)p.S + s0) * p.H + h) * DH;
      const long long row = (long long)p.H * DH;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int d = 8 * m + 2 * t4;
        if (r0 < Q) store2(dx + r0 * row + d, dxv[m][0], dxv[m][1]);
        if (r1 < Q) store2(dx + r1 * row + d, dxv[m][2], dxv[m][3]);
      }
    }
    __syncthreads();  // Ml^T, the step sums and the column sums written; x, dy free
    if (hi + 1 < nh) stage_x_dy(hi + 1, buf ^ 1);
    cp_commit();

    // (d) rows t: dC += Ml B, k = s <= t, Ml read transposed
    if (active) {
      for (int ks = 0; ks <= kmax; ++ks) {
        const int sa = 8 * ks + t4, sb = sa + 4;
        const FragA fa = frag_a<false>(sm.MlT[sa * LDY + r0], sm.MlT[sa * LDY + r1],
                                       sm.MlT[sb * LDY + r0], sm.MlT[sb * LDY + r1]);
#pragma unroll
        for (int m = 0; m < 8; ++m)
          mma_step<false, CX>(dC[m], fa, to_f(sm.Bm[sa * LD + 8 * m + g]),
                              to_f(sm.Bm[sb * LD + 8 * m + g]));
      }
    }
    if (warp == 0) {  // the head's tail: lane l steps 2 l and 2 l + 1
      const float a = p.A[h];
      float dc[2], w[2], P[2], zs[2], dtj[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = 2 * lane + q;
        const bool in = j < Q;
        float row = 0.f;
        for (int v = 0; v <= j / 16 && in; ++v) row += sm.colz[v][j];
        dtj[q] = dts[j];
        w[q] = in ? expf(cq - cum[j]) : 0.f;
        P[q] = in ? sm.P[j] : 0.f;
        zs[q] = in ? sm.zs[j] : 0.f;
        const float cc = in && c > 0 ? sm.cc[j] : 0.f;
        dc[q] = in ? (row - dtj[q] * zs[q]) + cc - w[q] * dtj[q] * P[q] : 0.f;
      }
      // the chunk-end terms: exp(cum_Q) <dS, S_in> + sum_s w_s dt_s P_s
      float ends = fmaf(w[1] * dtj[1], P[1], w[0] * dtj[0] * P[0]);
#pragma unroll
      for (int off = 1; off < 32; off *= 2) ends += __shfl_xor_sync(0xffffffffu, ends, off);
      const float dot_all = (sm.red[0] + sm.red[1]) + (sm.red[2] + sm.red[3]);
      const int last = Q - 1;
      if (2 * lane == last) dc[0] += expf(cq) * dot_all + ends;
      if (2 * lane + 1 == last) dc[1] += expf(cq) * dot_all + ends;
      // the reverse cumsum: each lane's pair, then the lanes after it by a
      // suffix scan of fixed rounds
      const float pair = dc[0] + dc[1];
      float suf = pair;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float o = __shfl_down_sync(0xffffffffu, suf, off);
        if (lane + off < 32) suf += o;
      }
      float after = __shfl_down_sync(0xffffffffu, suf, 1);
      if (lane == 31) after = 0.f;
      const float dda1 = dc[1] + after, dda0 = dc[0] + dda1;
      float* ddt = p.ddt + (b * (long long)p.S + s0) * p.H + h;
      if (2 * lane < Q) ddt[(long long)(2 * lane) * p.H] = fmaf(a, dda0, fmaf(w[0], P[0], zs[0]));
      if (2 * lane + 1 < Q)
        ddt[(long long)(2 * lane + 1) * p.H] = fmaf(a, dda1, fmaf(w[1], P[1], zs[1]));
      float da = fmaf(dtj[1], dda1, dtj[0] * dda0);
#pragma unroll
      for (int off = 1; off < 32; off *= 2) da += __shfl_xor_sync(0xffffffffu, da, off);
      if (lane == 0) p.dApart[bh * p.nc + c] = da;
    }
  }

  // the group's shares of dB (rows s) and dC (rows t)
  if (active) {
    const long long base = ((long long)b * p.ng + grp) * p.S + s0;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int n = 8 * m + 2 * t4;
      if (r0 < Q) {
        store2(p.dBg + (base + r0) * N + n, dB[m][0], dB[m][1]);
        store2(p.dCg + (base + r0) * N + n, dC[m][0], dC[m][1]);
      }
      if (r1 < Q) {
        store2(p.dBg + (base + r1) * N + n, dB[m][2], dB[m][3]);
        store2(p.dCg + (base + r1) * N + n, dC[m][2], dC[m][3]);
      }
    }
  }
}

// ------------------------------------------------------- fold

template <class T>
__global__ void __launch_bounds__(FOLD_THREADS) ssm_bwd_fold(Params p) {
  const long long i = (long long)blockIdx.x * FOLD_THREADS + threadIdx.x;
  const long long per_b = (long long)p.S * N;
  if (i < p.Bt * per_b) {
    const long long b = i / per_b, sn = i % per_b;
    float db = 0.f, dc = 0.f;
    for (int gi = 0; gi < p.ng; ++gi) {
      db += p.dBg[(b * p.ng + gi) * per_b + sn];
      dc += p.dCg[(b * p.ng + gi) * per_b + sn];
    }
    store(static_cast<T*>(p.dB) + i, db);
    store(static_cast<T*>(p.dC) + i, dc);
  }
  if (i < p.H) {
    float da = 0.f;
    for (int b = 0; b < p.Bt; ++b)
      for (int c = 0; c < p.nc; ++c) da += p.dApart[((long long)b * p.H + i) * p.nc + c];
    p.dA[i] = da;
  }
}

template <class T>
int launch(const Params& p, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int st_smem = (int)sizeof(StatesSmem<T>), ch_smem = (int)sizeof(ChunkSmem<T>);
  cudaError_t err = cudaFuncSetAttribute(ssm_bwd_states<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, st_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssm_bwd_chunks<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ch_smem);
  if (err != cudaSuccess) return (int)err;
  ssm_bwd_states<T><<<p.Bt * p.H, THREADS, st_smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssm_bwd_chunks<T><<<dim3(p.nc, p.Bt, p.ng), THREADS, ch_smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)p.Bt * p.S * N;
  const long long fold = items > p.H ? items : p.H;
  ssm_bwd_fold<T><<<(unsigned)((fold + FOLD_THREADS - 1) / FOLD_THREADS), FOLD_THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (Bt, S, H, dh), dt: (Bt, S, H) float32, A: contiguous (H,) float32, B
// and C: (Bt, S, N), each with element strides as in ssm_scan (bf16 != 0:
// x, B and C bfloat16, else float32); cum and chunk_state: the forward's
// scratch of the same inputs and chunk Q; dy: (Bt, S, H, dh) float32,
// strides (batch, seq, head), last axis contiguous; dstate: contiguous
// (Bt, H, dh, N) float32 or null. ds (Bt * H * (S / Q) * dh * N floats),
// dBg and dCg (Bt * ceil(H / 8) * S * N each) and dApart (Bt * H * (S /
// Q)) are the caller's scratch. Writes dx (contiguous, x's shape and
// type), ddt (contiguous (Bt, S, H) float32), dA (H,) float32, and dB and
// dC (contiguous (Bt, S, N), B's type). Three launches on `stream`.
extern "C" int ssm_scan_bwd(const void* x, const float* dt, const float* A, const void* B,
                            const void* C, const float* cum, const float* chunk_state,
                            const float* dy, const float* dstate, float* ds, float* dBg,
                            float* dCg, float* dApart, void* dx, float* ddt, float* dA, void* dB,
                            void* dC, int bf16, int Bt, int H, int S, int dh, int n, int Q,
                            long long xsb, long long xss, long long xsh, long long dsb,
                            long long dss, long long dsh, long long bsb, long long bss,
                            long long csb, long long css, long long ysb, long long yss,
                            long long ysh, void* stream) {
  if (dh != DH || n != N || Bt < 1 || H < 1 || Bt > 65535 || Q < 1 || Q > QMAX || S < Q ||
      S % Q)
    return (int)cudaErrorInvalidValue;
  const long long eb = bf16 ? 2 : 4;
  const int vec = aligned16(x, eb, {xsb, xss, xsh}) && aligned16(B, eb, {bsb, bss}) &&
                  aligned16(C, eb, {csb, css});
  const int yvec = aligned16(dy, 4, {ysb, yss, ysh});
  const Params p{x,   dt,  A,  B,  C,  cum, chunk_state, dy, dstate, ds, dBg, dCg, dApart,
                 dx,  ddt, dA, dB, dC, {xsb, xss, xsh}, {dsb, dss, dsh}, {bsb, bss}, {csb, css},
                 {ysb, yss, ysh}, Bt, H, S, Q, S / Q, (H + HG - 1) / HG, vec, yvec};
  return bf16 ? launch<__nv_bfloat16>(p, stream) : launch<float>(p, stream);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
