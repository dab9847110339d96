// Mamba2 SSD chunked scan (K5): a scalar decay per head, a (dh, N) fp32
// state carried across the chunks of each (batch, head).
//
// Replaces the Pallas kernel repro/kernels/ssm_scan.py:ssm_scan (without
// its D * x skip, which the wrapper adds, as the Pallas wrapper does). Per
// chunk of Q steps, in fp32:
//   cum_t   = inclusive cumsum of dt * A over the chunk, in time order;
//   G[t,s]  = (C_t . B_s) exp(cum_t - cum_s) dt_s, s <= t only;
//   y_t     = sum_{s<=t} G[t,s] x_s + exp(cum_t) (C_t . state^T);
//   state' = exp(cum_Q) state + sum_s (exp(cum_Q - cum_s) dt_s x_s) B_s^T.
// B and C are shared by all heads and x is a strided view of the conv
// output: the kernel reads them in place by their strides (the Pallas
// wrapper broadcasts and transposes copies). It also writes the final
// state, which the model's prefill stores in the decode cache.
//
// Bound on an H100 (NVIDIA's data sheet: 3.35 TB/s, 495 TFLOP/s TF32,
// 67 TFLOP/s fp32): bytes. At the serving shape (Zamba2-7B: 4 x 112 heads
// x 2,048 steps, dh = N = 64, bf16 x, B, C) the function reads and writes
// 365 MB, 0.109 ms, while its products on split TF32 need 3.1e10 flop
// (0.063 ms) at their cheapest chunk.
//
// Design: the SSD chunk-parallel form in two launches, no grid barrier
// and no flags between CTAs; the wrapper counts the call once.
//   ssm_states, one CTA of 4 warps per (batch, head): the chunks' cumsums
//     first, one thread per chunk, each in time order (dt staged in shared
//     memory; the sums to device memory, `cum`); then the chunks in order, each one's x, B, dt and cum staged
//     by cp.async while the one before computes: the update U_c = (x w)^T B
//     (w_s = exp(cum_Q - cum_s) dt_s) on the tensor cores, the state that
//     enters chunk c written to `chunk_state`, and state_c = fmaf(state_{c-1},
//     exp(cum_Q), U_c) in registers (the plain version's state * decay +
//     upd, and the Pallas kernel's, as one rounding). The final state goes
//     to `state`.
//   ssm_outputs, one CTA of 4 warps per (chunk, batch, group of 8 heads),
//     all chunks at once: C B^T once for the group (it does not depend on
//     the head), then per head, the next head's x, dt, cum and entering
//     state staged by cp.async while this one computes, G in registers,
//     y = fmaf(exp(cum_t), C state^T, G x). Warp w owns rows 16w..16w+15
//     of the chunk and only the column tiles s <= t reach.
// U_c is made in the ssm_states walk, not in the parallel launch: the walk
// reads x and B for the state pass anyway, and U_c from a parallel launch
// would cross device memory twice more (228 MB each way); 448 CTAs of the
// walk fit the card in one wave, and the walk is held by its memory
// pipeline more than by its products.
// Bytes of this design at the serving shape: ssm_states reads x (117 MB),
// B, dt and writes cum and 31 entering states a (batch, head) (228 MB);
// ssm_outputs reads x, B, C, dt, cum and the states and writes y (235 MB):
// about 950 MB in all, 0.28 ms at 3.35 TB/s.
//
// Products: mma.sync m16n8k8 TF32 with fp32 accumulation (SASS HMMA), one
// warp a 16-row tile. wgmma needs 64-row tiles with B K-major in shared
// memory (its transpose bits are for 16-bit types only): G and x w are
// made in registers, and the state tiles are read as B; mma.sync takes
// both from registers, and G stays in the accumulator's registers from
// C B^T to G x (below), with no trip through shared memory.
// fp32 accuracy by split TF32: an fp32 operand a is split into big =
// tf32(a) (cvt.rn.tf32.f32, nearest even; kernels/ref.py:tf32_round) and
// small = tf32(a - big) (the subtraction is exact), which keeps about 21
// bits. An operand exact in TF32 is not split: bfloat16 x, B and C (7
// stored mantissa bits of TF32's 10). Per product, for each k-step of 8
// in ascending k, into one fp32 accumulator that starts at 0:
//   one split operand   a_small b, then a_big b (or a b_small, a b_big);
//   both split          a_small b_big, a_big b_small, a_big b_big;
//   neither (C B^T, bf16) a b.
// So in bf16: C B^T one product (k = n), G x two (k = s, G split), C
// state^T two (k = n, the state split), (x w)^T B two (k = s, x w split);
// fp32 inputs take three each. The order is fixed by the data, never by
// the grid, and kernels/ref.py:ssm_scan_split_ref emulates it.
// G x takes G from C B^T's accumulator: a thread holds C-fragment columns
// 2t and 2t + 1 of each 8-column tile, and uses them as A-fragment columns
// t and t + 4, so k-slot t stands for s = 2t and t + 4 for s = 2t + 1; x's
// rows are read in that order. The sum is the same.
// The gate exp(cum_t - cum_s) is taken only for s <= t (never exp(cum_t)
// times exp(-cum_s), which overflows), as (C B^T) exp(..) dt_s, left to
// right; cum adds __fmul_rn(dt, a) with __fadd_rn, so both launches read
// one set of bits.

#include "tf32_mma.cuh"

namespace {

constexpr int DH = 64, N = 64, QMAX = 64, THREADS = 128, HG = 8, LDS = 68;

// Row pitch of a staged x, B or C tile in elements: 144 bytes in bf16,
// 272 in fp32 (multiples of 16 for cp.async; fragment reads hit distinct
// banks).
template <class T> constexpr int kPitch = std::is_same<T, float>::value ? 68 : 72;

struct Params {
  const void* x;
  const float* dt;
  const float* A;      // (H,)
  const void* B;
  const void* C;
  float* y;            // contiguous (Bt, S, H, DH)
  float* state;        // contiguous (Bt, H, DH, N)
  float* cum;          // scratch, contiguous (Bt, H, S)
  float* chunk_state;  // scratch, contiguous (Bt, H, nc, DH, N): state entering chunk c
  long long xs[3];     // element strides (b, s, h); dh contiguous
  long long ds[3];     // dt's (b, s, h)
  long long bs[2], cs[2];  // B's and C's (b, s); N contiguous
  int H, S, Q, nc;
  int vec;             // x, B and C rows start on 16 bytes: 16-byte cp.async
};

// ---------------------------------------------------------------- states

template <class T>
struct StatesSmem {
  T X[2][QMAX * kPitch<T>];
  T Bm[2][QMAX * kPitch<T>];
  float cum[2][QMAX];
  float dt[2][QMAX];
  float w[QMAX];
};

template <class T>
__global__ void __launch_bounds__(THREADS, 4) ssm_states(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<StatesSmem<T>*>(smem_raw);
  constexpr int LD = kPitch<T>;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H, tid = threadIdx.x;
  const int Q = p.Q, nc = p.nc;
  const float a = p.A[h];
  const T* x = static_cast<const T*>(p.x) + b * p.xs[0] + h * p.xs[2];
  const T* Bg = static_cast<const T*>(p.B) + b * p.bs[0];
  const float* dt = p.dt + b * p.ds[0] + h * p.ds[2];
  float* cum = p.cum + (long long)bh * p.S;

  // each chunk's cumsum, one thread a chunk, in time order, over windows
  // of up to 2,048 steps: dt staged in shared memory (the staging buffers,
  // free before the walk; rows padded by one float), summed in place, and
  // written out row by row
  float* win = reinterpret_cast<float*>(sm.X);
  const int wsteps = (2048 / Q) * Q;
  for (int w0 = 0; w0 < p.S; w0 += wsteps) {
    const int n = min(wsteps, p.S - w0);
    for (int t = tid; t < n; t += THREADS)
      win[(t / Q) * (Q + 1) + t % Q] = dt[(long long)(w0 + t) * p.ds[1]];
    __syncthreads();
    for (int c = tid; c < n / Q; c += THREADS) {
      float* row = win + c * (Q + 1);
      float acc = 0.f;
#pragma unroll 16
      for (int t = 0; t < Q; ++t) {
        acc = __fadd_rn(acc, __fmul_rn(row[t], a));
        row[t] = acc;
      }
    }
    __syncthreads();
    for (int t = tid; t < n; t += THREADS) cum[w0 + t] = win[(t / Q) * (Q + 1) + t % Q];
    __syncthreads();
  }
  for (int i = 0; i < 2; ++i) {  // rows Q..63 zero (cp.async writes rows below Q only): a
    // masked G or w times an unwritten NaN would still give NaN
    zero_tile_rows<T, THREADS>(sm.X[i], LD, Q, QMAX);
    zero_tile_rows<T, THREADS>(sm.Bm[i], LD, Q, QMAX);
  }
  __syncthreads();  // cum in device memory, seen by the block's cp.async below

  auto stage = [&](int c, int buf) {
    const long long s0 = (long long)c * Q;
    stage_tile<T, THREADS>(sm.X[buf], LD, x + s0 * p.xs[1], p.xs[1], Q, DH, p.vec);
    stage_tile<T, THREADS>(sm.Bm[buf], LD, Bg + s0 * p.bs[1], p.bs[1], Q, N, p.vec);
    if (tid < Q) {
      cp4(&sm.dt[buf][tid], dt + (s0 + tid) * p.ds[1]);
      cp4(&sm.cum[buf][tid], cum + s0 + tid);
    }
  };

  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int d0 = 16 * warp + g, d1 = d0 + 8;  // this thread's rows of the state
  const int ksteps = (Q + 7) / 8;
  float st[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) st[j][i] = 0.f;
  float* entering = p.chunk_state + (long long)bh * nc * DH * N;

  stage(0, 0);
  cp_commit();
  for (int c = 0; c < nc; ++c) {
    const int buf = c & 1;
    cp_wait<0>();
    __syncthreads();  // chunk c staged; every warp is done with chunk c - 1
    if (c + 1 < nc) stage(c + 1, buf ^ 1);
    cp_commit();
    if (tid < QMAX)
      sm.w[tid] = tid < Q ? expf(sm.cum[buf][Q - 1] - sm.cum[buf][tid]) * sm.dt[buf][tid] : 0.f;
    __syncthreads();
    const float decay = expf(sm.cum[buf][Q - 1]);
    const T* X = sm.X[buf];
    const T* Bm = sm.Bm[buf];

    // U = (x w)^T B: rows d, columns n, k = s
    float u[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) u[j][i] = 0.f;
    for (int ks = 0; ks < ksteps; ++ks) {
      const int s0 = 8 * ks + t4, s1 = s0 + 4;
      const float w0 = sm.w[s0], w1 = sm.w[s1];
      const FragA fa = frag_a<false>(to_f(X[s0 * LD + d0]) * w0, to_f(X[s0 * LD + d1]) * w0,
                                     to_f(X[s1 * LD + d0]) * w1, to_f(X[s1 * LD + d1]) * w1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mma_step<false, kExact<T>>(u[j], fa, to_f(Bm[s0 * LD + 8 * j + g]),
                                    to_f(Bm[s1 * LD + 8 * j + g]));
    }

    if (c > 0) {  // the state entering chunk c, for ssm_outputs
      float* out = entering + (long long)c * DH * N;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 8 * j + 2 * t4;
        *reinterpret_cast<float2*>(out + d0 * N + n) = make_float2(st[j][0], st[j][1]);
        *reinterpret_cast<float2*>(out + d1 * N + n) = make_float2(st[j][2], st[j][3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[j][i] = fmaf(st[j][i], decay, u[j][i]);
  }
  float* out = p.state + (long long)bh * DH * N;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = 8 * j + 2 * t4;
    *reinterpret_cast<float2*>(out + d0 * N + n) = make_float2(st[j][0], st[j][1]);
    *reinterpret_cast<float2*>(out + d1 * N + n) = make_float2(st[j][2], st[j][3]);
  }
}

// --------------------------------------------------------------- outputs

template <class T>
struct OutputsSmem {
  T Cm[QMAX * kPitch<T>];
  T Bm[QMAX * kPitch<T>];
  T X[2][QMAX * kPitch<T>];
  float St[2][DH * LDS];  // the entering state, [d][n]
  float cum[2][QMAX];
  float dt[2][QMAX];
};

template <class T>
__global__ void __launch_bounds__(THREADS, 3) ssm_outputs(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<OutputsSmem<T>*>(smem_raw);
  constexpr int LD = kPitch<T>;
  constexpr bool CX = kExact<T>;
  const int c = blockIdx.x, b = blockIdx.y, h0 = blockIdx.z * HG, tid = threadIdx.x;
  const int Q = p.Q, nh = min(HG, p.H - h0);
  const long long s0 = (long long)c * Q;
  const T* Bg = static_cast<const T*>(p.B) + b * p.bs[0] + s0 * p.bs[1];
  const T* Cg = static_cast<const T*>(p.C) + b * p.cs[0] + s0 * p.cs[1];

  zero_tile_rows<T, THREADS>(sm.Cm, LD, Q, QMAX);  // rows Q..63 zero, as in ssm_states
  zero_tile_rows<T, THREADS>(sm.Bm, LD, Q, QMAX);
  for (int i = 0; i < 2; ++i) zero_tile_rows<T, THREADS>(sm.X[i], LD, Q, QMAX);
  if (tid < QMAX - Q)
    for (int i = 0; i < 2; ++i) sm.cum[i][Q + tid] = sm.dt[i][Q + tid] = 0.f;

  auto stage = [&](int hi, int buf) {
    const int h = h0 + hi;
    const long long bh = (long long)b * p.H + h;
    stage_tile<T, THREADS>(sm.X[buf], LD,
                           static_cast<const T*>(p.x) + b * p.xs[0] + h * p.xs[2] + s0 * p.xs[1],
                           p.xs[1], Q, DH, p.vec);
    if (tid < Q) {
      cp4(&sm.dt[buf][tid], p.dt + b * p.ds[0] + h * p.ds[2] + (s0 + tid) * p.ds[1]);
      cp4(&sm.cum[buf][tid], p.cum + bh * p.S + s0 + tid);
    }
    if (c > 0) {
      const float* src = p.chunk_state + (bh * p.nc + c) * DH * N;
      for (int e = tid; e < DH * N / 4; e += THREADS) {
        const int d = e / (N / 4), q4 = e % (N / 4);
        cp16(&sm.St[buf][d * LDS + 4 * q4], src + d * N + 4 * q4);
      }
    }
  };

  stage_tile<T, THREADS>(sm.Cm, LD, Cg, p.cs[1], Q, N, p.vec);
  stage_tile<T, THREADS>(sm.Bm, LD, Bg, p.bs[1], Q, N, p.vec);
  stage(0, 0);
  cp_commit();

  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int r0 = 16 * warp + g, r1 = r0 + 8;  // this thread's rows of the chunk
  const bool active = 16 * warp < Q;
  const int jmax = min(2 * warp + 1, (Q - 1) / 8);  // the last column tile s <= t reaches
  float cb[8][4];

  for (int hi = 0; hi < nh; ++hi) {
    const int buf = hi & 1;
    __syncthreads();  // every warp is done with head hi - 1
    if (hi + 1 < nh) stage(hi + 1, buf ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // head hi staged (and C, B with head 0)

    if (hi == 0 && active) {  // C B^T: rows t, columns s, k = n; once for the group
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) cb[j][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const int n0 = 8 * ks + t4, n1 = n0 + 4;
        const FragA fc = frag_a<CX>(to_f(sm.Cm[r0 * LD + n0]), to_f(sm.Cm[r1 * LD + n0]),
                                    to_f(sm.Cm[r0 * LD + n1]), to_f(sm.Cm[r1 * LD + n1]));
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j <= jmax)
            mma_step<CX, CX>(cb[j], fc, to_f(sm.Bm[(8 * j + g) * LD + n0]),
                             to_f(sm.Bm[(8 * j + g) * LD + n1]));
      }
    }
    if (!active) continue;

    const float* cum = sm.cum[buf];
    const float* dts = sm.dt[buf];
    const T* X = sm.X[buf];
    const float ct0 = cum[r0], ct1 = cum[r1];
    // G x: rows t, columns d, k = s; G from C B^T's registers
    float yv[8][4];
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) yv[m][i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j > jmax) continue;
      const int sa = 8 * j + 2 * t4, sb = sa + 1;
      const float csa = cum[sa], csb = cum[sb], da = dts[sa], db = dts[sb];
      const bool v0 = r0 < Q, v1 = r1 < Q;
      const float g00 = v0 && sa <= r0 ? cb[j][0] * expf(ct0 - csa) * da : 0.f;
      const float g01 = v0 && sb <= r0 ? cb[j][1] * expf(ct0 - csb) * db : 0.f;
      const float g10 = v1 && sa <= r1 ? cb[j][2] * expf(ct1 - csa) * da : 0.f;
      const float g11 = v1 && sb <= r1 ? cb[j][3] * expf(ct1 - csb) * db : 0.f;
      const FragA fg = frag_a<false>(g00, g10, g01, g11);  // k-slot t: s = sa; t + 4: s = sb
#pragma unroll
      for (int m = 0; m < 8; ++m)
        mma_step<false, CX>(yv[m], fg, to_f(X[sa * LD + 8 * m + g]), to_f(X[sb * LD + 8 * m + g]));
    }
    if (c > 0) {  // the carry-in C state^T: rows t, columns d, k = n
      const float* St = sm.St[buf];
      float cv[8][4];
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[m][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const int n0 = 8 * ks + t4, n1 = n0 + 4;
        const FragA fc = frag_a<CX>(to_f(sm.Cm[r0 * LD + n0]), to_f(sm.Cm[r1 * LD + n0]),
                                    to_f(sm.Cm[r0 * LD + n1]), to_f(sm.Cm[r1 * LD + n1]));
#pragma unroll
        for (int m = 0; m < 8; ++m)
          mma_step<CX, false>(cv[m], fc, St[(8 * m + g) * LDS + n0], St[(8 * m + g) * LDS + n1]);
      }
      const float e0 = expf(ct0), e1 = expf(ct1);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        yv[m][0] = fmaf(e0, cv[m][0], yv[m][0]);
        yv[m][1] = fmaf(e0, cv[m][1], yv[m][1]);
        yv[m][2] = fmaf(e1, cv[m][2], yv[m][2]);
        yv[m][3] = fmaf(e1, cv[m][3], yv[m][3]);
      }
    }
    const int h = h0 + hi;
    float* y = p.y + ((long long)b * p.S * p.H + h) * DH;
    const long long row = (long long)p.H * DH;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int d = 8 * m + 2 * t4;
      if (r0 < Q)
        *reinterpret_cast<float2*>(y + (s0 + r0) * row + d) = make_float2(yv[m][0], yv[m][1]);
      if (r1 < Q)
        *reinterpret_cast<float2*>(y + (s0 + r1) * row + d) = make_float2(yv[m][2], yv[m][3]);
    }
  }
}

template <class T>
int launch(const Params& p, int Bt, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int states_smem = (int)sizeof(StatesSmem<T>), outputs_smem = (int)sizeof(OutputsSmem<T>);
  cudaError_t err = cudaFuncSetAttribute(ssm_states<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, states_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssm_outputs<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               outputs_smem);
  if (err != cudaSuccess) return (int)err;
  ssm_states<T><<<Bt * p.H, THREADS, states_smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssm_outputs<T><<<dim3(p.nc, Bt, (p.H + HG - 1) / HG), THREADS, outputs_smem, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (Bt, S, H, dh) with element strides (batch, seq, head) and a
// contiguous last axis; dt: (Bt, S, H) float32, strides (batch, seq,
// head); A: contiguous (H,) float32; B and C: (Bt, S, N) of x's dtype
// (bf16 != 0: bfloat16, else float32), strides (batch, seq), N contiguous.
// Writes y, contiguous (Bt, S, H, dh) float32, without D * x, and state,
// contiguous (Bt, H, dh, N) float32. cum (Bt * H * S floats) and
// chunk_state (Bt * H * (S / Q) * dh * N floats) are the caller's scratch.
// dh and N must be 64, the chunk Q at most 64 and a divisor of S. Two
// launches on `stream`.
extern "C" int ssm_scan(const void* x, const float* dt, const float* A, const void* B,
                        const void* C, float* y, float* state, float* cum, float* chunk_state,
                        int bf16, int Bt, int H, int S, int dh, int n, int Q, long long xsb,
                        long long xss, long long xsh, long long dsb, long long dss,
                        long long dsh, long long bsb, long long bss, long long csb,
                        long long css, void* stream) {
  if (dh != DH || n != N || Bt < 1 || H < 1 || Q < 1 || Q > QMAX || S < Q || S % Q)
    return (int)cudaErrorInvalidValue;
  const long long eb = bf16 ? 2 : 4;
  const int vec = aligned16(x, eb, {xsb, xss, xsh}) && aligned16(B, eb, {bsb, bss}) &&
                  aligned16(C, eb, {csb, css});
  const Params p{x, dt, A, B, C, y, state, cum, chunk_state, {xsb, xss, xsh}, {dsb, dss, dsh},
                 {bsb, bss}, {csb, css}, H, S, Q, S / Q, vec};
  return bf16 ? launch<__nv_bfloat16>(p, Bt, stream) : launch<float>(p, Bt, stream);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
