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
// B and C are shared by the heads: each head's share is written apart and
// summed over the heads in a fixed order. kernels/ssm_scan.py:
// ssm_scan_bwd_plain is the plain version of the same recurrences.
//
// Bound on an H100 (NVIDIA's data sheet: 3.35 TB/s, 67 TFLOP/s fp32): at
// Zamba2-7B's training shape (4 x 2,048 steps x 112 heads, dh = N = 64,
// bf16 x, B, C) the function reads x, dt, B, C and dy and writes dx, ddt,
// dB, dC (about 480 MB, 0.14 ms); its products on fp32 FMA take longer at
// any chunk (chip_smoke.py reckons both and states which one binds).
//
// Design: three launches, no atomics and no grid barrier, so two calls
// give the same bits; the wrapper counts the call once.
//   ssm_bwd_states, one CTA of 128 threads per (batch, head, 16 rows of
//     dS): the chunks in reverse order, each one's dy rows, C and cum
//     staged in shared memory, dS written to scratch before the chunk's
//     term is added, dS = fmaf(dS, exp(cum_Q), sum_t exp(cum_t) dy C^T)
//     in registers (a thread 8 entries, the sum over t in time order).
//   ssm_bwd_chunks, one CTA of 256 threads per (chunk, batch, head), all
//     chunks at once: x, dy, B, C, S_in and dS staged as fp32 tiles (183
//     KB of shared memory), the Q x Q tiles G, Ml and Z, the Q x N tiles
//     Y and exp(cum) S_in^T dy, then dx, dB and dC's shares, the row
//     sums of dcum, the reverse cumsum, ddt and the chunk's part of dA,
//     each entry by one thread over its sum's terms in a fixed order.
//   ssm_bwd_fold: dB and dC summed over the heads, h ascending, and dA
//     over (batch, chunk) in order.
// Products on fp32 FMA (a simple kernel first; K5's forward runs split
// TF32 on mma.sync). Tiles are fp32 with a pitch of 65 floats, so a warp
// reading a column hits 32 banks.

#include "tf32_mma.cuh"

namespace {

constexpr int DH = 64, N = 64, QMAX = 64, LD = 65;
constexpr int ST_THREADS = 128, ST_ROWS = 16, ST_BLOCKS = DH / ST_ROWS;
constexpr int CH_THREADS = 256, FOLD_THREADS = 256;

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
  const float* dy;           // (Bt, S, H, DH), strides dys, last axis contiguous
  const float* dstate;       // (Bt, H, DH, N) contiguous, or null (zero)
  float* ds;                 // scratch (Bt, H, nc, DH, N): gradient of the state leaving chunk c
  float* dBh;                // scratch (Bt, H, S, N): each head's share of dB
  float* dCh;                // scratch (Bt, H, S, N)
  float* dApart;             // scratch (Bt, H, nc)
  void* dx;                  // contiguous (Bt, S, H, DH), x's type
  float* ddt;                // contiguous (Bt, S, H)
  float* dA;                 // (H,)
  void* dB;                  // contiguous (Bt, S, N), B's type
  void* dC;
  long long xs[3], ds_[3], bs[2], cs[2], ys[3];
  int Bt, H, S, Q, nc;
};

// ------------------------------------------------------- reverse dS pass

struct StatesSmem {
  float dy[QMAX][ST_ROWS + 1];
  float C[QMAX][LD];
  float e[QMAX];  // exp(cum_t)
};

template <class T>
__global__ void __launch_bounds__(ST_THREADS) ssm_bwd_states(Params p) {
  __shared__ StatesSmem sm;
  const int bh = blockIdx.x / ST_BLOCKS, blk = blockIdx.x % ST_BLOCKS;
  const int b = bh / p.H, h = bh % p.H, tid = threadIdx.x, Q = p.Q;
  const int dl = tid / 8, d = ST_ROWS * blk + dl;  // this thread's row of dS
  const T* Cg = static_cast<const T*>(p.C) + b * p.cs[0];
  const float* dyg = p.dy + b * p.ys[0] + h * p.ys[2] + ST_ROWS * blk;
  const float* cum = p.cum + (long long)bh * p.S;
  float acc[8];
  float* ds = p.ds + (long long)bh * p.nc * DH * N;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = tid % 8 + 8 * j;
    acc[j] = p.dstate ? p.dstate[((long long)bh * DH + d) * N + n] : 0.f;
  }
  for (int c = p.nc - 1; c >= 0; --c) {
    const long long s0 = (long long)c * Q;
    __syncthreads();  // every thread is done with chunk c + 1's tiles
    for (int e = tid; e < Q * N; e += ST_THREADS)
      sm.C[e / N][e % N] = to_f(Cg[(s0 + e / N) * p.cs[1] + e % N]);
    for (int e = tid; e < Q * ST_ROWS; e += ST_THREADS)
      sm.dy[e / ST_ROWS][e % ST_ROWS] = dyg[(s0 + e / ST_ROWS) * p.ys[1] + e % ST_ROWS];
    if (tid < Q) sm.e[tid] = expf(cum[s0 + tid]);
    __syncthreads();
    const float decay = expf(cum[s0 + Q - 1]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tid % 8 + 8 * j;
      ds[((long long)c * DH + d) * N + n] = acc[j];
      float v = 0.f;
      for (int t = 0; t < Q; ++t) v = fmaf(sm.e[t] * sm.dy[t][dl], sm.C[t][n], v);
      acc[j] = fmaf(acc[j], decay, v);
    }
  }
}

// ------------------------------------------------------- every chunk

struct ChunkSmem {
  float X[QMAX][LD], DY[QMAX][LD], Bm[QMAX][LD], Cm[QMAX][LD];
  float Si[DH][LD], So[DH][LD];  // [d][n]
  float G[QMAX][LD], Ml[QMAX][LD], Z[QMAX][LD];  // [t][s]
  float Y[QMAX][LD], Cr[QMAX][LD];               // [s][n], [t][n]
  float cum[QMAX], dt[QMAX], w[QMAX], P[QMAX], zs[QMAX], dcum[QMAX];
  float red[CH_THREADS];
};

template <class T>
__global__ void __launch_bounds__(CH_THREADS) ssm_bwd_chunks(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<ChunkSmem*>(smem_raw);
  const int c = blockIdx.x, b = blockIdx.y, h = blockIdx.z, tid = threadIdx.x;
  const int Q = p.Q;
  const long long bh = (long long)b * p.H + h, s0 = (long long)c * Q;
  const T* x = static_cast<const T*>(p.x) + b * p.xs[0] + h * p.xs[2] + s0 * p.xs[1];
  const T* Bg = static_cast<const T*>(p.B) + b * p.bs[0] + s0 * p.bs[1];
  const T* Cg = static_cast<const T*>(p.C) + b * p.cs[0] + s0 * p.cs[1];
  const float* dy = p.dy + b * p.ys[0] + h * p.ys[2] + s0 * p.ys[1];
  const float* si = p.chunk_state + (bh * p.nc + c) * DH * N;
  const float* so = p.ds + (bh * p.nc + c) * DH * N;

  for (int e = tid; e < Q * DH; e += CH_THREADS) {
    const int t = e / DH, k = e % DH;
    sm.X[t][k] = to_f(x[t * p.xs[1] + k]);
    sm.DY[t][k] = dy[t * p.ys[1] + k];
    sm.Bm[t][k] = to_f(Bg[t * p.bs[1] + k]);
    sm.Cm[t][k] = to_f(Cg[t * p.cs[1] + k]);
  }
  for (int e = tid; e < DH * N; e += CH_THREADS) {
    sm.Si[e / N][e % N] = c > 0 ? si[e] : 0.f;
    sm.So[e / N][e % N] = so[e];
  }
  if (tid < Q) {
    sm.cum[tid] = p.cum[bh * p.S + s0 + tid];
    sm.dt[tid] = p.dt[b * p.ds_[0] + (s0 + tid) * p.ds_[1] + h * p.ds_[2]];
  }
  __syncthreads();
  const float cq = sm.cum[Q - 1];

  // the Q x Q tiles: G, Ml and Z, 0 above the diagonal
  for (int e = tid; e < Q * Q; e += CH_THREADS) {
    const int t = e / Q, s = e % Q;
    float g = 0.f, ml = 0.f, z = 0.f;
    if (s <= t) {
      float cb = 0.f, m = 0.f;
      for (int k = 0; k < N; ++k) cb = fmaf(sm.Cm[t][k], sm.Bm[s][k], cb);
      for (int k = 0; k < DH; ++k) m = fmaf(sm.DY[t][k], sm.X[s][k], m);
      const float E = expf(sm.cum[t] - sm.cum[s]);
      g = cb * E * sm.dt[s];
      ml = m * E * sm.dt[s];
      z = m * cb * E;
    }
    sm.G[t][s] = g;
    sm.Ml[t][s] = ml;
    sm.Z[t][s] = z;
  }
  // the Q x N tiles: Y = dS^T x and the carry-in's exp(cum) S_in^T dy
  for (int e = tid; e < Q * N; e += CH_THREADS) {
    const int s = e / N, n = e % N;
    float y = 0.f, cr = 0.f;
    for (int d = 0; d < DH; ++d) {
      y = fmaf(sm.So[d][n], sm.X[s][d], y);
      cr = fmaf(sm.Si[d][n], sm.DY[s][d], cr);
    }
    sm.Y[s][n] = y;
    sm.Cr[s][n] = expf(sm.cum[s]) * cr;
  }
  if (tid < Q) sm.w[tid] = expf(cq - sm.cum[tid]);
  // <dS, S_in>: each thread's entries in order, then a fixed tree
  float dot = 0.f;
  for (int e = tid; e < DH * N; e += CH_THREADS) dot = fmaf(sm.So[e / N][e % N], sm.Si[e / N][e % N], dot);
  sm.red[tid] = dot;
  __syncthreads();
  for (int half = CH_THREADS / 2; half > 0; half /= 2) {
    if (tid < half) sm.red[tid] += sm.red[tid + half];
    __syncthreads();
  }

  // dx, in x's type
  T* dx = static_cast<T*>(p.dx) + ((b * (long long)p.S + s0) * p.H + h) * DH;
  for (int e = tid; e < Q * DH; e += CH_THREADS) {
    const int s = e / DH, d = e % DH;
    float intra = 0.f, st = 0.f;
    for (int t = s; t < Q; ++t) intra = fmaf(sm.G[t][s], sm.DY[t][d], intra);
    for (int n = 0; n < N; ++n) st = fmaf(sm.So[d][n], sm.Bm[s][n], st);
    store(dx + (long long)s * p.H * DH + d, fmaf(sm.w[s] * sm.dt[s], st, intra));
  }
  // this head's shares of dB and dC
  float* dBh = p.dBh + (bh * p.S + s0) * N;
  float* dCh = p.dCh + (bh * p.S + s0) * N;
  for (int e = tid; e < Q * N; e += CH_THREADS) {
    const int s = e / N, n = e % N;
    float db = 0.f, dc = 0.f;
    for (int t = s; t < Q; ++t) db = fmaf(sm.Ml[t][s], sm.Cm[t][n], db);
    for (int u = 0; u <= s; ++u) dc = fmaf(sm.Ml[s][u], sm.Bm[u][n], dc);
    dBh[(long long)s * N + n] = fmaf(sm.w[s] * sm.dt[s], sm.Y[s][n], db);
    dCh[(long long)s * N + n] = dc + sm.Cr[s][n];
  }
  // each step's terms of ddt and dcum
  if (tid < Q) {
    const int j = tid;
    float zs = 0.f, row = 0.f, P = 0.f, cc = 0.f;
    for (int t = j; t < Q; ++t) zs += sm.Z[t][j];
    for (int s = 0; s <= j; ++s) row = fmaf(sm.Z[j][s], sm.dt[s], row);
    for (int n = 0; n < N; ++n) {
      P = fmaf(sm.Bm[j][n], sm.Y[j][n], P);
      cc = fmaf(sm.Cm[j][n], sm.Cr[j][n], cc);
    }
    sm.zs[j] = zs;
    sm.P[j] = P;
    sm.dcum[j] = (row - sm.dt[j] * zs) + cc - sm.w[j] * sm.dt[j] * P;
  }
  __syncthreads();
  if (tid == 0) {  // the chunk-end terms, the reverse cumsum, ddt and dA's part
    float ends = 0.f;
    for (int s = 0; s < Q; ++s) ends = fmaf(sm.w[s] * sm.dt[s], sm.P[s], ends);
    const float a = p.A[h];
    float dda = 0.f, da = 0.f;
    for (int j = Q - 1; j >= 0; --j) {
      dda += j == Q - 1 ? sm.dcum[j] + (expf(cq) * sm.red[0] + ends) : sm.dcum[j];
      p.ddt[(b * (long long)p.S + s0 + j) * p.H + h] =
          fmaf(a, dda, fmaf(sm.w[j], sm.P[j], sm.zs[j]));
      da = fmaf(sm.dt[j], dda, da);
    }
    p.dApart[bh * p.nc + c] = da;
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
    for (int h = 0; h < p.H; ++h) {
      db += p.dBh[(b * p.H + h) * per_b + sn];
      dc += p.dCh[(b * p.H + h) * per_b + sn];
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
  const int smem = (int)sizeof(ChunkSmem);
  cudaError_t err = cudaFuncSetAttribute(ssm_bwd_chunks<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ssm_bwd_states<T><<<p.Bt * p.H * ST_BLOCKS, ST_THREADS, 0, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssm_bwd_chunks<T><<<dim3(p.nc, p.Bt, p.H), CH_THREADS, smem, s>>>(p);
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
// dBh and dCh (Bt * H * S * N each) and dApart (Bt * H * (S / Q)) are the
// caller's scratch. Writes dx (contiguous, x's shape and type), ddt
// (contiguous (Bt, S, H) float32), dA (H,) float32, and dB and dC
// (contiguous (Bt, S, N), B's type). Three launches on `stream`.
extern "C" int ssm_scan_bwd(const void* x, const float* dt, const float* A, const void* B,
                            const void* C, const float* cum, const float* chunk_state,
                            const float* dy, const float* dstate, float* ds, float* dBh,
                            float* dCh, float* dApart, void* dx, float* ddt, float* dA, void* dB,
                            void* dC, int bf16, int Bt, int H, int S, int dh, int n, int Q,
                            long long xsb, long long xss, long long xsh, long long dsb,
                            long long dss, long long dsh, long long bsb, long long bss,
                            long long csb, long long css, long long ysb, long long yss,
                            long long ysh, void* stream) {
  if (dh != DH || n != N || Bt < 1 || H < 1 || H > 65535 || Bt > 65535 || Q < 1 || Q > QMAX ||
      S < Q || S % Q)
    return (int)cudaErrorInvalidValue;
  const Params p{x,   dt,  A,  B,  C,  cum, chunk_state, dy, dstate, ds, dBh, dCh, dApart,
                 dx,  ddt, dA, dB, dC, {xsb, xss, xsh}, {dsb, dss, dsh}, {bsb, bss}, {csb, css},
                 {ysb, yss, ysh}, Bt, H, S, Q, S / Q};
  return bf16 ? launch<__nv_bfloat16>(p, stream) : launch<float>(p, stream);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
