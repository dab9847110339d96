// Flash-attention backward (K4's gradient): dq, dk and dv of the attention
// that csrc/flash_attention.cu computes, from the forward's output o and
// each query row's log-sum-exp lse = m + log l (fp32, written by the
// forward when a gradient is needed).
//
// The JAX package has no backward kernel: jax.value_and_grad differentiates
// its chunked attention (repro/models/attention.py:chunked_attention, the
// jnp twin of the Pallas kernel repro/kernels/flash_attention.py:
// flash_attention) op by op. This kernel computes the gradient of the same
// function, softmax(q k^T * scale, causal mask) v with GQA (query head h
// reads kv head h / (H / KV)) and dv != dh, by the standard recurrences:
//   D_i   = rowsum(dO_i * O_i)                          (pre-pass)
//   P_ij  = exp(s_ij * scale - lse_i), 0 where masked   (recomputed)
//   dV_j  = sum_i P_ij dO_i
//   dP_ij = dO_i . V_j,  dS_ij = P_ij (dP_ij - D_i)
//   dK_j  = scale sum_i dS_ij Q_i,  dQ_i = scale sum_j dS_ij K_j
// with the forward's mask: key j > query i (positions shared), or past the
// end of the keys. Everything is fp32 (inputs converted exactly, FMA sums,
// expf); dq, dk and dv are rounded to the inputs' type once, at the end.
//
// Three kernels, no atomics, so the bits do not depend on the grid:
//   * bwd_delta: D, one warp a query row;
//   * bwd_dkdv: one CTA a (batch, kv head, 64-key tile); it loops over the
//     query heads of the kv head's group in order and, for each, over the
//     64-row query tiles that see the key tile (causal: from the key
//     tile's own on), recomputing P and dS, and accumulates dK and dV of
//     its keys in registers. The group's sum is thus taken in one fixed
//     order inside the CTA;
//   * bwd_dq: one CTA a (batch, query head, 64-row query tile), heaviest
//     causal tiles first; it loops over the key tiles the rows see,
//     recomputing P and dS, and accumulates dQ in registers.
// Each CTA stages its tiles through shared memory as fp32 (padded rows,
// 16-byte reads); 256 threads, each owning 4 rows x 4 columns of a 64 x 64
// score tile (as the fp32 forward) and 4 rows x (width / 16) output
// columns.
//
// Bound on an H100: operations. At Qwen2-0.5B's training shape (8 x 14
// heads x 2,048 x 64, 2 kv heads, causal) the five products of the
// function (s, dP, dV, dK, dQ) are 1.50e11 flop, 0.15 ms at 989 TFLOP/s of
// bf16 tensor cores, against 0.04 ms of bytes. This design recomputes s and
// dP in the dQ pass (seven products, 2.10e11 flop) and runs them on fp32
// FMA (67 TFLOP/s), so its own floor is 3.1 ms: the tensor-core version
// (wgmma, TMA) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 256;
constexpr int LP = BK + 4;  // padded rows of the 64 x 64 P / dS tiles

struct Strides {
  long long b, h, s;  // elements; the last axis is contiguous
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;      // contiguous (B, H, Sq, dv), the forward's output
  const void* dout;   // (B, H, Sq, dv), strides dos
  const float* lse;   // contiguous (B, H, Sq)
  float* delta;       // contiguous (B, H, Sq), written by bwd_delta
  void* dq;           // contiguous (B, H, Sq, dh)
  void* dk;           // contiguous (B, KV, Skv, dh)
  void* dv;           // contiguous (B, KV, Skv, dv)
  Strides qs, ks, vs, dos;
  int H, KV, group;   // query heads, kv heads, query heads per kv head
  int Sq, Skv, causal;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

// Rows [row0, row0 + 64) of a (rows, W) slice of T into shared memory as
// fp32, row stride LD floats; rows at or past n_rows are zero. 16-byte
// global reads (4 floats or 8 bf16).
template <typename T, int W, int LD>
__device__ __forceinline__ void stage(float* dst, const T* base, long long row_stride,
                                      int row0, int n_rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = W / VEC;
  for (int e = threadIdx.x; e < 64 * PER_ROW; e += THREADS) {
    const int r = e / PER_ROW, cv = (e % PER_ROW) * VEC;
    float vals[VEC];
    if (row0 + r < n_rows) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * row_stride + cv);
      const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) vals[i] = to_f(t[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) vals[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(dst + r * LD + cv + i) =
          make_float4(vals[i], vals[i + 1], vals[i + 2], vals[i + 3]);
  }
}

// Output column of a thread's jj-th accumulator (NC = W / 16 of them), as
// in the fp32 forward: four neighbouring columns per 64 when NC is a
// multiple of 4 (float4 reads of a row), else one per 16.
template <int NC>
__device__ __forceinline__ int out_col(int c, int jj) {
  if constexpr (NC % 4 == 0) return (jj / 4) * 64 + 4 * c + (jj % 4);
  else return c + 16 * jj;
}

// s[i][j] = A[4r + i] . B[c + 16 j] over W columns, both fp32 tiles in
// shared memory with row stride LD.
template <int W, int LD>
__device__ __forceinline__ void tile_dots(float (&s)[4][4], const float* A, const float* B,
                                          int r, int c) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < W; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(A + (4 * r + i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(B + (c + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

// acc[i][jj] += sum_x M[4r + i][x] * R[x][out_col(c, jj)] over the 64
// columns x of the 64 x 64 tile M (row stride LP) and the 64 rows of R
// (W wide, row stride LD), in order of x.
template <int W, int LD>
__device__ __forceinline__ void tile_accumulate(float (&acc)[4][W / 16], const float* M,
                                                const float* R, int r, int c) {
  constexpr int NC = W / 16;
#pragma unroll 2
  for (int x = 0; x < 64; x += 4) {
    float mv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 t = *reinterpret_cast<const float4*>(M + (4 * r + i) * LP + x);
      mv[i][0] = t.x; mv[i][1] = t.y; mv[i][2] = t.z; mv[i][3] = t.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* row = R + (x + u) * LD;
      float rv[NC];
      if constexpr (NC % 4 == 0) {
#pragma unroll
        for (int g = 0; g < NC / 4; ++g) {
          const float4 t = *reinterpret_cast<const float4*>(row + g * 64 + 4 * c);
          rv[4 * g] = t.x; rv[4 * g + 1] = t.y; rv[4 * g + 2] = t.z; rv[4 * g + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < NC; ++jj) rv[jj] = row[out_col<NC>(c, jj)];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < NC; ++jj) acc[i][jj] = fmaf(mv[i][u], rv[jj], acc[i][jj]);
    }
  }
}

// Rows [row0, row0 + 64) of a contiguous (rows, W) output, from a thread's
// accumulators times mult; rows at or past n_rows are not written.
template <typename T, int W>
__device__ __forceinline__ void store_rows(T* base, const float (&acc)[4][W / 16], float mult,
                                           int row0, int n_rows, int r, int c) {
  constexpr int NC = W / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * r + i;
    if (row >= n_rows) continue;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj)
      from_f(base + (long long)row * W + out_col<NC>(c, jj), acc[i][jj] * mult);
  }
}

// D = rowsum(dO * O) in fp32, one warp a row of (B, H, Sq).
template <typename T, int DV>
__global__ void __launch_bounds__(THREADS) bwd_delta(Params p) {
  const long long row = (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  if (row >= p.Sq) return;
  const T* dout = static_cast<const T*>(p.dout) + b * p.dos.b + h * p.dos.h + row * p.dos.s;
  const T* o = static_cast<const T*>(p.o) + ((long long)bh * p.Sq + row) * DV;
  float sum = 0.f;
  for (int x = threadIdx.x % 32; x < DV; x += 32) sum = fmaf(to_f(dout[x]), to_f(o[x]), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (threadIdx.x % 32 == 0) p.delta[(long long)bh * p.Sq + row] = sum;
}

// dK and dV of one 64-key tile of one (batch, kv head).
template <typename T, int DH, int DV>
__global__ void __launch_bounds__(THREADS, (DH + DV > 128 ? 1 : 2)) bwd_dkdv(Params p) {
  constexpr int LD = DH + 4, LDV = DV + 4;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;               // BK x LD
  float* Vs = Ks + BK * LD;       // BK x LDV
  float* Qs = Vs + BK * LDV;      // BQ x LD
  float* dOs = Qs + BQ * LD;      // BQ x LDV
  float* Ps = dOs + BQ * LDV;     // BK x LP: P^T (key rows, query columns)
  float* dSs = Ps + BK * LP;      // BK x LP: dS^T
  float* lse_s = dSs + BK * LP;   // BQ
  float* D_s = lse_s + BQ;        // BQ

  const int kt = blockIdx.x, bk = blockIdx.y, b = bk / p.KV, kvh = bk % p.KV;
  const int k0 = kt * BK;
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
  const T* k = static_cast<const T*>(p.k) + b * p.ks.b + kvh * p.ks.h;
  const T* v = static_cast<const T*>(p.v) + b * p.vs.b + kvh * p.vs.h;
  stage<T, DH, LD>(Ks, k, p.ks.s, k0, p.Skv);
  stage<T, DV, LDV>(Vs, v, p.vs.s, k0, p.Skv);

  float dk[4][DH / 16], dv[4][DV / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int jj = 0; jj < DH / 16; ++jj) dk[i][jj] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DV / 16; ++jj) dv[i][jj] = 0.f;
  }
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int qt0 = p.causal ? k0 / BQ : 0;  // the first query tile that sees a key here

  for (int hh = 0; hh < p.group; ++hh) {
    const int h = kvh * p.group + hh;
    const T* q = static_cast<const T*>(p.q) + b * p.qs.b + h * p.qs.h;
    const T* dout = static_cast<const T*>(p.dout) + b * p.dos.b + h * p.dos.h;
    const float* lse = p.lse + ((long long)b * p.H + h) * p.Sq;
    const float* delta = p.delta + ((long long)b * p.H + h) * p.Sq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile is done with Q, dO, P, dS
      stage<T, DH, LD>(Qs, q, p.qs.s, q0, p.Sq);
      stage<T, DV, LDV>(dOs, dout, p.dos.s, q0, p.Sq);
      if (threadIdx.x < BQ) {
        const bool ok = q0 + threadIdx.x < p.Sq;
        lse_s[threadIdx.x] = ok ? lse[q0 + threadIdx.x] : 0.f;
        D_s[threadIdx.x] = ok ? delta[q0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_dots<DH, LD>(s, Ks, Qs, r, c);     // s^T: key 4r + i, query c + 16 j
      tile_dots<DV, LDV>(dp, Vs, dOs, r, c);  // dP^T
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + 4 * r + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = c + 16 * j, qpos = q0 + qi;
          const bool ok = kpos < p.Skv && qpos < p.Sq && (!p.causal || kpos <= qpos);
          const float pr = ok ? expf(s[i][j] * p.scale - lse_s[qi]) : 0.f;
          Ps[(4 * r + i) * LP + qi] = pr;
          dSs[(4 * r + i) * LP + qi] = pr * (dp[i][j] - D_s[qi]);
        }
      }
      __syncthreads();
      tile_accumulate<DV, LDV>(dv, Ps, dOs, r, c);
      tile_accumulate<DH, LD>(dk, dSs, Qs, r, c);
    }
  }
  T* dk_out = static_cast<T*>(p.dk) + ((long long)b * p.KV + kvh) * p.Skv * DH;
  T* dv_out = static_cast<T*>(p.dv) + ((long long)b * p.KV + kvh) * p.Skv * DV;
  store_rows<T, DH>(dk_out, dk, p.scale, k0, p.Skv, r, c);
  store_rows<T, DV>(dv_out, dv, 1.f, k0, p.Skv, r, c);
}

// dQ of one 64-row query tile of one (batch, query head).
template <typename T, int DH, int DV>
__global__ void __launch_bounds__(THREADS, (DH + DV > 128 ? 1 : 2)) bwd_dq(Params p) {
  constexpr int LD = DH + 4, LDV = DV + 4;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // BQ x LD
  float* dOs = Qs + BQ * LD;      // BQ x LDV
  float* Ks = dOs + BQ * LDV;     // BK x LD
  float* Vs = Ks + BK * LD;       // BK x LDV
  float* dSs = Vs + BK * LDV;     // BQ x LP
  float* lse_s = dSs + BQ * LP;   // BQ
  float* D_s = lse_s + BQ;        // BQ

  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H, kvh = h / p.group;
  const int q0 = qt * BQ;
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
  const T* q = static_cast<const T*>(p.q) + b * p.qs.b + h * p.qs.h;
  const T* dout = static_cast<const T*>(p.dout) + b * p.dos.b + h * p.dos.h;
  const T* k = static_cast<const T*>(p.k) + b * p.ks.b + kvh * p.ks.h;
  const T* v = static_cast<const T*>(p.v) + b * p.vs.b + kvh * p.vs.h;
  stage<T, DH, LD>(Qs, q, p.qs.s, q0, p.Sq);
  stage<T, DV, LDV>(dOs, dout, p.dos.s, q0, p.Sq);
  if (threadIdx.x < BQ) {
    const bool ok = q0 + threadIdx.x < p.Sq;
    lse_s[threadIdx.x] = ok ? p.lse[(long long)bh * p.Sq + q0 + threadIdx.x] : 0.f;
    D_s[threadIdx.x] = ok ? p.delta[(long long)bh * p.Sq + q0 + threadIdx.x] : 0.f;
  }
  float dq[4][DH / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DH / 16; ++jj) dq[i][jj] = 0.f;
  int n_kt = (p.Skv + BK - 1) / BK;
  if (p.causal) n_kt = min(n_kt, (min(q0 + BQ, p.Sq) - 1) / BK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is done with K, V, dS
    stage<T, DH, LD>(Ks, k, p.ks.s, k0, p.Skv);
    stage<T, DV, LDV>(Vs, v, p.vs.s, k0, p.Skv);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dots<DH, LD>(s, Qs, Ks, r, c);     // query 4r + i, key c + 16 j
    tile_dots<DV, LDV>(dp, dOs, Vs, r, c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = 4 * r + i, qpos = q0 + qi;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + c + 16 * j;
        const bool ok = kpos < p.Skv && qpos < p.Sq && (!p.causal || kpos <= qpos);
        const float pr = ok ? expf(s[i][j] * p.scale - lse_s[qi]) : 0.f;
        dSs[qi * LP + c + 16 * j] = pr * (dp[i][j] - D_s[qi]);
      }
    }
    __syncthreads();
    tile_accumulate<DH, LD>(dq, dSs, Ks, r, c);
  }
  T* dq_out = static_cast<T*>(p.dq) + (long long)bh * p.Sq * DH;
  store_rows<T, DH>(dq_out, dq, p.scale, q0, p.Sq, r, c);
}

template <typename T, int DH, int DV>
int launch(const Params& p, int B, void* stream_) {
  const cudaStream_t stream = (cudaStream_t)stream_;
  constexpr int LD = DH + 4, LDV = DV + 4;
  bwd_delta<T, DV><<<dim3((p.Sq + THREADS / 32 - 1) / (THREADS / 32), B * p.H), THREADS, 0,
                     stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr size_t smem_kv =
      sizeof(float) * (BK * LD + BK * LDV + BQ * LD + BQ * LDV + 2 * BK * LP + 2 * BQ);
  auto dkdv = bwd_dkdv<T, DH, DV>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  dkdv<<<dim3((p.Skv + BK - 1) / BK, B * p.KV), THREADS, smem_kv, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr size_t smem_q =
      sizeof(float) * (BQ * LD + BQ * LDV + BK * LD + BK * LDV + BQ * LP + 2 * BQ);
  auto dq = bwd_dq<T, DH, DV>;
  err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  dq<<<dim3((p.Sq + BQ - 1) / BQ, B * p.H), THREADS, smem_q, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DH, int DV>
int launch_typed(const Params& p, int B, int bf16_in, void* stream) {
  return bf16_in ? launch<__nv_bfloat16, DH, DV>(p, B, stream)
                 : launch<float, DH, DV>(p, B, stream);
}

}  // namespace

// q (B, H, Sq, dh), k (B, KV, Skv, dh), v (B, KV, Skv, dv) and dout (B, H,
// Sq, dv), each with element strides (batch, head, seq), a contiguous last
// axis and 16-byte aligned rows; o: the forward's contiguous output; lse
// and delta: contiguous fp32 (B, H, Sq), delta scratch; dq, dk, dv:
// contiguous, written whole. bf16 != 0: bfloat16 tensors, else float32.
// Three launches (delta, dk/dv, dq) on `stream`.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv, int bf16,
                                   int B, int H, int KV, int Sq, int Skv, int dh, int dvw,
                                   long long qsb, long long qsh, long long qss,
                                   long long ksb, long long ksh, long long kss,
                                   long long vsb, long long vsh, long long vss,
                                   long long dsb, long long dsh, long long dss, int causal,
                                   float scale, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV || Sq < 1 || Skv < 1 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, dout, static_cast<const float*>(lse),
                 static_cast<float*>(delta), dq, dk, dv,
                 {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss}, {dsb, dsh, dss},
                 H, KV, H / KV, Sq, Skv, causal, scale};
  if (dh == 16 && dvw == 16) return launch_typed<16, 16>(p, B, bf16, stream);
  if (dh == 64 && dvw == 64) return launch_typed<64, 64>(p, B, bf16, stream);
  if (dh == 112 && dvw == 112) return launch_typed<112, 112>(p, B, bf16, stream);
  if (dh == 128 && dvw == 128) return launch_typed<128, 128>(p, B, bf16, stream);
  if (dh == 192 && dvw == 128) return launch_typed<192, 128>(p, B, bf16, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
