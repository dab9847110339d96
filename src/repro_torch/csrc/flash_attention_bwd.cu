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
// end of the keys. dq, dk and dv are rounded to the inputs' type once, at
// the end. Three kernels a call, no atomics, so the bits do not depend on
// the grid: bwd_delta (D, one warp a query row), then a dK/dV kernel and a
// dQ kernel, each routed by the inputs' dtype.
//
// Bound on an H100: operations. At Qwen2-0.5B's training shape (8 x 14
// heads x 2,048 x 64, 2 kv heads, causal) the five products of the
// function (s, dP, dV, dK, dQ) are 1.50e11 flop, 0.15 ms at 989 TFLOP/s of
// bf16 tensor cores, against 0.04 ms of bytes. Both designs recompute s and
// dP in the dQ pass (seven products, 2.10e11 flop, 0.21 ms at that peak),
// which keeps dQ deterministic with no atomics and no waits between CTAs.
//
// bfloat16 (bwd_dkdv_wgmma, bwd_dq_wgmma), which every train step sends,
// runs all seven products on Hopper's tensor cores, from the parts of the
// forward's flash_wgmma (csrc/wgmma_bf16.cuh): wgmma with fp32 accumulators
// in registers, tiles in the no-swizzle core-matrix layout filled by
// cp.async through a two-stage ring paced by mbarriers, and a score
// accumulator rounded in place to the bf16 A fragment of the next product.
//   * dK/dV: a CTA takes one (batch, kv head, 128-key tile), split between
//     two warpgroups of 64 keys. K and V stay in shared memory as bf16 (the
//     A operands). The ring streams, for every query head of the group in
//     order and within it every NQ-row query tile that sees the key tile
//     (causal: from the key tile's first on), the tile's Q and dO with its
//     LSE and D. For each: S^T = K Q^T and dP^T = V dO^T (ss m64nNQk16,
//     depth dh and dv, committed as two groups); P^T = 2^(S^T scale log2 e
//     - lse log2 e) (ex2.approx, relative error under 2^-22), zero where
//     masked, while dP^T is still in flight, then dS^T = P^T (dP^T - D), in
//     fp32 registers; P^T and dS^T rounded to bf16 in place as A fragments;
//     dV += P^T dO and dK += dS^T Q (rs m64n{dv}k16 and m64n{dh}k16; dO and
//     Q MN-major, transposed by the instruction). dK and dV stay in fp32
//     registers across the whole group; dK is scaled at the end. NQ is 128
//     where dh + dv <= 128, 64 up to 256, and 32 at (192, 128), where the
//     accumulators take 96 + 64 registers a thread and the score tiles must
//     shrink to fit (no kernel spills: ptxas gives 176-246 registers).
//   * dQ: a CTA takes one (batch, query head, 128-row query tile), split
//     between two warpgroups of 64 rows, heaviest causal tiles first. Q,
//     dO, LSE and D stay put; K and V tiles of NK keys (128 where dh + dv
//     <= 128, else 64) stream through the ring. For each: S = Q K^T and dP
//     = dO V^T (ss m64nNKk16, two groups, P formed while dP is in flight),
//     dS in registers rounded to bf16 as the A fragment, dQ += dS K (rs
//     m64n{dh}k16, K MN-major).
// Rounding P and dS to bf16 before their products is FA2's and FA3's
// choice, and for P the forward's own before p . v; each product that reads
// a rounded operand moves by at most 2^-8 of its sum of |terms|, the term
// chip_smoke.py:k4_grad_oracle adds to the bf16 limits.
//
// float32 (bwd_dkdv, bwd_dq) stays on fp32 FMA: tensor cores would need
// TF32, which the fp32 limits refuse; nothing on the train path sends it.
// bwd_dkdv takes one (batch, kv head, 64-key tile) and loops over the
// group's query heads and their 64-row query tiles; bwd_dq one (batch,
// query head, 64-row query tile), heaviest causal tiles first. Tiles are
// staged through shared memory as fp32 (padded rows, 16-byte reads); 256
// threads, each owning 4 rows x 4 columns of a 64 x 64 score tile and 4
// rows x (width / 16) output columns; everything fp32 (expf, FMA sums).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"

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

// Rows [row0, row0 + 64) of a (rows, W) fp32 slice into shared memory, row
// stride LD floats; rows at or past n_rows are zero. 16-byte reads.
template <int W, int LD>
__device__ __forceinline__ void stage(float* dst, const float* base, long long row_stride,
                                      int row0, int n_rows) {
  constexpr int PER_ROW = W / 4;
  for (int e = threadIdx.x; e < 64 * PER_ROW; e += THREADS) {
    const int r = e / PER_ROW, cv = (e % PER_ROW) * 4;
    *reinterpret_cast<float4*>(dst + r * LD + cv) =
        row0 + r < n_rows
            ? *reinterpret_cast<const float4*>(base + (long long)(row0 + r) * row_stride + cv)
            : make_float4(0.f, 0.f, 0.f, 0.f);
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
template <int W>
__device__ __forceinline__ void store_rows(float* base, const float (&acc)[4][W / 16], float mult,
                                           int row0, int n_rows, int r, int c) {
  constexpr int NC = W / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * r + i;
    if (row >= n_rows) continue;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj)
      base[(long long)row * W + out_col<NC>(c, jj)] = acc[i][jj] * mult;
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
template <int DH, int DV>
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
  const float* k = static_cast<const float*>(p.k) + b * p.ks.b + kvh * p.ks.h;
  const float* v = static_cast<const float*>(p.v) + b * p.vs.b + kvh * p.vs.h;
  stage<DH, LD>(Ks, k, p.ks.s, k0, p.Skv);
  stage<DV, LDV>(Vs, v, p.vs.s, k0, p.Skv);

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
    const float* q = static_cast<const float*>(p.q) + b * p.qs.b + h * p.qs.h;
    const float* dout = static_cast<const float*>(p.dout) + b * p.dos.b + h * p.dos.h;
    const float* lse = p.lse + ((long long)b * p.H + h) * p.Sq;
    const float* delta = p.delta + ((long long)b * p.H + h) * p.Sq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile is done with Q, dO, P, dS
      stage<DH, LD>(Qs, q, p.qs.s, q0, p.Sq);
      stage<DV, LDV>(dOs, dout, p.dos.s, q0, p.Sq);
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
  float* dk_out = static_cast<float*>(p.dk) + ((long long)b * p.KV + kvh) * p.Skv * DH;
  float* dv_out = static_cast<float*>(p.dv) + ((long long)b * p.KV + kvh) * p.Skv * DV;
  store_rows<DH>(dk_out, dk, p.scale, k0, p.Skv, r, c);
  store_rows<DV>(dv_out, dv, 1.f, k0, p.Skv, r, c);
}

// dQ of one 64-row query tile of one (batch, query head).
template <int DH, int DV>
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
  const float* q = static_cast<const float*>(p.q) + b * p.qs.b + h * p.qs.h;
  const float* dout = static_cast<const float*>(p.dout) + b * p.dos.b + h * p.dos.h;
  const float* k = static_cast<const float*>(p.k) + b * p.ks.b + kvh * p.ks.h;
  const float* v = static_cast<const float*>(p.v) + b * p.vs.b + kvh * p.vs.h;
  stage<DH, LD>(Qs, q, p.qs.s, q0, p.Sq);
  stage<DV, LDV>(dOs, dout, p.dos.s, q0, p.Sq);
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
    stage<DH, LD>(Ks, k, p.ks.s, k0, p.Skv);
    stage<DV, LDV>(Vs, v, p.vs.s, k0, p.Skv);
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
  float* dq_out = static_cast<float*>(p.dq) + (long long)bh * p.Sq * DH;
  store_rows<DH>(dq_out, dq, p.scale, q0, p.Sq, r, c);
}

// delta = D, one warp a row
template <typename T, int DV>
int launch_delta(const Params& p, int B, cudaStream_t stream) {
  bwd_delta<T, DV><<<dim3((p.Sq + THREADS / 32 - 1) / (THREADS / 32), B * p.H), THREADS, 0,
                     stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DH, int DV>
int launch_fp32(const Params& p, int B, cudaStream_t stream) {
  constexpr int LD = DH + 4, LDV = DV + 4;
  cudaError_t err = (cudaError_t)launch_delta<float, DV>(p, B, stream);
  if (err != cudaSuccess) return (int)err;

  constexpr size_t smem_kv =
      sizeof(float) * (BK * LD + BK * LDV + BQ * LD + BQ * LDV + 2 * BK * LP + 2 * BQ);
  auto dkdv = bwd_dkdv<DH, DV>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  dkdv<<<dim3((p.Skv + BK - 1) / BK, B * p.KV), THREADS, smem_kv, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr size_t smem_q =
      sizeof(float) * (BQ * LD + BQ * LDV + BK * LD + BK * LDV + BQ * LP + 2 * BQ);
  auto dq = bwd_dq<DH, DV>;
  err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  dq<<<dim3((p.Sq + BQ - 1) / BQ, B * p.H), THREADS, smem_q, stream>>>(p);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------- bf16 kernels, wgmma

constexpr int WROWS = 64;    // keys (dK/dV) or query rows (dQ) of a warpgroup
constexpr int CROWS = 128;   // ... of a CTA: two warpgroups
constexpr int STAGES = 2;    // ring depth
constexpr float LOG2E = 1.4426950408889634f;

// The dK/dV kernel's query tile and the dQ kernel's key tile: 128 where the
// accumulators are narrow (dh + dv <= 128), else 64; the query tile 32 at
// (192, 128), where dK's and dV's accumulators take 96 + 64 registers a
// thread.
template <int DH, int DV>
constexpr int kv_nq() { return DH + DV > 256 ? 32 : DH + DV > 128 ? 64 : 128; }
template <int DH, int DV>
constexpr int q_nk() { return DH + DV > 128 ? 64 : 128; }

// Descriptors of k-step kk of a K-major operand and k-step j of an MN-major
// one, in a ROWS-row core-matrix tile (see csrc/wgmma_bf16.cuh).
template <int ROWS>
__device__ __forceinline__ uint64_t kmajor(const bf16* tile, int kk) {
  return make_desc(tile + kk * 2 * ROWS * 8, ROWS * 16, 128);
}
template <int ROWS>
__device__ __forceinline__ uint64_t mnmajor(const bf16* tile, int j) {
  return make_desc(tile + j * 16 * 8, 128, ROWS * 16);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// the accumulator entries of columns 16j .. 16j + 15, rounded to bf16: the
// A fragment of k-step j
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4], const float (&d)[N / 2]) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u) a[j][u] = pack_bf16(d[8 * j + 2 * u], d[8 * j + 2 * u + 1]);
}

// rows [row0, row0 + 64) of a contiguous (n_rows, W) bf16 output from a
// warpgroup's m64nWk16 accumulator times mult; rows past n_rows not written
template <int W>
__device__ __forceinline__ void store_acc(bf16* out, const float (&d)[W / 2], float mult,
                                          int row0, int n_rows, int row_a, int col_t) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + row_a + 8 * rr;
    if (row >= n_rows) continue;
#pragma unroll
    for (int n8 = 0; n8 < W / 8; ++n8) {
      const int i = 4 * n8 + 2 * rr;
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * W + 8 * n8 + col_t) =
          __floats2bfloat162_rn(d[i] * mult, d[i + 1] * mult);
    }
  }
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + st, THREADS);
      mbar_init(empty + st, THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// make this thread's landed copies visible to the tensor cores' (async) proxy
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// dK and dV of one 128-key tile of one (batch, kv head); warpgroup wg owns
// keys kw .. kw + 63. Thread t holds S^T entry i at key kw + row_a +
// 8 ((i / 2) % 2) and query q0 + 8 (i / 4) + col_t + i % 2.
template <int DH, int DV, int NQ>
__global__ void __launch_bounds__(THREADS, 1) bwd_dkdv_wgmma(Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // two 64 x DH tiles
  bf16* Vs = Ks + CROWS * DH;                    // two 64 x DV tiles
  bf16* Qs = Vs + CROWS * DV;                    // STAGES x NQ x DH
  bf16* dOs = Qs + STAGES * NQ * DH;             // STAGES x NQ x DV
  float* lse_s = reinterpret_cast<float*>(dOs + STAGES * NQ * DV);  // STAGES x NQ
  float* D_s = lse_s + STAGES * NQ;                                 // STAGES x NQ
  uint64_t* full = reinterpret_cast<uint64_t*>(D_s + STAGES * NQ);
  uint64_t* empty = full + STAGES;

  const int bk = blockIdx.x, b = bk / p.KV, kvh = bk % p.KV;
  const int k0 = (int)blockIdx.y * CROWS;  // causal: tile 0, the heaviest, first
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int row_a = 16 * (t / 32) + (t % 32) / 4;  // and row_a + 8
  const int col_t = 2 * (t % 4);
  const int kw = k0 + WROWS * wg;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.ks.b + kvh * p.ks.h;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.vs.b + kvh * p.vs.h;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.qs.b;
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.dos.b;

  // the ring's items: query tiles qt0 .. n_qt - 1 of each head of the group
  const int n_qt = (p.Sq + NQ - 1) / NQ;
  const int qt0 = p.causal ? min(k0 / NQ, n_qt) : 0;  // the first that sees a key here
  const int per_head = n_qt - qt0, n_items = p.group * per_head;

  init_ring(full, empty);
  auto load_item = [&](int it) {  // this thread's copies of item it
    const int st = it % STAGES, h = kvh * p.group + it / per_head;
    const int q0 = (qt0 + it % per_head) * NQ;
    load_tile<NQ, DH>(Qs + st * NQ * DH, q + h * p.qs.h, p.qs.s, q0, p.Sq);
    load_tile<NQ, DV>(dOs + st * NQ * DV, dout + h * p.dos.h, p.dos.s, q0, p.Sq);
    if (threadIdx.x < 2 * NQ) {  // LSE, then D
      const int r = threadIdx.x % NQ;
      const bool ok = q0 + r < p.Sq;
      const float* src = (threadIdx.x < NQ ? p.lse : p.delta) +
                         ((long long)b * p.H + h) * p.Sq + (ok ? q0 + r : 0);
      cp_async4((threadIdx.x < NQ ? lse_s : D_s) + st * NQ + r, src, ok);
    }
    mbar_arrive_copies(full + st);
  };
  load_tile<WROWS, DH>(Ks, k, p.ks.s, k0, p.Skv);
  load_tile<WROWS, DH>(Ks + WROWS * DH, k, p.ks.s, k0 + WROWS, p.Skv);
  load_tile<WROWS, DV>(Vs, v, p.vs.s, k0, p.Skv);
  load_tile<WROWS, DV>(Vs + WROWS * DV, v, p.vs.s, k0 + WROWS, p.Skv);
  cp_async_commit();
  for (int it = 0; it < STAGES - 1 && it < n_items; ++it) load_item(it);
  cp_async_wait<0>();  // K and V (and the first items) of this thread
  fence_async();
  __syncthreads();     // K and V are visible CTA-wide

  float dk[DH / 2], dv[DV / 2];
  zero(dk);
  zero(dv);
  const bf16* kw_s = Ks + WROWS * DH * wg;
  const bf16* vw_s = Vs + WROWS * DV * wg;
  const float sl2 = p.scale * LOG2E;

  // The two warpgroups meet only at the ring's barriers, as in the forward.
  for (int it = 0; it < n_items; ++it) {
    const int nxt = it + STAGES - 1;
    if (nxt < n_items) {
      if (nxt >= STAGES) mbar_wait(empty + nxt % STAGES, (nxt / STAGES - 1) & 1);
      load_item(nxt);
    }
    const int st = it % STAGES;
    mbar_wait(full + st, (it / STAGES) & 1);
    fence_async();
    const int q0 = (qt0 + it % per_head) * NQ;
    if (kw < p.Skv && (!p.causal || kw <= q0 + NQ - 1)) {  // a key here sees a query
      const bf16* qs = Qs + st * NQ * DH;
      const bf16* dos = dOs + st * NQ * DV;
      const float* lse = lse_s + st * NQ;
      const float* dd = D_s + st * NQ;
      float s[NQ / 2], dp[NQ / 2];
      zero(s);
      zero(dp);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_ss<NQ>(s, kmajor<WROWS>(kw_s, kk), kmajor<NQ>(qs, kk));
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        wgmma_ss<NQ>(dp, kmajor<WROWS>(vw_s, kk), kmajor<NQ>(dos, kk));
      wgmma_commit();
      wgmma_wait<1>();  // S^T; dP^T still in flight
      fence_regs(s);

      // P^T in place, masked where the tile crosses the diagonal or an end
      const bool mask = q0 + NQ > p.Sq || kw + WROWS > p.Skv ||
                        (p.causal && kw + WROWS - 1 > q0);
#pragma unroll
      for (int n8 = 0; n8 < NQ / 8; ++n8) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse + 8 * n8 + col_t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * n8 + e;
          float pr = ex2(fmaf(s[i], sl2, -(e % 2 ? l2.y : l2.x) * LOG2E));
          if (mask) {
            const int kpos = kw + row_a + 8 * (e / 2), qpos = q0 + 8 * n8 + col_t + e % 2;
            if (qpos >= p.Sq || kpos >= p.Skv || (p.causal && kpos > qpos)) pr = 0.f;
          }
          s[i] = pr;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int n8 = 0; n8 < NQ / 8; ++n8) {  // dS^T in place
        const float2 d2 = *reinterpret_cast<const float2*>(dd + 8 * n8 + col_t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * n8 + e] = s[4 * n8 + e] * (dp[4 * n8 + e] - (e % 2 ? d2.y : d2.x));
      }
      uint32_t pa[NQ / 16][4], da[NQ / 16][4];
      to_a<NQ>(pa, s);
      to_a<NQ>(da, dp);
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NQ / 16; ++j) wgmma_rs<DV>(dv, pa[j], mnmajor<NQ>(dos, j));
#pragma unroll
      for (int j = 0; j < NQ / 16; ++j) wgmma_rs<DH>(dk, da[j], mnmajor<NQ>(qs, j));
      wgmma_commit();
      wgmma_wait();
      fence_regs(dv);
      fence_regs(dk);
    }
    mbar_arrive(empty + st);  // this thread is done with item it
  }

  const long long bk_off = (long long)b * p.KV + kvh;
  store_acc<DH>(static_cast<bf16*>(p.dk) + bk_off * p.Skv * DH, dk, p.scale, kw, p.Skv,
                row_a, col_t);
  store_acc<DV>(static_cast<bf16*>(p.dv) + bk_off * p.Skv * DV, dv, 1.f, kw, p.Skv,
                row_a, col_t);
}

// dQ of one 128-row query tile of one (batch, query head); warpgroup wg
// owns rows qw .. qw + 63. Thread t holds S entry i at row qw + row_a +
// 8 ((i / 2) % 2) and key k0 + 8 (i / 4) + col_t + i % 2.
template <int DH, int DV, int NK>
__global__ void __launch_bounds__(THREADS, 1) bwd_dq_wgmma(Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // two 64 x DH tiles
  bf16* dOs = Qs + CROWS * DH;                   // two 64 x DV tiles
  bf16* Ks = dOs + CROWS * DV;                   // STAGES x NK x DH
  bf16* Vs = Ks + STAGES * NK * DH;              // STAGES x NK x DV
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + STAGES * NK * DV);
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H, kvh = h / p.group;
  const int n_qt = (p.Sq + CROWS - 1) / CROWS;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * CROWS;  // heaviest tiles first
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int row_a = 16 * (t / 32) + (t % 32) / 4;
  const int col_t = 2 * (t % 4);
  const int qw = q0 + WROWS * wg;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.qs.b + h * p.qs.h;
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.dos.b + h * p.dos.h;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.ks.b + kvh * p.ks.h;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.vs.b + kvh * p.vs.h;

  int n_kt = (p.Skv + NK - 1) / NK, my_kt = n_kt;
  if (p.causal) {
    n_kt = min(n_kt, (min(q0 + CROWS, p.Sq) - 1) / NK + 1);
    my_kt = qw < p.Sq ? min(n_kt, (min(qw + WROWS, p.Sq) - 1) / NK + 1) : 0;
  } else if (qw >= p.Sq) {
    my_kt = 0;
  }

  init_ring(full, empty);
  auto load_kv = [&](int kt) {  // this thread's copies of tile kt
    const int st = kt % STAGES;
    load_tile<NK, DH>(Ks + st * NK * DH, k, p.ks.s, kt * NK, p.Skv);
    load_tile<NK, DV>(Vs + st * NK * DV, v, p.vs.s, kt * NK, p.Skv);
    mbar_arrive_copies(full + st);
  };
  load_tile<WROWS, DH>(Qs, q, p.qs.s, q0, p.Sq);
  load_tile<WROWS, DH>(Qs + WROWS * DH, q, p.qs.s, q0 + WROWS, p.Sq);
  load_tile<WROWS, DV>(dOs, dout, p.dos.s, q0, p.Sq);
  load_tile<WROWS, DV>(dOs + WROWS * DV, dout, p.dos.s, q0 + WROWS, p.Sq);
  cp_async_commit();
  for (int kt = 0; kt < STAGES - 1 && kt < n_kt; ++kt) load_kv(kt);
  // this thread's two rows' LSE (times log2 e) and D; rows past the end 0
  float lse2[2], dd[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = qw + row_a + 8 * rr;
    const long long at = ((long long)b * p.H + h) * p.Sq + row;
    lse2[rr] = row < p.Sq ? p.lse[at] * LOG2E : 0.f;
    dd[rr] = row < p.Sq ? p.delta[at] : 0.f;
  }
  cp_async_wait<0>();  // Q and dO (and the first tiles) of this thread
  fence_async();
  __syncthreads();     // Q and dO are visible CTA-wide

  float dq[DH / 2];
  zero(dq);
  const bf16* qw_s = Qs + WROWS * DH * wg;
  const bf16* dow_s = dOs + WROWS * DV * wg;
  const float sl2 = p.scale * LOG2E;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int nxt = kt + STAGES - 1;
    if (nxt < n_kt) {
      if (nxt >= STAGES) mbar_wait(empty + nxt % STAGES, (nxt / STAGES - 1) & 1);
      load_kv(nxt);
    }
    const int st = kt % STAGES;
    mbar_wait(full + st, (kt / STAGES) & 1);
    fence_async();
    if (kt < my_kt) {
      const int k0 = kt * NK;
      const bf16* ks = Ks + st * NK * DH;
      const bf16* vs = Vs + st * NK * DV;
      float s[NK / 2], dp[NK / 2];
      zero(s);
      zero(dp);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_ss<NK>(s, kmajor<WROWS>(qw_s, kk), kmajor<NK>(ks, kk));
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        wgmma_ss<NK>(dp, kmajor<WROWS>(dow_s, kk), kmajor<NK>(vs, kk));
      wgmma_commit();
      wgmma_wait<1>();  // S; dP still in flight
      fence_regs(s);

      const bool mask = k0 + NK > p.Skv || (p.causal && k0 + NK - 1 > qw);
#pragma unroll
      for (int i = 0; i < NK / 2; ++i) {  // P in place
        const int rr = (i / 2) % 2;
        float pr = ex2(fmaf(s[i], sl2, -lse2[rr]));
        if (mask) {
          const int kpos = k0 + 8 * (i / 4) + col_t + i % 2, qpos = qw + row_a + 8 * rr;
          if (kpos >= p.Skv || (p.causal && kpos > qpos)) pr = 0.f;
        }
        s[i] = pr;
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < NK / 2; ++i) s[i] *= dp[i] - dd[(i / 2) % 2];  // dS in place
      uint32_t da[NK / 16][4];
      to_a<NK>(da, s);
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NK / 16; ++j) wgmma_rs<DH>(dq, da[j], mnmajor<NK>(ks, j));
      wgmma_commit();
      wgmma_wait();
      fence_regs(dq);
    }
    mbar_arrive(empty + st);  // this thread is done with tile kt
  }

  if (qw >= p.Sq) return;
  store_acc<DH>(static_cast<bf16*>(p.dq) + (long long)bh * p.Sq * DH, dq, p.scale, qw, p.Sq,
                row_a, col_t);
}

template <int DH, int DV>
int launch_bf16(const Params& p, int B, cudaStream_t stream) {
  cudaError_t err = (cudaError_t)launch_delta<bf16, DV>(p, B, stream);
  if (err != cudaSuccess) return (int)err;

  constexpr int NQ = kv_nq<DH, DV>();
  constexpr size_t smem_kv = sizeof(bf16) * (CROWS + STAGES * NQ) * (DH + DV)
                             + sizeof(float) * 2 * STAGES * NQ + 2 * STAGES * sizeof(uint64_t);
  auto dkdv = bwd_dkdv_wgmma<DH, DV, NQ>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  dkdv<<<dim3(B * p.KV, (p.Skv + CROWS - 1) / CROWS), THREADS, smem_kv, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr int NK = q_nk<DH, DV>();
  constexpr size_t smem_q = sizeof(bf16) * (CROWS + STAGES * NK) * (DH + DV)
                            + 2 * STAGES * sizeof(uint64_t);
  auto dq = bwd_dq_wgmma<DH, DV, NK>;
  err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  dq<<<dim3(B * p.H, (p.Sq + CROWS - 1) / CROWS), THREADS, smem_q, stream>>>(p);
  return (int)cudaGetLastError();
}

// routing by dtype: bfloat16 on wgmma, float32 on fp32 FMA
template <int DH, int DV>
int launch_typed(const Params& p, int B, int bf16_in, void* stream) {
  return bf16_in ? launch_bf16<DH, DV>(p, B, (cudaStream_t)stream)
                 : launch_fp32<DH, DV>(p, B, (cudaStream_t)stream);
}

}  // namespace

// q (B, H, Sq, dh), k (B, KV, Skv, dh), v (B, KV, Skv, dv) and dout (B, H,
// Sq, dv), each with element strides (batch, head, seq), a contiguous last
// axis and 16-byte aligned rows; o: the forward's contiguous output; lse
// and delta: contiguous fp32 (B, H, Sq), delta scratch; dq, dk, dv:
// contiguous, written whole. bf16 != 0: bfloat16 tensors, else float32.
// (dh, dv) one of the forward's six compiled pairs, (96, 96) among them (dh
// + dv = 192: NQ and NK 64, as at (112, 112)); the wrapper zero-pads any
// other width to the smallest pair that covers it, and passes the true
// width's scale, so the padded columns of dq, dk and dv come out 0.
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
  if (dh == 96 && dvw == 96) return launch_typed<96, 96>(p, B, bf16, stream);
  if (dh == 112 && dvw == 112) return launch_typed<112, 112>(p, B, bf16, stream);
  if (dh == 128 && dvw == 128) return launch_typed<128, 128>(p, B, bf16, stream);
  if (dh == 192 && dvw == 128) return launch_typed<192, 128>(p, B, bf16, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
