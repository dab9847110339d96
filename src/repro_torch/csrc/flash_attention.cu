// Flash-attention forward (K4): causal or non-causal online-softmax
// attention over (B, H, Sq, dh) queries, (B, KV, Skv, dh) keys and
// (B, KV, Skv, dv) values; dv may differ from dh (MLA: q/k 192, v 128).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:flash_attention
// (and the GQA expansion of repro/kernels/ops.py:attention). The function is
// the Pallas kernel's, step for step:
//   s = (q . k^T in fp32) * scale (1 / sqrt(dh), passed in: a call the wrapper
//       zero-pads keeps its unpadded width's), masked with -1e30
//       (key > query, or past the end of the keys);
//   m, l, acc in fp32; per kv tile m' = max(m, rowmax s), p = exp(s - m'),
//   corr = exp(m - m'), l = l corr + rowsum p (the unrounded p),
//   acc = acc corr + (p rounded to v's type) . v in fp32;
//   out = acc / max(l, 1e-30), rounded to q's type.
// Causal kv tiles wholly above the diagonal are skipped: key 0 is always
// visible, so m is finite after the first tile, and a masked tile adds
// exp(-1e30 - m) = 0 with corr = 1, which changes nothing. Only a tile that
// crosses the diagonal or the end of the keys is masked. GQA: query head h
// reads kv head h / (H / KV) in place, without the reference's repeat.
//
// Bound on an H100: operations. At Granite-8B's prefill (4 x 32 heads x
// 2,048 x 128, 8 kv heads, causal) the two products are 1.37e11 flop,
// 0.14 ms at 989 TFLOP/s of bf16 tensor cores, against 0.05 ms of bytes
// (q, k, v read once, out written once).
//
// The bf16 kernel (flash_wgmma), which serves every prefill, runs both
// products on Hopper's tensor cores:
//   * a CTA takes 128 query rows of one (batch, head): two consumer
//     warpgroups of 64 rows each, sharing the K/V tiles. CTAs are ordered
//     heaviest causal q tile first over all heads;
//   * S = Q K^T is wgmma m64n128k16 with Q and a 128-key K tile in shared
//     memory (K-major); O += P V is wgmma m64n{dv}k16 with P in registers
//     (the S accumulator's layout is the A fragment's, so P is rounded to
//     bf16 in place) and the V tile in shared memory (MN-major, transposed
//     by the instruction), fp32 accumulators in registers;
//   * K/V tiles come through a two-stage ring in shared memory, filled with
//     cp.async (16-byte copies, zero-filled past the end) one tile ahead.
//     mbarriers, not CTA barriers, pace the ring: a stage is `full` when
//     every thread's copies have landed and `empty` when every thread is
//     done with it, so one warpgroup's softmax can run beside the other's
//     products. Tiles are stored in the no-swizzle core-matrix layout
//     wgmma reads: 16-byte chunk c of row r at byte (c * rows + r) * 16, so
//     neighbouring threads fill neighbouring chunks without bank conflicts,
//     and _split_heads' strided views are read in place (cp.async rather
//     than TMA: a plain C interface with no driver-API tensor maps);
//   * the online softmax runs on the accumulator fragments between the two
//     products: each thread holds 2 rows x 64 keys of S, row max and sum
//     over the 4 threads of a row by shuffles; exp(x) is ex2.approx of
//     x log2 e (relative error under 2^-21), inside the 2^-16 fp32 term of
//     the kernel's limit against its float64 oracle.
// Built for (dh, dv) in (16, 16), (64, 64), (96, 96) (the train_lm
// example's ~100M configuration: 768 over 8 heads), (112, 112) (Zamba2-7B's
// shared attention), (128, 128) (every dense config) and (192, 128)
// (DeepSeek-V2-Lite's MLA); the wrapper zero-pads any other width up to
// (192, 128) to the smallest of these that covers it and passes the true
// width's scale. Its staging, descriptors, products and ring barriers are in
// csrc/wgmma_bf16.cuh, shared with the backward.
//
// The fp32 kernel (flash_fwd) keeps fp32 FMA: tensor cores would need
// TF32, which the fp32 path's limits refuse; nothing on the serving path
// sends it fp32. One CTA per (b.h, 64-row q tile); the q tile, then each
// 64-row K tile and V tile are staged through shared memory as fp32; 256
// threads, each owning 4 query rows x 4 keys of a score tile (row max and
// sum by shuffles over the 16 threads of a row group) and 4 rows x dv/16
// output columns, with m, l and acc in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 256;
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, h, s;  // elements; the last (dh) axis is contiguous
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;              // contiguous (B, H, Sq, dv)
  float* lse;           // contiguous (B, H, Sq), m + log l of each row, or null
  Strides qs, ks, vs;
  int H, group;         // query heads, query heads per kv head
  int Sq, Skv, causal;
  float scale;
};

// ------------------------------------------------------------ fp32 kernel

// Rows [row0, row0 + 64) of a (rows, W) fp32 slice into shared memory, row
// stride LD; rows at or past n_rows load as zero. 16-byte loads.
template <int W, int LD>
__device__ __forceinline__ void stage(float* dst, const float* base,
                                      long long row_stride, int row0,
                                      int n_rows) {
  constexpr int PER_ROW = W / 4;
  for (int e = threadIdx.x; e < 64 * PER_ROW; e += THREADS) {
    const int r = e / PER_ROW, cv = (e % PER_ROW) * 4;
    *reinterpret_cast<float4*>(dst + r * LD + cv) =
        row0 + r < n_rows
            ? *reinterpret_cast<const float4*>(base + (long long)(row0 + r) * row_stride + cv)
            : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Output column of a thread's jj-th accumulator (NC = dv / 16 of them):
// four neighbouring columns per 64 when NC is a multiple of 4 (dv 64 and
// 128: float4 reads of a V row), else one per 16 (dv 16 and 112).
template <int NC>
__device__ __forceinline__ int out_col(int c, int jj) {
  if constexpr (NC % 4 == 0) return (jj / 4) * 64 + 4 * c + (jj % 4);
  else return c + 16 * jj;
}

template <int DH, int DV>
__global__ void __launch_bounds__(THREADS, 2) flash_fwd(Params p) {
  constexpr int LD = DH + 4;   // padded rows (116 floats at dh 112): conflict-
  constexpr int LDV = DV + 4;  // free, 16-byte aligned float4 reads
  constexpr int LKV = LD > LDV ? LD : LDV;
  constexpr int LP = BK + 4;
  constexpr int NC = DV / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // BQ x LD
  float* KVs = Qs + BQ * LD;   // BK x LD: the K tile, then BK x LDV: the V tile
  float* Ps = KVs + BK * LKV;  // BQ x LP: p

  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H, kvh = h / p.group;
  const float* q = static_cast<const float*>(p.q) + b * p.qs.b + h * p.qs.h;
  const float* k = static_cast<const float*>(p.k) + b * p.ks.b + kvh * p.ks.h;
  const float* v = static_cast<const float*>(p.v) + b * p.vs.b + kvh * p.vs.h;
  const int q0 = qt * BQ;
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;  // rows 4r.., keys c+16j

  stage<DH, LD>(Qs, q, p.qs.s, q0, p.Sq);
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) acc[i][jj] = 0.f;
  }
  int n_kt = (p.Skv + BK - 1) / BK;
  if (p.causal) {  // the last kv tile holding a key the tile's last row sees
    const int last = min(q0 + BQ, p.Sq) - 1;
    n_kt = min(n_kt, last / BK + 1);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is done with K/V and P
    stage<DH, LD>(KVs, k, p.ks.s, k0, p.Skv);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (4 * r + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(KVs + (c + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
    // scale, mask, and the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * r + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + c + 16 * j;
        float x = s[i][j] * p.scale;
        if (kpos >= p.Skv || (p.causal && kpos > qpos)) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        s[i][j] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();  // every thread is done reading the K tile
    stage<DV, LDV>(KVs, v, p.vs.s, k0, p.Skv);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(4 * r + i) * LP + c + 16 * j] = s[i][j];
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(Ps + (4 * r + i) * LP + kk);
        pv[i][0] = t.x; pv[i][1] = t.y; pv[i][2] = t.z; pv[i][3] = t.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = KVs + (kk + u) * LDV;
        float vv[NC];
        if constexpr (NC % 4 == 0) {
#pragma unroll
          for (int g = 0; g < NC / 4; ++g) {
            const float4 t = *reinterpret_cast<const float4*>(vrow + g * 64 + 4 * c);
            vv[4 * g] = t.x; vv[4 * g + 1] = t.y; vv[4 * g + 2] = t.z; vv[4 * g + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int jj = 0; jj < NC; ++jj) vv[jj] = vrow[out_col<NC>(c, jj)];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < NC; ++jj) acc[i][jj] = fmaf(pv[i][u], vv[jj], acc[i][jj]);
      }
    }
  }

  float* o = static_cast<float*>(p.o) + ((long long)b * p.H + h) * p.Sq * DV;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * r + i;
    if (row >= p.Sq) continue;
    if (p.lse != nullptr && c == 0)
      p.lse[((long long)b * p.H + h) * p.Sq + row] = m[i] + logf(l[i]);
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NC; ++jj)
      o[(long long)row * DV + out_col<NC>(c, jj)] = acc[i][jj] / den;
  }
}

template <int DH, int DV>
int launch_fp32(const Params& p, int B, void* stream) {
  constexpr int LKV = DH > DV ? DH + 4 : DV + 4;
  constexpr size_t smem = sizeof(float) * (BQ * (DH + 4) + BK * LKV + BQ * (BK + 4));
  auto kernel = flash_fwd<DH, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, B * p.H);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ bf16 kernel, wgmma

constexpr int WQ = 128;      // query rows a CTA: two warpgroups of 64
constexpr int WK = 128;      // keys a K/V tile
constexpr int STAGES = 2;    // K/V ring depth

// D (64 x DV) += P V: P's bf16 A fragment in registers, the V tile MN-major
template <int DV>
__device__ __forceinline__ void wgmma_pv(float (&d)[DV / 2], const uint32_t (&a)[4],
                                         uint64_t b) {
  wgmma_rs<DV>(d, a, b);
}

// Accumulator fragment of m64nNk16 (fp32): thread t of the warpgroup holds
// entry i at row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2) and column
// 8 (i / 4) + 2 (t % 4) + i % 2.
template <int DH, int DV>
__global__ void __launch_bounds__(THREADS, 1) flash_wgmma(Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // two 64 x DH tiles
  bf16* Ks = Qs + WQ * DH;                       // STAGES x WK x DH
  bf16* Vs = Ks + STAGES * WK * DH;              // STAGES x WK x DV
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + STAGES * WK * DV);
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H, kvh = h / p.group;
  const int n_qt = (p.Sq + WQ - 1) / WQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * WQ;  // heaviest tiles first
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.qs.b + h * p.qs.h;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.ks.b + kvh * p.ks.h;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.vs.b + kvh * p.vs.h;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int row_a = 16 * (t / 32) + (t % 32) / 4;  // and row_a + 8
  const int col_t = 2 * (t % 4);
  const int qw = q0 + 64 * wg;                       // the warpgroup's first row

  int n_kt = (p.Skv + WK - 1) / WK, my_kt = n_kt;
  if (p.causal) {
    n_kt = min(n_kt, (min(q0 + WQ, p.Sq) - 1) / WK + 1);
    my_kt = qw < p.Sq ? min(n_kt, (min(qw + 64, p.Sq) - 1) / WK + 1) : 0;
  } else if (qw >= p.Sq) {
    my_kt = 0;
  }

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + st, THREADS);
      mbar_init(empty + st, THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_kv = [&](int kt) {  // this thread's copies of tile kt
    const int st = kt % STAGES;
    load_tile<WK, DH>(Ks + st * WK * DH, k, p.ks.s, kt * WK, p.Skv);
    load_tile<WK, DV>(Vs + st * WK * DV, v, p.vs.s, kt * WK, p.Skv);
    mbar_arrive_copies(full + st);
  };
  load_tile<64, DH>(Qs, q, p.qs.s, q0, p.Sq);
  load_tile<64, DH>(Qs + 64 * DH, q, p.qs.s, q0 + 64, p.Sq);
  cp_async_commit();
  for (int kt = 0; kt < STAGES - 1 && kt < n_kt; ++kt) load_kv(kt);
  cp_async_wait<0>();  // Q (and the first tiles) of this thread
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();     // Q is visible CTA-wide

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  const bf16* qw_s = Qs + 64 * DH * wg;

  // The two warpgroups meet only at the ring's barriers: a tile's copies
  // wait until both are done with the tile STAGES - 1 before it, so one
  // warpgroup may run up to STAGES - 1 tiles ahead of the other and its
  // softmax overlaps the other's products.
  for (int kt = 0; kt < n_kt; ++kt) {
    const int nxt = kt + STAGES - 1;  // the tile whose copies go out now
    if (nxt < n_kt) {
      if (nxt >= STAGES) mbar_wait(empty + nxt % STAGES, (nxt / STAGES - 1) & 1);
      load_kv(nxt);
    }
    mbar_wait(full + kt % STAGES, (kt / STAGES) & 1);
    // make the copies visible to the tensor cores' (async) proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (kt < my_kt) {
      const int k0 = kt * WK;
      const bf16* ks = Ks + (kt % STAGES) * WK * DH;
      const bf16* vs = Vs + (kt % STAGES) * WK * DV;
      float s[WK / 2];
#pragma unroll
      for (int i = 0; i < WK / 2; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)  // chunks 2kk, 2kk + 1 of dh
        wgmma_ss_n128(s, make_desc(qw_s + kk * 2 * 64 * 8, 64 * 16, 128),
                      make_desc(ks + kk * 2 * WK * 8, WK * 16, 128));
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);

      // scale, mask where the tile crosses the diagonal or the key end, and
      // the online-softmax update of the thread's two rows
      const bool mask = k0 + WK > p.Skv || (p.causal && k0 + WK - 1 > qw);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < WK / 2; ++i) {
        float x = s[i] * p.scale;
        if (mask) {
          const int qpos = qw + row_a + 8 * ((i / 2) % 2);
          const int kpos = k0 + 8 * (i / 4) + col_t + i % 2;
          if (kpos >= p.Skv || (p.causal && kpos > qpos)) x = NEG_INF;
        }
        s[i] = x;
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
      }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {  // a row lives on the 4 threads of a quad
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        mx[rr] = fmaxf(m[rr], mx[rr]);  // m'
      }
#pragma unroll
      for (int i = 0; i < WK / 2; ++i) {
        const float e = exp2_(s[i] - mx[(i / 2) % 2]);
        s[i] = e;
        sum[(i / 2) % 2] += e;
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 1);
        sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 2);
        corr[rr] = exp2_(m[rr] - mx[rr]);
        l[rr] = l[rr] * corr[rr] + sum[rr];
        m[rr] = mx[rr];
      }
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] *= corr[(i / 2) % 2];
      // p rounded to bf16: the S fragment of keys 16j.. is the A fragment
      uint32_t a[WK / 16][4];
#pragma unroll
      for (int j = 0; j < WK / 16; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) a[j][u] = pack_bf16(s[8 * j + 2 * u], s[8 * j + 2 * u + 1]);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < WK / 16; ++j)  // keys 16j.. are rows 2j, 2j + 1 of 8
        wgmma_pv<DV>(o, a[j], make_desc(vs + j * 2 * 8 * 8, 128, WK * 16));
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
    }
    mbar_arrive(empty + kt % STAGES);  // this thread is done with tile kt
  }

  if (qw >= p.Sq) return;
  bf16* out = static_cast<bf16*>(p.o) + ((long long)b * p.H + h) * p.Sq * DV;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = qw + row_a + 8 * rr;
    if (row >= p.Sq) continue;
    if (p.lse != nullptr && t % 4 == 0)
      p.lse[((long long)b * p.H + h) * p.Sq + row] = m[rr] + logf(l[rr]);
    const float den = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int n8 = 0; n8 < DV / 8; ++n8) {
      const int i = 4 * n8 + 2 * rr;
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * DV + 8 * n8 + col_t) =
          __floats2bfloat162_rn(o[i] / den, o[i + 1] / den);
    }
  }
}

template <int DH, int DV>
int launch_bf16(const Params& p, int B, void* stream) {
  constexpr size_t smem = sizeof(bf16) * (WQ * DH + STAGES * WK * (DH + DV))
                          + 2 * STAGES * sizeof(uint64_t);
  auto kernel = flash_wgmma<DH, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * p.H, (p.Sq + WQ - 1) / WQ);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DH, int DV>
int launch(const Params& p, int B, int bf16_in, void* stream) {
  return bf16_in ? launch_bf16<DH, DV>(p, B, stream) : launch_fp32<DH, DV>(p, B, stream);
}

}  // namespace

// q: (B, H, Sq, dh), k: (B, KV, Skv, dh), v: (B, KV, Skv, dv), each with
// element strides (batch, head, seq) and a contiguous last axis, 16-byte
// aligned rows; out: contiguous (B, H, Sq, dv); lse: null, or contiguous
// fp32 (B, H, Sq) that gets each row's log-sum-exp m + log l (what the
// backward, csrc/flash_attention_bwd.cu, recomputes P from; the output is
// the same either way). bf16 != 0: bfloat16 tensors, else float32.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, void* lse, int bf16, int B, int H, int KV,
                               int Sq, int Skv, int dh, int dv, long long qsb,
                               long long qsh, long long qss, long long ksb,
                               long long ksh, long long kss, long long vsb,
                               long long vsh, long long vss, int causal,
                               float scale, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV || Sq < 1 || Skv < 1 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, out, static_cast<float*>(lse), {qsb, qsh, qss}, {ksb, ksh, kss},
                 {vsb, vsh, vss}, H, H / KV, Sq, Skv, causal, scale};
  if (dh == 16 && dv == 16) return launch<16, 16>(p, B, bf16, stream);
  if (dh == 64 && dv == 64) return launch<64, 64>(p, B, bf16, stream);
  if (dh == 96 && dv == 96) return launch<96, 96>(p, B, bf16, stream);
  if (dh == 112 && dv == 112) return launch<112, 112>(p, B, bf16, stream);
  if (dh == 128 && dv == 128) return launch<128, 128>(p, B, bf16, stream);
  if (dh == 192 && dv == 128) return launch<192, 128>(p, B, bf16, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
