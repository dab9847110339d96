// The multi-stage super-table walker: one cooperative launch drains a whole
// (stage, start, size) super-table.
//
// Replaces the Pallas kernel repro/kernels/dag_walk.py:dag_walk for four
// programs, whose stage bodies are written out here (repro/vee/apps.py and
// repro/vee/ml_apps.py define them over refs): the linear-regression
// pipeline (moments -> syrk_gemv), the recommendation pipeline (item_norms,
// user_bias -> scores), the MoE expert program (one gated expert FFN per
// slot) and the CC-iteration program (propagate -> changed, the one program
// with an inner axis). Each program also runs batched: up to MAX_MEMBERS members of the
// same program in one table, as the front door's merge_device_lowerings
// builds it, each stage id mapped to its member's pointers and sizes.
//
// Design: a persistent cooperative grid, sized by occupancy. Every CTA
// walks every slot of the table in order; within a slot the CTAs split the
// stage's work between them:
//   * a `sum` stage's output entry e is owned by global thread e (grid
//     stride), the same thread at every slot, which adds the slot's tile
//     contribution to its entry. So each entry folds its per-tile
//     contributions in ascending slot order, starting from what the
//     wrapper put in the output buffer: zeros (guarantee 2 of the Pallas
//     walker), or a resumed checkpoint's prefix accumulator (the seed of
//     a migrated `sum` stage, which replaces the Pallas `_seeded` body of
//     repro/core/preempt.py:migrate_to_device);
//   * a `concat` stage's rows are written once each, one warp per row;
//   * a grid-wide barrier runs before every slot that reads a producer
//     written since the last barrier (the wrapper computes these flags
//     from the table), so a producer is final before a consumer reads it,
//     for `rows` and `full` edges alike (guarantee 1). Producer outputs
//     are read with L1-bypassing loads (__ldcg);
//   * padding slots (size 0) and slots of stages without a body here do
//     nothing (guarantee 3).
// The stage id -> body and stage id -> member maps come from the wrapper:
// stage ids are the table builder's topological order, not assumed here.
// Nothing a member computes depends on the grid size or on the other
// members (each entry has one owner and one order), so a member of a batch
// is bitwise equal to the same lowering walked alone.
//
// Bound on an H100: linreg reads X once (n x d float32) and needs about
// n (d+1)(d+2) flop for one triangle of the symmetric syrk, 2 n (d+1) for
// the gemv and 5 n d for moments and standardizing; at n = 1e6, d = 100
// that is 0.12 ms of bytes and 0.16 ms of fp32 flop. Recommendation reads R once: bytes-bound. This
// first kernel is latency-bound instead: a slot is one 64-row tile and each
// owner thread walks the slots in order, so the time is the number of
// slots times one tile's latency. A two-phase partial-and-fold design is
// the way to the bound.
//
// The CC-iteration program (tests/test_device_dag.py's super-table, the
// body of repro/kernels/cc_propagate.py:propagate_body): `propagate` is a
// concat stage whose slot walks `inner` column tiles, `changed` a sum
// stage counting flipped labels. The Pallas grid's second axis carries
// the running max from one column tile to the next; blocks on Hopper have
// no order, so nothing may carry between them. Here a slot's inner steps
// run inside the slot: the warp that owns a row loops over the column
// tiles in ascending order with 16-byte loads and keeps the running max
// in a register, started from the row's own label. `changed` has one
// owner (warp 0 of CTA 0), which counts a slot's flips and adds them in
// slot order; the `rows` edge is covered by the barrier before the first
// `changed` slot after `propagate` slots. Max and an int32 count are
// exact, so the result is bitwise the plain walk's. Bound: bytes, G read
// once (4 n^2: 1 GiB at n = 16,384, 0.32 ms at 3.35 TB/s), as K2.
//
// The MoE program (repro/vee/ml_apps.py:moe_device_lowering): a slot is
// expert g's fixed-capacity slab, C rows of the dispatch buffer, and the
// body is out = (silu(x wi_g[:, :f]) * (x wi_g[:, f:])) wo_g in fp32. At
// Qwen1.5-MoE-A2.7B's widths (E = 60, C = 342, d = 2048, f = 1408) that is
// 6 E C d f = 3.55e11 flop against 2.4 GB of bytes: operations-bound
// (5.3 ms at 67 TFLOP/s). The weights are indexed by slot (`tile` block
// index), never repeated along the rows. One slab's gated h (C x f) is
// 1.9 MB, far past shared memory, so the body runs in two phases over the
// whole grid: phase 1 writes h into a scratch buffer, a grid barrier,
// phase 2 computes out from it, and a second barrier before the next slot
// reuses the scratch. Every CTA takes 64 x 64 output tiles by grid stride
// (6 x 44 in phase 1, 6 x 32 in phase 2 at full width), so every CTA
// works, where a CTA owning whole rows would keep 43 busy. Each output is
// one thread's fmaf chain over k in ascending order: deterministic, no
// atomics; silu uses IEEE expf and correctly rounded division. This is
// the simple tiled fp32 kernel; wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_MEMBERS = 8;        // BatchPolicy.max_batch

struct Walk {
  const int* table;                   // (n_slots, 3): stage id, start, size
  int n_slots;
  const int* body_of_sid;             // stage id -> body index, -1 = none
  const int* member_of_sid;           // stage id -> batch member
  int n_stages;
  const unsigned char* sync_before;   // per slot: grid barrier first
  int* stamps;                        // (n_slots, 4) or null
  unsigned int* barrier;              // {arrivals, generation}, zeroed
  int tile;                           // rows per slot
};

// Sense-free grid barrier for a cooperative launch: all CTAs are resident.
__device__ void grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ int global_thread() {
  return blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int grid_threads() { return gridDim.x * blockDim.x; }

// First row offset in [0, rows) that global warp `gw` handles at `slot`.
// Rows rotate over the warps slot by slot, so consecutive concat slots
// land on different CTAs.
__device__ __forceinline__ int first_row(int slot, int rows) {
  const int gw = global_thread() >> 5, n_gw = grid_threads() >> 5;
  const int base = (int)(((long long)slot * rows) % n_gw);
  return (gw - base + n_gw) % n_gw;
}

// Sum of col[r * stride] (squared when `square`) over r = 0 .. rows-1, in
// ascending r. Loads go out BATCH at a time (a whole 64-row tile at once) so
// their latencies overlap; the additions stay in row order.
constexpr int BATCH = 64;

__device__ __forceinline__ float column_sum(const float* col, int stride,
                                            int rows, bool square) {
  float s = 0.f;
  for (int r0 = 0; r0 < rows; r0 += BATCH) {
    float v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      v[u] = r0 + u < rows ? col[(size_t)(r0 + u) * stride] : 0.f;
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (r0 + u < rows) s += square ? v[u] * v[u] : v[u];
  }
  return s;
}

// ---------------------------------------------------------------- linreg
constexpr int STAGE = 32;  // loads in flight per thread when staging a tile

struct Linreg {
  struct Args {
    const float* X;        // (n, d)
    const float* y;        // (n,)
    float* moments;        // (2, d) sum output, or null
    const float* mom_in;   // (2, d) moments that syrk_gemv reads
    float* syrk;           // (d+1, d+2) sum output, or null
    int n, d;
  };

  // moments: entry (k, c) sums X[:, c] (k = 0) or X[:, c]^2 (k = 1).
  static __device__ void moments(const Args& a, int row0, int rows) {
    const int d = a.d;
    for (int e = global_thread(); e < 2 * d; e += grid_threads()) {
      const int k = e / d, c = e - k * d;
      const float old = a.moments[e];
      const float s = column_sum(a.X + (size_t)row0 * d + c, d, rows, k);
      a.moments[e] = old + s;
    }
  }

  // syrk_gemv: standardize the tile against the full moments into shared
  // memory, then entry (i, j) sums X1[:, i] * X1[:, j] (j <= d) or
  // X1[:, i] * y (j = d + 1), X1 = [(X - mean) / std, 1].
  static __device__ void syrk(const Args& a, int row0, int rows, float* smem) {
    const int d = a.d, w = d + 1, n_entries = (d + 1) * (d + 2);
    if (blockIdx.x * blockDim.x >= n_entries) return;  // owns no entry
    float* mean = smem;
    float* stdv = mean + d;
    float* xs = stdv + d;          // (rows, d + 1)
    float* ys = xs + rows * w;     // (rows,)
    const int e0 = global_thread();
    const float old = e0 < n_entries ? a.syrk[e0] : 0.f;  // issued early
    __syncthreads();               // the previous slot is done with smem
    const float nf = (float)a.n;
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      const float m = __fdiv_rn(__ldcg(a.mom_in + c), nf);
      const float var = fmaxf(
          __fsub_rn(__fdiv_rn(__ldcg(a.mom_in + d + c), nf), __fmul_rn(m, m)),
          0.f);
      const float sd = __fsqrt_rn(var);
      mean[c] = m;
      stdv[c] = sd == 0.f ? 1.f : sd;
    }
    __syncthreads();
    // stage the tile: each thread's loads go out STAGE at a time
    const int total = rows * d;
    const float* tile = a.X + (size_t)row0 * d;
    for (int base = threadIdx.x; base < total; base += STAGE * blockDim.x) {
      float v[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * blockDim.x;
        v[u] = idx < total ? tile[idx] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * blockDim.x;
        if (idx < total) {
          const int r = idx / d, c = idx - r * d;
          xs[r * w + c] = __fdiv_rn(__fsub_rn(v[u], mean[c]), stdv[c]);
        }
      }
    }
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      xs[r * w + d] = 1.f;
      ys[r] = a.y[row0 + r];
    }
    __syncthreads();
    for (int e = e0; e < n_entries; e += grid_threads()) {
      const int i = e / (d + 2), j = e - i * (d + 2);
      float s = 0.f;
      const float* bj = j <= d ? xs + j : ys;
      const int sj = j <= d ? w : 1;
#pragma unroll 8
      for (int r = 0; r < rows; ++r) s = fmaf(xs[r * w + i], bj[r * sj], s);
      a.syrk[e] = (e == e0 ? old : a.syrk[e]) + s;
    }
  }

  static __device__ int n_rows(const Args& a) { return a.n; }

  static __device__ void run(int body, const Args& a, const Walk& w, int row0,
                             int slot, float* smem) {
    if (body == 0) moments(a, row0, w.tile);
    else syrk(a, row0, w.tile, smem);
  }

  // host side: X, y, moments, mom_in, syrk; n, d
  static constexpr int NP = 5, ND = 2;
  static Args unpack(void* const* p, const int* d) {
    return Args{(const float*)p[0], (const float*)p[1], (float*)p[2],
                (const float*)p[3], (float*)p[4], d[0], d[1]};
  }
  static size_t smem(const Args& a, int tile) {
    return sizeof(float) * (2 * (size_t)a.d + (size_t)tile * (a.d + 1) + tile);
  }
};

// -------------------------------------------------------- recommendation
struct Recommendation {
  struct Args {
    const float* R;          // (n_users, n_items)
    float* item_norms;       // (n_items,) sum output, or null
    float* user_bias;        // (n_users,) concat output, or null
    int* scores;             // (n_users,) concat output, or null
    const float* norms_in;   // item_norms that scores reads
    const float* bias_in;    // user_bias that scores reads
    int n_users, n_items;
  };

  // item_norms: entry c sums R[:, c]^2.
  static __device__ void item_norms(const Args& a, int row0, int rows) {
    const int m = a.n_items;
    for (int c = global_thread(); c < m; c += grid_threads()) {
      const float old = a.item_norms[c];
      const float s = column_sum(a.R + (size_t)row0 * m + c, m, rows, true);
      a.item_norms[c] = old + s;
    }
  }

  // user_bias: row mean, one warp per row (fixed lane order + xor tree).
  static __device__ void user_bias(const Args& a, int row0, int rows,
                                   int slot) {
    const int m = a.n_items, lane = threadIdx.x & 31;
    const int n_gw = grid_threads() >> 5;
    for (int r = first_row(slot, rows); r < rows; r += n_gw) {
      const float* row = a.R + (size_t)(row0 + r) * m;
      float s = 0.f;
#pragma unroll 8
      for (int c = lane; c < m; c += 32) s += row[c];
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) a.user_bias[row0 + r] = __fdiv_rn(s, (float)m);
    }
  }

  // scores: argmax_c R[r, c] / (sqrt(norms[c]) + 1e-9) - bias[r], first
  // index on ties, each operation IEEE-rounded as in the plain version.
  static __device__ void scores(const Args& a, int row0, int rows, int slot) {
    const int m = a.n_items, lane = threadIdx.x & 31;
    const int n_gw = grid_threads() >> 5;
    for (int r = first_row(slot, rows); r < rows; r += n_gw) {
      const float* row = a.R + (size_t)(row0 + r) * m;
      const float bias = __ldcg(a.bias_in + row0 + r);
      float best = -INFINITY;
      int arg = m;
      for (int c = lane; c < m; c += 32) {
        const float den = __fadd_rn(__fsqrt_rn(__ldcg(a.norms_in + c)), 1e-9f);
        const float v = __fsub_rn(__fdiv_rn(row[c], den), bias);
        if (v > best || arg == m) { best = v; arg = c; }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
        if (ob > best || (ob == best && oa < arg)) { best = ob; arg = oa; }
      }
      if (lane == 0) a.scores[row0 + r] = arg;
    }
  }

  static __device__ int n_rows(const Args& a) { return a.n_users; }

  static __device__ void run(int body, const Args& a, const Walk& w, int row0,
                             int slot, float*) {
    if (body == 0) item_norms(a, row0, w.tile);
    else if (body == 1) user_bias(a, row0, w.tile, slot);
    else scores(a, row0, w.tile, slot);
  }

  // host side: R, item_norms, user_bias, scores, norms_in, bias_in;
  // n_users, n_items
  static constexpr int NP = 6, ND = 2;
  static Args unpack(void* const* p, const int* d) {
    return Args{(const float*)p[0], (float*)p[1], (float*)p[2], (int*)p[3],
                (const float*)p[4], (const float*)p[5], d[0], d[1]};
  }
  static size_t smem(const Args&, int) { return 0; }
};

// ------------------------------------------------------------------- moe
constexpr int BM = 64, BN = 64, BK = 16, AP = BM + 4;  // AP: padded A rows

// One BM x BN tile of A (M x K, row-major, lda) times B (K x ldb,
// row-major), k in ascending order. Column c of the shared B tile is global
// column colA + c (c < BN/2) or colB + c - BN/2; a column at or past its
// half's limit, a row at or past M and a k at or past K load as zero.
// Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty*4 + i and shared
// columns {2tx, 2tx+1, BN/2+2tx, BN/2+2tx+1}: acc[i][0..3]. CG reads A
// with L1-bypassing loads (A written earlier in this launch).
template <bool CG>
__device__ void tile_gemm(const float* A, size_t lda, int m0, int M, int K,
                          const float* B, size_t ldb, int colA, int limA,
                          int colB, int limB, float* smem, float acc[4][4]) {
  float* As = smem;             // [BK][AP], the A tile transposed
  float* Bs = smem + BK * AP;   // [BK][BN]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // the previous step (or slot) is done with smem
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK, gr = m0 + r, gk = k0 + kk;
      float v = 0.f;
      if (gr < M && gk < K) {
        const float* p = A + (size_t)gr * lda + gk;
        v = CG ? __ldcg(p) : __ldg(p);
      }
      As[kk * AP + r] = v;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN, c = e % BN, gk = k0 + kk;
      const bool lo = c < BN / 2;
      const int gc = lo ? colA + c : colB + c - BN / 2;
      Bs[kk * BN + c] = gk < K && gc < (lo ? limA : limB)
                            ? __ldg(B + (size_t)gk * ldb + gc) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(As + kk * AP + ty * 4);
      const float2 b0 = *reinterpret_cast<const float2*>(Bs + kk * BN + 2 * tx);
      const float2 b1 =
          *reinterpret_cast<const float2*>(Bs + kk * BN + BN / 2 + 2 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b0.x, b0.y, b1.x, b1.y};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

struct Moe {
  struct Args {
    const float* x;    // (E*C, d) dispatch buffer, expert g's slab at rows g*C
    const float* wi;   // (E, d, 2f)
    const float* wo;   // (E, f, d)
    float* out;        // (E*C, d) concat output
    float* h;          // (C, f) scratch: one slab's gated activations
    int rows, d, f;    // rows = E*C
  };

  static __device__ __forceinline__ float silu_mul(float g, float u) {
    return __fmul_rn(__fdiv_rn(g, __fadd_rn(1.f, expf(-g))), u);
  }

  // experts: out[slab] = (silu(x wi[:, :f]) * (x wi[:, f:])) wo. Every CTA
  // reaches both barriers, tiles or not.
  static __device__ void experts(const Args& a, const Walk& w, int row0,
                                 float* smem) {
    const int C = w.tile, d = a.d, f = a.f, g = row0 / C;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    const float* x = a.x + (size_t)row0 * d;
    const float* wi = a.wi + (size_t)g * d * 2 * f;
    const float* wo = a.wo + (size_t)g * f * d;
    float* out = a.out + (size_t)row0 * d;
    const int tm = (C + BM - 1) / BM;
    float acc[4][4];
    // phase 1: gated column tiles of BN/2: h and its u half side by side
    const int tn1 = (f + BN / 2 - 1) / (BN / 2);
    for (int t = blockIdx.x; t < tm * tn1; t += gridDim.x) {
      const int m0 = (t % tm) * BM, n0 = (t / tm) * (BN / 2);
      tile_gemm<false>(x, d, m0, C, d, wi, 2 * (size_t)f, n0, f, f + n0,
                       2 * f, smem, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int r = m0 + ty * 4 + i, j = n0 + 2 * tx + p;
          if (r < C && j < f) a.h[(size_t)r * f + j] = silu_mul(acc[i][p], acc[i][2 + p]);
        }
    }
    grid_barrier(w.barrier);
    // phase 2: out = h wo
    const int tn2 = (d + BN - 1) / BN;
    for (int t = blockIdx.x; t < tm * tn2; t += gridDim.x) {
      const int m0 = (t % tm) * BM, n0 = (t / tm) * BN;
      tile_gemm<true>(a.h, f, m0, C, f, wo, d, n0, d, n0 + BN / 2, d, smem,
                      acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = m0 + ty * 4 + i;
          const int c = n0 + (j < 2 ? 2 * tx + j : BN / 2 + 2 * tx + j - 2);
          if (r < C && c < d) out[(size_t)r * d + c] = acc[i][j];
        }
    }
    grid_barrier(w.barrier);  // the next slot rewrites h
  }

  static __device__ int n_rows(const Args& a) { return a.rows; }

  static __device__ void run(int, const Args& a, const Walk& w, int row0, int,
                             float* smem) {
    experts(a, w, row0, smem);
  }

  // host side: x, wi, wo, out, h; E*C, d, f
  static constexpr int NP = 5, ND = 3;
  static Args unpack(void* const* p, const int* d) {
    return Args{(const float*)p[0], (const float*)p[1], (const float*)p[2],
                (float*)p[3], (float*)p[4], d[0], d[1], d[2]};
  }
  static size_t smem(const Args&, int) {
    return sizeof(float) * (BK * AP + BK * BN);
  }
};

// -------------------------------------------------------------------- cc
struct Cc {
  struct Args {
    const float* G;        // (n, n) {0, 1} adjacency, or null
    const float* c_col;    // (n,) labels read along a row, or null
    const float* c_row;    // (n,) labels a row starts from / is compared with
    float* propagate;      // (n,) concat output, or null
    int* changed;          // (1,) sum output, or null
    const float* prop_in;  // propagate as `changed` reads it
    int n, tile_c;         // tile_c = n / inner: one inner step's columns
  };

  // propagate: one warp per row; the row's inner steps (column tiles) run
  // in ascending order inside the slot, the running max in a register.
  static __device__ void propagate(const Args& a, int row0, int rows,
                                   int slot) {
    const int n = a.n, lane = threadIdx.x & 31;
    const int n_gw = grid_threads() >> 5;
    const float4* c4 = reinterpret_cast<const float4*>(a.c_col);
    for (int r = first_row(slot, rows); r < rows; r += n_gw) {
      const int row = row0 + r;
      const float4* g4 = reinterpret_cast<const float4*>(a.G + (size_t)row * n);
      float m = __ldg(a.c_row + row);  // inner step 0 seeds the running max
      for (int j0 = 0; j0 < n; j0 += a.tile_c) {
        const int k_end = (j0 + a.tile_c) >> 2;
#pragma unroll 4
        for (int k = (j0 >> 2) + lane; k < k_end; k += 32) {
          const float4 g = __ldcs(g4 + k);
          const float4 c = __ldg(c4 + k);
          m = fmaxf(m, g.x > 0.f ? c.x : 0.f);
          m = fmaxf(m, g.y > 0.f ? c.y : 0.f);
          m = fmaxf(m, g.z > 0.f ? c.z : 0.f);
          m = fmaxf(m, g.w > 0.f ? c.w : 0.f);
        }
      }
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) a.propagate[row] = m;
    }
  }

  // changed: warp 0 of CTA 0 owns the count; it adds each slot's flips in
  // slot order (propagate was written earlier in this launch: __ldcg).
  static __device__ void changed(const Args& a, int row0, int rows) {
    if (global_thread() >= 32) return;
    const int lane = threadIdx.x;
    int flips = 0;
    for (int r = lane; r < rows; r += 32)
      flips += __ldcg(a.prop_in + row0 + r) != __ldg(a.c_row + row0 + r);
    for (int off = 16; off > 0; off >>= 1)
      flips += __shfl_xor_sync(0xffffffffu, flips, off);
    if (lane == 0) a.changed[0] += flips;
  }

  static __device__ int n_rows(const Args& a) { return a.n; }

  static __device__ void run(int body, const Args& a, const Walk& w, int row0,
                             int slot, float*) {
    if (body == 0) propagate(a, row0, w.tile, slot);
    else changed(a, row0, w.tile);
  }

  // host side: G, c_col, c_row, propagate, changed, prop_in; n, tile_c
  static constexpr int NP = 6, ND = 2;
  static Args unpack(void* const* p, const int* d) {
    return Args{(const float*)p[0], (const float*)p[1], (const float*)p[2],
                (float*)p[3], (int*)p[4], (const float*)p[5], d[0], d[1]};
  }
  static size_t smem(const Args&, int) { return 0; }
};

// Per-member arguments of a (possibly batched) walk, by value in the launch.
template <class P>
struct Members {
  typename P::Args m[MAX_MEMBERS];
};

template <class P>
__global__ void __launch_bounds__(THREADS)
walk_kernel(Walk w, Members<P> b) {
  extern __shared__ __align__(16) float smem[];
  for (int i = 0; i < w.n_slots; ++i) {
    const int sid = __ldg(w.table + 3 * i);
    const int start = __ldg(w.table + 3 * i + 1);
    const int size = __ldg(w.table + 3 * i + 2);
    if (w.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
      int* st = w.stamps + 4 * i;
      st[0] = sid; st[1] = start; st[2] = size; st[3] = i;
    }
    if (w.sync_before[i]) grid_barrier(w.barrier);
    if (size <= 0 || sid < 0 || sid >= w.n_stages) continue;
    const int body = __ldg(w.body_of_sid + sid);
    if (body < 0) continue;
    const typename P::Args& a = b.m[__ldg(w.member_of_sid + sid)];
    // the Pallas block index map: the slot's row tile, clamped
    const int n_blocks = max(1, P::n_rows(a) / w.tile);
    const int row0 = min(start / w.tile, n_blocks - 1) * w.tile;
    P::run(body, a, w, row0, i, smem);
  }
}

template <class P>
int launch(const Walk& w, const Members<P>& b, size_t smem, void* stream) {
  auto kernel = walk_kernel<P>;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  Walk wc = w;
  Members<P> bc = b;
  void* args[] = {&wc, &bc};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(per_sm * sms),
                                    dim3(THREADS), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The host side of every entry point: `ptrs` holds P::NP pointers and
// `dims` P::ND sizes for each of the n_members members (host arrays); the
// dynamic shared memory is the largest member's.
template <class P>
int walk(const int* table, int n_slots, const int* body_of_sid,
         const int* member_of_sid, int n_stages,
         const unsigned char* sync_before, int* stamps, unsigned int* barrier,
         int tile, int n_members, void* const* ptrs, const int* dims,
         void* stream) {
  if (n_members < 1 || n_members > MAX_MEMBERS || tile < 1)
    return (int)cudaErrorInvalidValue;
  const Walk w{table, n_slots, body_of_sid, member_of_sid, n_stages,
               sync_before, stamps, barrier, tile};
  Members<P> b{};
  size_t smem = 0;
  for (int m = 0; m < n_members; ++m) {
    b.m[m] = P::unpack(ptrs + m * P::NP, dims + m * P::ND);
    smem = std::max(smem, P::smem(b.m[m], tile));
  }
  return launch<P>(w, b, smem, stream);
}

}  // namespace

#define WALK_ENTRY(NAME, PROGRAM)                                             \
  extern "C" int NAME(const int* table, int n_slots, const int* body_of_sid, \
                      const int* member_of_sid, int n_stages,                \
                      const unsigned char* sync_before, int* stamps,         \
                      unsigned int* barrier, int tile, int n_members,        \
                      void* const* ptrs, const int* dims, void* stream) {    \
    return walk<PROGRAM>(table, n_slots, body_of_sid, member_of_sid,         \
                         n_stages, sync_before, stamps, barrier, tile,       \
                         n_members, ptrs, dims, stream);                     \
  }

WALK_ENTRY(walk_linreg, Linreg)
WALK_ENTRY(walk_recommendation, Recommendation)
WALK_ENTRY(walk_moe, Moe)
WALK_ENTRY(walk_cc, Cc)

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
