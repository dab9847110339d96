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
// Design: a persistent cooperative grid, sized by occupancy. The wrapper's
// fold plan (kernels/dag_walk.py:fold_plan, numpy the CPU tests check) cuts
// the table into segments at the grid barriers it needs: a barrier runs
// before every slot that reads a producer written since the last barrier,
// so a producer is final before a consumer reads it, for `rows` and `full`
// edges alike (guarantee 1 of the Pallas walker). In each segment:
//   * every CTA walks the segment's `concat` slots (and the int `sum` of
//     the CC program) in table order. A `concat` stage's rows are written
//     once each, one warp per row; the CC count has one owner, which adds
//     each slot's flips in slot order. Producer outputs are read with
//     L1-bypassing loads (__ldcg);
//   * a float `sum` stage runs in two phases. Phase 1, partials: its
//     slots are cut into groups of g consecutive stage-local ordinals
//     (ordinal k in group k / g), g set by the stage's slot count alone
//     (about FOLD_GROUPS = 512 groups). The CTAs take the segment's pieces
//     of groups by grid stride; a CTA folds a piece's slots in ascending
//     order into the group's partial, CTA-wide with coalesced reads and
//     each thread's accumulators in registers, and stores it to a scratch
//     buffer (n_groups, entries) the wrapper allocates. A group whose
//     slots straddle a barrier continues from the partial its earlier
//     piece stored. Phase 2, the fold: at the first barrier before a slot
//     that reads the stage, or at the launch end when nothing in the
//     launch reads it, each entry's owner computes
//     out = buffer + partial_0 + partial_1 + ... in ascending group order,
//     and a second barrier publishes the sums. `buffer` holds what the
//     wrapper put there: zeros, or a resumed checkpoint's prefix
//     accumulator (the seed of a migrated `sum` stage, which replaces the
//     Pallas `_seeded` body of repro/core/preempt.py:migrate_to_device);
//   * padding slots (size 0) and slots of stages without a body here do
//     nothing (guarantee 3).
// What stays true:
//   * the sum order holds at both levels: slots (and the rows of each slot)
//     fold in ascending order within a group, then groups fold in
//     ascending order, starting from the seed (guarantee 2 of the Pallas
//     walker, at two levels);
//   * results do not depend on the grid: the groups, the pieces and every
//     addition's order come from the table alone; the grid only decides
//     which CTA computes a piece. So a member of a batch is bitwise equal
//     to its lowering walked alone, the stagewise walk to the fused walk,
//     and a seeded walk to the migrated entry point's;
//   * a term passes through at most (group rows + number of groups)
//     additions, fewer than the slot-at-a-time fold's;
//   * a walk of a table prefix (core/preempt.py:run_device_prefix) folds
//     at its launch end, so it reads the prefix accumulator.
// The stage id -> body and stage id -> member maps come from the wrapper:
// stage ids are the table builder's topological order, not assumed here.
//
// Bound on an H100: linreg reads X once (n x d float32) and needs about
// n (d+1)(d+2) flop for one triangle of the symmetric syrk, 2 n (d+1) for
// the gemv and 5 n d for moments and standardizing; at n = 1e6, d = 100
// that is 0.12 ms of bytes and 0.16 ms of fp32 flop (operations-bound).
// A linreg piece stages each slot's tile (its rows are contiguous in X)
// into shared memory with cp.async, the next slot's copy in flight while
// the CTA works on this one; `moments` gives each of d <= 256 threads a
// column. The syrk body computes the upper triangle of 4 x 4 blocks of the
// (d+1) x (d+2) output (two blocks a thread at d = 100), reads each row of
// the standardized tile as float4s from shared memory and mirrors the lower
// triangle when it stores a partial: fmaf(a, b, s) = fmaf(b, a, s), so the
// mirror is the value the entry's own chain would give. Recommendation
// reads R (65,536 x 2,048 float32) three times: bytes-bound. `item_norms`
// gives each thread 8 columns 256 apart and 8 rows of loads in flight.
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

#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_MEMBERS = 8;        // BatchPolicy.max_batch

struct Walk {
  const int* table;                   // (n_slots, 3): stage id, start, size
  int n_slots;
  // the fold plan (kernels/dag_walk.py:FoldPlan), slices of one int32 array
  const int* body_of_sid;             // stage id -> body index, -1 = none
  const int* member_of_sid;           // stage id -> batch member
  const int* walk;                    // slots walked one at a time
  const int* walk_ptr;                // (n_seg + 1)
  const int* pieces;                  // (n_pieces, 5): inst, group, first, count, cont
  const int* piece_ptr;               // (n_seg + 1)
  const int* piece_slots;             // each piece's slots, ascending
  const int* fold_inst;               // instances folded at a segment start
  const int* fold_ptr;                // (n_seg + 2): the last is the launch end
  const int* inst;                    // (n_inst, 4): sid, n_groups, offset, entries
  int n_seg;
  float* scratch;                     // every instance's (n_groups, entries)
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

// The first row of the tile a slot names: the Pallas block index map,
// start / tile clamped to the last whole tile of n_rows.
__device__ __forceinline__ int slot_row0(const Walk& w, int slot, int n_rows) {
  const int n_blocks = max(1, n_rows / w.tile);
  return min(__ldg(w.table + 3 * slot + 1) / w.tile, n_blocks - 1) * w.tile;
}


// ---------------------------------------------------------------- linreg
constexpr int NB = 2;  // syrk 4 x 4 blocks a thread holds in a pass

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// n floats at src (global) to dst (shared), asynchronously: 16-byte copies
// where both ends are 16-byte aligned and n is a multiple of 4, else 4-byte.
__device__ __forceinline__ void copy_async(float* dst, const float* src, int n) {
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0
      && (n & 3) == 0) {
    for (int e = threadIdx.x; e < n / 4; e += blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(smem_u32(dst + 4 * e)), "l"(src + 4 * e) : "memory");
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   :: "r"(smem_u32(dst + e)), "l"(src + e) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct Linreg {
  struct Args {
    const float* X;        // (n, d)
    const float* y;        // (n,)
    float* moments;        // (2, d) sum output, or null
    const float* mom_in;   // (2, d) moments that syrk_gemv reads
    float* syrk;           // (d+1, d+2) sum output, or null
    int n, d;
  };

  // Shared memory of a piece: two raw tiles (tile x d, the rows are
  // contiguous in X) and their y, filled with cp.async one slot ahead; then
  // mean, std and the standardized tile z (tile x ld) for syrk_gemv.
  struct Smem {
    float* raw[2];
    float* ys[2];
    float* mean;
    float* stdv;
    float* z;
    int ld;
  };

  static __device__ Smem carve(const Args& a, int tile, float* smem) {
    const int d = a.d, td = (tile * d + 3) & ~3, ty = (tile + 3) & ~3;
    Smem s;
    s.raw[0] = smem;
    s.raw[1] = smem + td;
    s.ys[0] = smem + 2 * td;
    s.ys[1] = s.ys[0] + ty;
    s.mean = s.ys[1] + ty;
    s.stdv = s.mean + ((d + 3) & ~3);
    s.z = s.stdv + ((d + 3) & ~3);
    s.ld = (d + 2 + 3) & ~3;
    return s;
  }

  // Slot k's tile (and its y when `with_y`) into buffer k & 1.
  static __device__ void fetch(const Args& a, const Walk& w, const Smem& sm,
                               const int* slots, int k, bool with_y) {
    const int row0 = slot_row0(w, __ldg(slots + k), a.n);
    copy_async(sm.raw[k & 1], a.X + (size_t)row0 * a.d, w.tile * a.d);
    if (with_y) copy_async(sm.ys[k & 1], a.y + row0, w.tile);
  }

  // moments: entry (k, c) sums X[:, c] (k = 0) or X[:, c]^2 (k = 1). Thread
  // c owns column c's two accumulators and adds the staged tiles' rows in
  // ascending order; the next slot's tile is in flight meanwhile.
  static __device__ void moments_piece(const Args& a, const Walk& w,
                                       const int* slots, int count, bool cont,
                                       float* part, float* smem) {
    const int d = a.d, tile = w.tile, c = threadIdx.x;
    const Smem sm = carve(a, tile, smem);
    float s = 0.f, q = 0.f;
    if (cont && c < d) {
      s = __ldcg(part + c);
      q = __ldcg(part + d + c);
    }
    __syncthreads();  // the previous piece is done with shared memory
    fetch(a, w, sm, slots, 0, false);
    for (int k = 0; k < count; ++k) {
      copy_wait();
      __syncthreads();  // tile k is visible; every thread is done with k - 1
      if (k + 1 < count) fetch(a, w, sm, slots, k + 1, false);
      if (c < d) {
        const float* col = sm.raw[k & 1] + c;
#pragma unroll 8
        for (int r = 0; r < tile; ++r) {
          const float v = col[r * d];
          s += v;
          q = fmaf(v, v, q);
        }
      }
    }
    if (c < d) {
      part[c] = s;
      part[d + c] = q;
    }
  }

  // syrk_gemv: entry (i, j) sums z[:, i] * z[:, j] over the rows, z the
  // row [X1 | y] with X1 = [(X - mean) / std, 1] standardized against the
  // full moments (IEEE-rounded divide, subtract and square root, as the
  // plain version). Each slot's staged tile is standardized into z; thread
  // t owns the upper-triangle 4 x 4 blocks t, t + THREADS, ... (NB of them
  // a pass; more passes only past d = 124) and keeps their sums in
  // registers across the piece's rows.
  static __device__ void syrk_piece(const Args& a, const Walk& w,
                                    const int* slots, int count, bool cont,
                                    float* part, float* smem) {
    const int d = a.d, tile = w.tile, nz = d + 2;
    const Smem sm = carve(a, tile, smem);
    const int ld = sm.ld;
    const int nbi = (d + 1 + 3) / 4, nbj = (nz + 3) / 4;
    const int n_blocks = nbi * nbj - nbi * (nbi - 1) / 2;  // jb >= ib
    __syncthreads();  // the previous piece is done with shared memory
    const float nf = (float)a.n;
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      const float m = __fdiv_rn(__ldcg(a.mom_in + c), nf);
      const float var = fmaxf(
          __fsub_rn(__fdiv_rn(__ldcg(a.mom_in + d + c), nf), __fmul_rn(m, m)),
          0.f);
      const float sd = __fsqrt_rn(var);
      sm.mean[c] = m;
      sm.stdv[c] = sd == 0.f ? 1.f : sd;
    }
    for (int pass = 0; pass < n_blocks; pass += NB * THREADS) {
      int bi[NB], bj[NB];
      float acc[NB][4][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        int t = pass + nb * THREADS + threadIdx.x, ib = 0;
        while (ib < nbi && t >= nbj - ib) { t -= nbj - ib; ++ib; }
        bi[nb] = ib < nbi ? 4 * ib : -1;   // -1: no block
        bj[nb] = ib < nbi ? 4 * (ib + t) : 0;
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int i = bi[nb] + ii, j = bj[nb] + jj;
            acc[nb][ii][jj] = cont && bi[nb] >= 0 && i <= d && j < nz
                                  ? __ldcg(part + (size_t)i * nz + j) : 0.f;
          }
      }
      __syncthreads();  // z and the buffers are free (the previous pass)
      fetch(a, w, sm, slots, 0, true);
      for (int k = 0; k < count; ++k) {
        copy_wait();
        __syncthreads();  // tile k is visible; every thread is done with z
        if (k + 1 < count) fetch(a, w, sm, slots, k + 1, true);
        const float* raw = sm.raw[k & 1];
        for (int idx = threadIdx.x, r = idx / d, c = idx - r * d; idx < tile * d;
             idx += blockDim.x) {
          sm.z[r * ld + c] = __fdiv_rn(__fsub_rn(raw[idx], sm.mean[c]), sm.stdv[c]);
          c += blockDim.x;  // the next element: blockDim.x further
          while (c >= d) { c -= d; ++r; }
        }
        for (int r = threadIdx.x; r < tile; r += blockDim.x) {
          sm.z[r * ld + d] = 1.f;
          sm.z[r * ld + d + 1] = sm.ys[k & 1][r];
          for (int c = nz; c < ld; ++c) sm.z[r * ld + c] = 0.f;
        }
        __syncthreads();  // z holds tile k
#pragma unroll 4
        for (int r = 0; r < tile; ++r) {
          const float* zr = sm.z + r * ld;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            if (bi[nb] < 0) continue;
            const float4 p = *reinterpret_cast<const float4*>(zr + bi[nb]);
            const float4 q = *reinterpret_cast<const float4*>(zr + bj[nb]);
            const float pv[4] = {p.x, p.y, p.z, p.w}, qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
            for (int ii = 0; ii < 4; ++ii)
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
                acc[nb][ii][jj] = fmaf(pv[ii], qv[jj], acc[nb][ii][jj]);
          }
        }
      }
      // store the partial, and the mirror of an off-diagonal block
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        if (bi[nb] < 0) continue;
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int i = bi[nb] + ii, j = bj[nb] + jj;
            if (i > d || j >= nz) continue;
            part[(size_t)i * nz + j] = acc[nb][ii][jj];
            if (bj[nb] > bi[nb] && j <= d) part[(size_t)j * nz + i] = acc[nb][ii][jj];
          }
      }
    }
  }

  static __device__ int n_rows(const Args& a) { return a.n; }

  // linreg has no concat body: both stages fold
  static __device__ void run(int, const Args&, const Walk&, int, int, float*) {}

  static __device__ void piece(int body, const Args& a, const Walk& w,
                               const int* slots, int count, bool cont,
                               float* part, float* smem) {
    if (body == 0) moments_piece(a, w, slots, count, cont, part, smem);
    else syrk_piece(a, w, slots, count, cont, part, smem);
  }

  static __device__ float* sum_out(int body, const Args& a) {
    return body == 0 ? a.moments : a.syrk;
  }

  // host side: X, y, moments, mom_in, syrk; n, d
  static constexpr int NP = 5, ND = 2;
  static Args unpack(void* const* p, const int* d) {
    return Args{(const float*)p[0], (const float*)p[1], (float*)p[2],
                (const float*)p[3], (float*)p[4], d[0], d[1]};
  }
  static size_t smem(const Args& a, int tile) {
    const size_t d = a.d, td = (tile * d + 3) & ~(size_t)3, ty = (tile + 3) & ~3;
    return sizeof(float) * (2 * td + 2 * ty + 2 * ((d + 3) & ~(size_t)3)
                            + (size_t)tile * ((d + 2 + 3) & ~(size_t)3));
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

  // item_norms: entry c sums R[:, c]^2. Thread t owns columns t + k
  // THREADS (k < COLS) of each 2,048-column chunk; RB rows of loads go out
  // at once (COLS * RB in flight), the rows in ascending order.
  static constexpr int COLS = 8, RB = 8;

  static __device__ void norms_piece(const Args& a, const Walk& w,
                                     const int* slots, int count, bool cont,
                                     float* part) {
    const int m = a.n_items, tile = w.tile;
    for (int c0 = 0; c0 < m; c0 += COLS * THREADS) {
      float acc[COLS];
#pragma unroll
      for (int u = 0; u < COLS; ++u) {
        const int c = c0 + u * THREADS + threadIdx.x;
        acc[u] = cont && c < m ? __ldcg(part + c) : 0.f;
      }
      for (int k = 0; k < count; ++k) {
        const float* base =
            a.R + (size_t)slot_row0(w, __ldg(slots + k), a.n_users) * m + c0 + threadIdx.x;
        for (int r0 = 0; r0 < tile; r0 += RB) {
          float v[RB][COLS];
#pragma unroll
          for (int rr = 0; rr < RB; ++rr)
#pragma unroll
            for (int u = 0; u < COLS; ++u)
              v[rr][u] = r0 + rr < tile && c0 + u * THREADS + (int)threadIdx.x < m
                             ? __ldg(base + (size_t)(r0 + rr) * m + u * THREADS) : 0.f;
#pragma unroll
          for (int rr = 0; rr < RB; ++rr)
#pragma unroll
            for (int u = 0; u < COLS; ++u) acc[u] = fmaf(v[rr][u], v[rr][u], acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < COLS; ++u) {
        const int c = c0 + u * THREADS + threadIdx.x;
        if (c < m) part[c] = acc[u];
      }
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
    if (body == 1) user_bias(a, row0, w.tile, slot);
    else if (body == 2) scores(a, row0, w.tile, slot);
  }

  static __device__ void piece(int, const Args& a, const Walk& w,
                               const int* slots, int count, bool cont,
                               float* part, float*) {
    norms_piece(a, w, slots, count, cont, part);
  }

  static __device__ float* sum_out(int, const Args& a) { return a.item_norms; }

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

  // no float sum stage: nothing folds
  static __device__ void piece(int, const Args&, const Walk&, const int*, int,
                               bool, float*, float*) {}
  static __device__ float* sum_out(int, const Args&) { return nullptr; }

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

  // no float sum stage: nothing folds
  static __device__ void piece(int, const Args&, const Walk&, const int*, int,
                               bool, float*, float*) {}
  static __device__ float* sum_out(int, const Args&) { return nullptr; }

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

// Phase 2 of instance j: out = buffer + partial_0 + partial_1 + ... in
// ascending group order, one owner thread an entry; FOLD partials in flight.
constexpr int FOLD = 16;

template <class P>
__device__ void fold(const Walk& w, const Members<P>& b, int j) {
  const int* in = w.inst + 4 * j;
  const int sid = __ldg(in), n_groups = __ldg(in + 1), entries = __ldg(in + 3);
  const float* part = w.scratch + __ldg(in + 2);
  float* out = P::sum_out(__ldg(w.body_of_sid + sid),
                          b.m[__ldg(w.member_of_sid + sid)]);
  for (int e = global_thread(); e < entries; e += grid_threads()) {
    float v = out[e];
    for (int g0 = 0; g0 < n_groups; g0 += FOLD) {
      float t[FOLD];
#pragma unroll
      for (int u = 0; u < FOLD; ++u)
        t[u] = g0 + u < n_groups ? __ldcg(part + (size_t)(g0 + u) * entries + e) : 0.f;
#pragma unroll
      for (int u = 0; u < FOLD; ++u)
        if (g0 + u < n_groups) v += t[u];
    }
    out[e] = v;
  }
}

template <class P>
__global__ void __launch_bounds__(THREADS, 2)
walk_kernel(Walk w, Members<P> b) {
  extern __shared__ __align__(16) float smem[];
  if (w.stamps != nullptr)
    for (int i = global_thread(); i < w.n_slots; i += grid_threads()) {
      int* st = w.stamps + 4 * i;
      st[0] = __ldg(w.table + 3 * i);
      st[1] = __ldg(w.table + 3 * i + 1);
      st[2] = __ldg(w.table + 3 * i + 2);
      st[3] = i;
    }
  for (int s = 0;; ++s) {
    if (s > 0) {  // segment s starts with a barrier; folds due here follow it
      const int f0 = __ldg(w.fold_ptr + s), f1 = __ldg(w.fold_ptr + s + 1);
      if (s < w.n_seg || f1 > f0) grid_barrier(w.barrier);
      if (f1 > f0) {
        for (int f = f0; f < f1; ++f) fold<P>(w, b, __ldg(w.fold_inst + f));
        if (s < w.n_seg) grid_barrier(w.barrier);
      }
    }
    if (s == w.n_seg) break;
    const int k1 = __ldg(w.walk_ptr + s + 1);
    for (int k = __ldg(w.walk_ptr + s); k < k1; ++k) {
      const int i = __ldg(w.walk + k);
      const int sid = __ldg(w.table + 3 * i);
      const int body = __ldg(w.body_of_sid + sid);
      if (body < 0) continue;
      const typename P::Args& a = b.m[__ldg(w.member_of_sid + sid)];
      P::run(body, a, w, slot_row0(w, i, P::n_rows(a)), i, smem);
    }
    const int p1 = __ldg(w.piece_ptr + s + 1);
    for (int p = __ldg(w.piece_ptr + s) + blockIdx.x; p < p1; p += gridDim.x) {
      const int* pc = w.pieces + 5 * p;
      const int* in = w.inst + 4 * __ldg(pc);
      const int sid = __ldg(in);
      const int body = __ldg(w.body_of_sid + sid);
      float* part = w.scratch + __ldg(in + 2) + (size_t)__ldg(pc + 1) * __ldg(in + 3);
      P::piece(body, b.m[__ldg(w.member_of_sid + sid)], w,
               w.piece_slots + __ldg(pc + 2), __ldg(pc + 3), __ldg(pc + 4) != 0,
               part, smem);
    }
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

// The host side of every entry point. `plan` is the wrapper's int32 array
// on the device: body_of_sid, member_of_sid, then the fold plan's arrays,
// at the 10 offsets in the host array `off`. `ptrs` holds P::NP pointers
// and `dims` P::ND sizes for each of the n_members members (host arrays);
// the dynamic shared memory is the largest member's.
template <class P>
int walk(const int* table, int n_slots, const int* plan,
         const int* off, int n_seg, float* scratch, int* stamps,
         unsigned int* barrier, int tile, int n_members, void* const* ptrs,
         const int* dims, void* stream) {
  if (n_members < 1 || n_members > MAX_MEMBERS || tile < 1 || n_seg < 1)
    return (int)cudaErrorInvalidValue;
  const Walk w{table, n_slots, plan + off[0], plan + off[1],
               plan + off[2], plan + off[3], plan + off[4], plan + off[5],
               plan + off[6], plan + off[7], plan + off[8], plan + off[9],
               n_seg, scratch, stamps, barrier, tile};
  Members<P> b{};
  size_t smem = 0;
  for (int m = 0; m < n_members; ++m) {
    b.m[m] = P::unpack(ptrs + m * P::NP, dims + m * P::ND);
    smem = std::max(smem, P::smem(b.m[m], tile));
  }
  return launch<P>(w, b, smem, stream);
}

}  // namespace

#define WALK_ENTRY(NAME, PROGRAM)                                              \
  extern "C" int NAME(const int* table, int n_slots, const int* plan,         \
                      const int* off, int n_seg, float* scratch, int* stamps, \
                      unsigned int* barrier, int tile, int n_members,         \
                      void* const* ptrs, const int* dims, void* stream) {     \
    return walk<PROGRAM>(table, n_slots, plan, off, n_seg, scratch, stamps,   \
                         barrier, tile, n_members, ptrs, dims, stream);       \
  }

WALK_ENTRY(walk_linreg, Linreg)
WALK_ENTRY(walk_recommendation, Recommendation)
WALK_ENTRY(walk_moe, Moe)
WALK_ENTRY(walk_cc, Cc)

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
