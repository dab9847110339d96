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
//     once each, one warp per row; the CC count is taken with integer
//     atomics. Producer outputs are read with L1-bypassing loads (__ldcg).
//     The recommendation and MoE programs take the segment's slots all at
//     once instead (their notes below);
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
// mirror is the value the entry's own chain would give.
//
// Recommendation is bytes-bound. Its `full` edge from item_norms to scores
// makes two passes over R the least (R, 65,536 x 2,048 float32, is 537 MB
// against a 50 MB L2): 0.32 ms at 3.35 TB/s. The launch reads R three
// times: item_norms' pieces (each thread 8 columns 256 apart, 8 rows of
// loads in flight) and user_bias's rows in the first segment, scores'
// rows in the second, each row by one warp with 16-byte loads (the note
// at Recommendation).
//
// The CC-iteration program (tests/test_device_dag.py's super-table, the
// body of repro/kernels/cc_propagate.py:propagate_body): `propagate` is a
// concat stage whose slot walks `inner` column tiles, `changed` a sum
// stage counting flipped labels. The Pallas grid's second axis carries
// the running max from one column tile to the next; blocks on Hopper have
// no order, so nothing may carry between them. Here a slot's inner steps
// run inside the slot: the warp that owns a row loops over the column
// tiles in ascending order with 16-byte loads and keeps the running max
// in a register, started from the row's own label. `changed` reads
// `propagate` by rows, which would need a grid barrier before each
// `changed` slot (64 a launch at n = 16,384). Instead the plan
// (kernels/dag_walk.py:count_fusion) marks each `propagate` slot whose
// rows' `changed` slot lies later in the same table: the warp that writes
// a row of it adds the row's flip to the count with an integer atomic,
// and that `changed` slot does nothing, so the launch has no barrier at
// all. A `changed` slot whose rows were written before the launch (a
// stagewise walk, another shard) keeps its owner body (warp 0 of CTA 0,
// one atomic a slot). Max and an int32 count are exact in any order, so
// the result is bitwise the plain walk's. Bound: bytes, G read once
// (4 n^2: 1 GiB at n = 16,384, 0.32 ms at 3.35 TB/s), as K2.
//
// The MoE program (repro/vee/ml_apps.py:moe_device_lowering): a slot is
// expert g's fixed-capacity slab, C rows of the dispatch buffer, and the
// body is out = (silu(x wi_g[:, :f]) * (x wi_g[:, f:])) wo_g, accurate
// to fp32. At Qwen1.5-MoE-A2.7B's widths (E = 60, C = 342, d = 2048,
// f = 1408) that is 6 E C d f = 3.55e11 flop against 2.4 GB of bytes.
// fp32 FMA alone would take 5.3 ms at 67 TFLOP/s, so the products run on
// the tensor cores as 3xTF32: each fp32 operand is split into big =
// tf32(a) and small = tf32(a - big), and small b_big + big b_small + big
// b_big, three TF32 products, keep about 21 bits of each product (one TF32
// product keeps 11); at 495 TFLOP/s that is 2.2 ms for the full slabs.
// TF32 wgmma reads both operands K-major from shared memory (A may come
// from registers instead), so the weights, N-major in memory, are
// transposed on their way into the split tiles. The weights are indexed
// by slot (`tile` block index), never repeated along the rows. A slab's
// gated h (C x f) is 1.9 MB, far past shared memory, so the launch runs
// in two phases over every slab of the segment: phase 0 writes every
// slab's h into one scratch buffer (E C f floats, the wrapper's), one
// grid barrier, phase 1 computes every slab's out from it. 128 x 128
// output tiles (3 x 22 a slab in phase 0, 3 x 16 in phase 1) go to the
// CTAs by grid stride, so no CTA idles for a phase; the three M tiles of
// a weight tile run side by side and read it from device memory about
// once (the weights, 2.07 GB, set the bytes). In a CTA, two producer
// warps copy and split (`produce`) while two consumer warpgroups run the
// products (`consume`), through a ring of stages paced by mbarriers.
// Each output is a fixed function of the inputs, no atomics; silu uses
// IEEE expf and correctly rounded division. One CTA an SM (192 KB of
// shared memory, 384 threads).

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
  const int* counts;                  // (n_slots) 1: the slot counts its rows, or null
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


// The hooks of a program without derived reads (see Recommendation): no
// pass at the launch start, nothing written beside a folded entry.
struct NoDerived {
  template <class B>
  static __device__ void prologue(const Walk&, const B&) {}
  template <class A>
  static __device__ void folded(int, const A&, int, float) {}
};

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

// 16 bytes global -> shared, asynchronously; !valid writes zeros.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

struct Linreg : NoDerived {
  struct Args {
    const float* X;        // (n, d)
    const float* y;        // (n,)
    float* moments;        // (2, d) sum output, or null
    const float* mom_in;   // (2, d) moments that syrk_gemv reads
    float* syrk;           // (d+1, d+2) sum output, or null
    int n, d;
  };

  static constexpr bool WHOLE_SEGMENT = false;
  static constexpr int BLOCK = THREADS, MIN_BLOCKS = 2;

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
// The two concat bodies run one warp a row, over every row of the segment
// at once (`segment`): the segment's walk slots hold (k1 - k0) tile rows
// in all, numbered j = (k - k0) tile + r for row r of walk slot k, and
// global warp gw takes rows gw, gw + n_gw, ... Each row is written once,
// by lane 0 of its warp; which warp that is depends on the grid, its value
// does not: it is a fixed function of the row's inputs.
//
// Loads: a row of R is read as 16-byte vectors when it is 16-byte aligned
// (R aligned and n_items % 4 == 0), else as scalars. user_bias: a lane
// loads 16 vectors into registers before it adds any (8 KB of R a warp in
// flight). scores: each IEEE division may call its slow path, and values
// held in registers across such a call spill, so R's vectors go through a
// ring of two batches in shared memory with cp.async: the next batch of 8
// vectors a lane (4 KB a warp) is in flight while the warp computes this
// one, across its rows; a lane reads back only its own copies, so no
// barrier paces the ring. R's loads bypass L1 (__ldcg, cp.async.cg: a
// pass reads a row once), which keeps L1 for the denominators.
//
// user_bias: lane l adds its vectors' entries in ascending column order
// into one accumulator, s_l = (((0 + R[c]) + R[c+1]) + R[c+2]) + R[c+3]
// over c = 4 (l + 32 k), k ascending (scalar rows: c = l + 32 k); then an
// xor tree over offsets 16, 8, 4, 2, 1 (s_l + s_{l^o}, the same bits in
// both lanes); then an IEEE divide by n_items. The order is fixed by the
// row and n_items alone (kernels/ref.py:user_bias_ref emulates it).
//
// scores: den[c] = sqrt(item_norms[c]) + 1e-9 (IEEE-rounded, as the plain
// body's float32 square root and add) is computed once an item in a
// launch, into the wrapper's buffer `den` (`den_of`): by the fold that
// publishes item_norms (`folded`; the fold's second barrier publishes den
// with it), or, when item_norms was folded before this launch (a stagewise
// walk, a remainder whose item_norms the host finished), by a pass at the
// launch start behind one grid barrier (`prologue`, den_pre set by the
// wrapper from FoldPlan.prepass). A row reads den with L1-cached loads
// (8 KB at 2,048 items) and computes (R[r, c] / den[c]) - bias[r] with
// IEEE division and subtraction, a lane's candidates in ascending column
// order (strict >, so the first of equal values stays), then an xor tree
// that takes (ob > best) || (ob == best && oa < arg): the lowest index
// among equal maxima, whatever the lanes' column layout.
struct Recommendation {
  struct Args {
    const float* R;          // (n_users, n_items)
    float* item_norms;       // (n_items,) sum output, or null
    float* user_bias;        // (n_users,) concat output, or null
    int* scores;             // (n_users,) concat output, or null
    const float* norms_in;   // item_norms that scores reads
    const float* bias_in;    // user_bias that scores reads
    float* den;              // (n_items,) scores' denominators, or null
    int n_users, n_items;
    int den_pre;             // 1: the launch start computes den from norms_in
  };

  static constexpr bool WHOLE_SEGMENT = true;
  static constexpr int BLOCK = THREADS, MIN_BLOCKS = 2;

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

  // user_bias: 16-byte vectors of R a lane loads before it adds any
  static constexpr int UB = 16;
  // scores: a warp's pipeline of R's 16-byte vectors through its own
  // shared memory, STAGES batches of US vectors a lane
  static constexpr int US = 8, STAGES = 2;
  static constexpr int WARP_VECS = STAGES * US * 32;

  static __device__ __forceinline__ bool vectors(const Args& a) {
    return (a.n_items & 3) == 0 && (reinterpret_cast<uintptr_t>(a.R) & 15) == 0;
  }

  // user_bias of one row (the order is in the note above). Vectors past
  // the row load as zeros: s + 0 is s (s is never -0), so the sum is the
  // one over the row's own entries.
  static __device__ void user_bias(const Args& a, int row) {
    const int m = a.n_items, lane = threadIdx.x & 31;
    float s = 0.f;
    if (vectors(a)) {
      const float4* r4 = reinterpret_cast<const float4*>(a.R + (size_t)row * m);
      const int n4 = m >> 2;
      for (int k0 = 0; k0 < n4; k0 += 32 * UB) {
        float4 v[UB];
#pragma unroll
        for (int u = 0; u < UB; ++u) {
          const int k = k0 + 32 * u + lane;
          v[u] = k < n4 ? __ldcg(r4 + k) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < UB; ++u) {
          s += v[u].x;
          s += v[u].y;
          s += v[u].z;
          s += v[u].w;
        }
      }
    } else {
      const float* r1 = a.R + (size_t)row * m;
#pragma unroll 8
      for (int c = lane; c < m; c += 32) s += __ldcg(r1 + c);
    }
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) a.user_bias[row] = __fdiv_rn(s, (float)m);
  }

  // One candidate of a lane: its columns come in ascending order. The
  // quotient is __fdiv_rn(x, d); for x == 0 (most of R) and d finite and
  // nonzero that is the signed zero x d, taken as such: __fdiv_rn's range
  // check would send a zero to its slow path, and a branch on x would split
  // the warp. The division then runs on 1 in x's place, so every lane
  // takes the same path.
  static __device__ __forceinline__ void take(float x, float d, float bias, int c,
                                              int m, float& best, int& arg) {
    const bool zero = x == 0.f && d != 0.f && fabsf(d) != INFINITY;
    const float q = __fdiv_rn(zero ? 1.f : x, d);
    const float v = __fsub_rn(zero ? __fmul_rn(x, d) : q, bias);
    if (v > best || arg == m) {
      best = v;
      arg = c;
    }
  }

  // the lanes' (best, arg) to lane 0's: the lowest index among equal maxima
  static __device__ __forceinline__ void scores_store(const Args& a, int row, float best,
                                                      int arg) {
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
      if (ob > best || (ob == best && oa < arg)) {
        best = ob;
        arg = oa;
      }
    }
    if ((threadIdx.x & 31) == 0) a.scores[row] = arg;
  }

  // scores of a row that is not 16-byte aligned: scalar loads
  static __device__ void scores_scalar(const Args& a, int row) {
    const int m = a.n_items, lane = threadIdx.x & 31;
    const float* r1 = a.R + (size_t)row * m;
    const float bias = __ldcg(a.bias_in + row);
    float best = -INFINITY;
    int arg = m;
    for (int c = lane; c < m; c += 32) take(__ldcg(r1 + c), __ldca(a.den + c), bias, c, m, best, arg);
    scores_store(a, row, best, arg);
  }

  static __device__ __forceinline__ float den_of(float norm) {
    return __fadd_rn(__fsqrt_rn(norm), 1e-9f);
  }

  // Row j of the segment: its member, its row of R, its body (0: none
  // here; item_norms folds as pieces).
  struct RowOf {
    int member, row, body;
  };
  template <class B>
  static __device__ __forceinline__ RowOf row_of(const Walk& w, const B& b, int k0, int j) {
    const int i = __ldg(w.walk + k0 + j / w.tile), sid = __ldg(w.table + 3 * i);
    const int body = max(__ldg(w.body_of_sid + sid), 0);
    const int member = __ldg(w.member_of_sid + sid);
    return RowOf{member, slot_row0(w, i, b.m[member].n_users) + j % w.tile, body};
  }

  // Every row of the segment's walk slots, over every warp of the grid: the
  // warp's rows j = gw + q n_gw, each cut into nb batches of 32 US vectors
  // (nb from the widest member), make its work items t = q nb + batch. A
  // scores row's batch is copied into the warp's ring (`buf`, lane-major:
  // a lane reads back only its own copies) STAGES - 1 items ahead of the
  // item it computes; a user_bias row runs at its first item, from
  // registers.
  template <class B>
  static __device__ void segment(const Walk& w, const B& b, int k0, int k1, float* smem) {
    const int lane = threadIdx.x & 31, gw = global_thread() >> 5;
    const int n_gw = grid_threads() >> 5, total = (k1 - k0) * w.tile;
    int n4_max = 0;
    for (int m = 0; m < MAX_MEMBERS; ++m) n4_max = max(n4_max, b.m[m].n_items >> 2);
    const int nb = max(1, (n4_max + 32 * US - 1) / (32 * US));
    const int n_work = gw < total ? ((total - 1 - gw) / n_gw + 1) * nb : 0;
    float4* buf = reinterpret_cast<float4*>(smem) + (threadIdx.x >> 5) * WARP_VECS;
    auto copy_item = [&](int t) {
      if (t < n_work) {
        const RowOf r = row_of(w, b, k0, gw + t / nb * n_gw);
        const Args& a = b.m[r.member];
        if (r.body == 2 && vectors(a)) {
          const int n4 = a.n_items >> 2;
          const float* row = a.R + (size_t)r.row * a.n_items;
#pragma unroll
          for (int u = 0; u < US; ++u) {
            const int k = t % nb * 32 * US + 32 * u + lane;
            if (k < n4)
              cp_async16(reinterpret_cast<float*>(buf + (t % STAGES * US + u) * 32 + lane),
                         row + 4 * k, true);
          }
        }
      }
      cp_async_commit();  // one group an item, empty or not
    };
    for (int t = 0; t < STAGES - 1; ++t) copy_item(t);
    float best = -INFINITY, bias = 0.f;
    int arg = 0;
    for (int t = 0; t < n_work; ++t) {
      copy_item(t + STAGES - 1);
      cp_async_wait<STAGES - 1>();  // item t's copies have landed
      const RowOf r = row_of(w, b, k0, gw + t / nb * n_gw);
      const Args& a = b.m[r.member];
      const int batch = t % nb;
      if (r.body == 1) {
        if (batch == 0) user_bias(a, r.row);
        continue;
      }
      if (r.body != 2) continue;
      if (!vectors(a)) {
        if (batch == 0) scores_scalar(a, r.row);
        continue;
      }
      const int m = a.n_items, n4 = m >> 2;
      if (batch == 0) {
        best = -INFINITY;
        arg = m;
        bias = __ldcg(a.bias_in + r.row);
      }
      const float4* d4 = reinterpret_cast<const float4*>(a.den);
#pragma unroll
      for (int u = 0; u < US; ++u) {
        const int k = batch * 32 * US + 32 * u + lane;
        if (k < n4) {
          const float4 x = buf[(t % STAGES * US + u) * 32 + lane];
          const float4 d = __ldca(d4 + k);
          take(x.x, d.x, bias, 4 * k, m, best, arg);
          take(x.y, d.y, bias, 4 * k + 1, m, best, arg);
          take(x.z, d.z, bias, 4 * k + 2, m, best, arg);
          take(x.w, d.w, bias, 4 * k + 3, m, best, arg);
        }
      }
      if (batch == nb - 1) scores_store(a, r.row, best, arg);
    }
    cp_async_wait<0>();
  }

  // den of every member whose item_norms this launch does not fold, once
  // an item, then one grid barrier (only when some member needs it)
  template <class B>
  static __device__ void prologue(const Walk& w, const B& b) {
    bool any = false;
    for (int m = 0; m < MAX_MEMBERS; ++m) {
      const Args& a = b.m[m];
      if (a.den == nullptr || !a.den_pre) continue;
      any = true;
      for (int e = global_thread(); e < a.n_items; e += grid_threads())
        a.den[e] = den_of(__ldcg(a.norms_in + e));
    }
    if (any) grid_barrier(w.barrier);
  }

  static __device__ void piece(int, const Args& a, const Walk& w,
                               const int* slots, int count, bool cont,
                               float* part, float*) {
    norms_piece(a, w, slots, count, cont, part);
  }

  static __device__ float* sum_out(int, const Args& a) { return a.item_norms; }

  // the fold of item_norms entry e (= v) also writes its denominator
  static __device__ void folded(int, const Args& a, int e, float v) {
    if (a.den != nullptr) a.den[e] = den_of(v);
  }

  // host side: R, item_norms, user_bias, scores, norms_in, bias_in, den;
  // n_users, n_items, den_pre
  static constexpr int NP = 7, ND = 3;
  static Args unpack(void* const* p, const int* d) {
    return Args{(const float*)p[0], (float*)p[1], (float*)p[2], (int*)p[3],
                (const float*)p[4], (const float*)p[5], (float*)p[6], d[0], d[1], d[2]};
  }
  // the scores pipeline's rings: one a warp
  static size_t smem(const Args& a, int) {
    return a.scores == nullptr ? 0 : sizeof(float4) * WARP_VECS * (THREADS / 32);
  }
};

// ------------------------------------------------------------------- moe
// Tensor-core pieces, as in csrc/flash_attention.cu: no-swizzle K-major
// tiles in shared memory (16-byte chunk c of row r at byte (c ROWS + r) 16)
// filled by cp.async with zero fill (cp_async16, above), and wgmma
// descriptors over them.
constexpr int MT = 128;             // rows of an output tile: two warpgroups of 64
constexpr int NT = 128;             // columns of an output tile: one wgmma's n
constexpr int KT = 32;              // k of one stage: 8 chunks of 4 floats
constexpr int TF = MT * KT;         // floats of one operand tile (NT * KT too)
constexpr int CONSUMERS = 256;      // two warpgroups: the products
constexpr int PRODUCERS = 128;      // one warpgroup: the copies and the split of B
constexpr int SLOTS = 4;            // ring stages: raw A, split B (big, small)
constexpr int AHEAD = 2;            // stages of copies in flight ahead of the split
// registers a thread holds: 168 at launch (65,536 over 384 threads), then
// in the producer / consumer warpgroups 128 x 72 + 256 x 208 <= 65,536
constexpr int LAUNCH_REGS = 168, PRODUCER_REGS = 72, CONSUMER_REGS = 208;

// mbarriers of the ring: `full` completes when the producers have split a
// stage, `empty` when the consumers are done with it.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// wgmma shared-memory descriptor of a no-swizzle tile: start address,
// leading (K-direction) and stride (M/N-direction) byte offsets between
// neighbouring 8 x 16-byte core matrices.
__device__ __forceinline__ uint64_t make_desc(const float* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4)
         | ((uint64_t)(lbo >> 4) & 0x3FFF) << 16
         | ((uint64_t)(sbo >> 4) & 0x3FFF) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads across the async product
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 128, fp32) (+)= A B: A tf32 in registers (the m64k8 fragment:
// a0 (row, k), a1 (row + 8, k), a2 (row, k + 4), a3 (row + 8, k + 4), row
// 16 warp + lane / 4, k lane % 4), B tf32 in shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// x rounded to TF32 (10 stored mantissa bits), to nearest, ties to even;
// the low 13 bits are zero, so the tensor cores read it exactly. One
// instruction (sm_90), bitwise what the bit-pattern rounding
// (u + 0xFFF + (u >> 13 & 1)) & ~0x1FFF gives (kernels/ref.py:tf32_round).
__device__ __forceinline__ float tf32_rne(float x) {
  uint32_t r;
  asm("cvt.rn.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// 3xTF32: a = big + small with big = tf32(a), small = tf32(a - big) (the
// subtraction is exact), so a b = big b_big + big b_small + small b_big up
// to 2^-21 of |a b|; the small * small product (2^-22) is left out.
__device__ __forceinline__ void split4(float4 v, float4& big, float4& small) {
  big = make_float4(tf32_rne(v.x), tf32_rne(v.y), tf32_rne(v.z), tf32_rne(v.w));
  small = make_float4(tf32_rne(__fsub_rn(v.x, big.x)), tf32_rne(__fsub_rn(v.y, big.y)),
                      tf32_rne(__fsub_rn(v.z, big.z)), tf32_rne(__fsub_rn(v.w, big.w)));
}

// One MT x NT output tile of A (M x K, row-major, lda: K-major) times B
// (K x ldb, row-major: N-major), in fp32 by 3xTF32 on wgmma. Column c of
// B's tile is global column colA + c (c < NT/2) or colB + c - NT/2; a
// column at or past its half's limit, a row at or past M and a k at or
// past K load as zero (K, the limits and the columns are multiples of 4).
struct Operands {
  const float* A;
  size_t lda;
  int m0, M, K;
  const float* B;
  size_t ldb;
  int colA, limA, colB, limB;
};

// Shared memory of the MoE program: SLOTS x (raw A: TF floats in the
// K-major chunk layout | B big | B small: TF each, K-major; B small holds
// the raw B tile, KT x NT row-major, until the split), then the ring's
// mbarriers.
__device__ __forceinline__ float* slot_a(float* smem, int s) { return smem + s * 3 * TF; }
__device__ __forceinline__ float* slot_b(float* smem, int s) { return smem + s * 3 * TF + TF; }
constexpr int MOE_FLOATS = SLOTS * 3 * TF;

// The producers (warps 8 to 11) for one tile: per KT stage, copy raw A
// and raw B into the stage's ring slot with cp.async, AHEAD stages ahead
// (B where its small tile goes); split B into big and small tf32 tiles,
// transposed to K-major on the way (wgmma's transpose bits are for 16-bit
// types only: four strided scalar reads from the raw tile, one 16-byte
// store each for big and small, small once every producer has read the
// raw tile); then arrive on the slot's `full`. `it0` counts the CTA's
// stages before this tile (the ring's phase).
__device__ __forceinline__ void produce(const Operands& o, int it0, float* smem,
                                        uint64_t* full, uint64_t* empty) {
  const int p = threadIdx.x - CONSUMERS, nk = (o.K + KT - 1) / KT;
  // A chunks (row p, chunk j); B chunks (k row p / 32 + 4j, columns 4 q ..
  // of q's half)
  const int q = p % (NT / 4);
  const bool lo = q < NT / 8;
  const int gc = lo ? o.colA + 4 * q : o.colB + 4 * (q - NT / 8);
  const bool a_ok = o.m0 + p < o.M, b_ok = gc < (lo ? o.limA : o.limB);
  const float* a_src = o.A + (size_t)(a_ok ? o.m0 + p : 0) * o.lda;
  const float* b_src = o.B + (size_t)(p / 32) * o.ldb + (b_ok ? gc : 0);
  auto load = [&](int k) {
    const int it = it0 + k, s = it % SLOTS;
    if (it >= SLOTS) mbar_wait(empty + s, (it / SLOTS - 1) & 1);  // the slot is free
    float* ra = slot_a(smem, s);
    float* rb = slot_b(smem, s) + TF;
    const int k0 = k * KT;
#pragma unroll
    for (int j = 0; j < TF / 4 / PRODUCERS; ++j) {
      const bool ok = a_ok && k0 + 4 * j < o.K;
      cp_async16(ra + 4 * (j * MT + p), ok ? a_src + k0 + 4 * j : o.A, ok);
    }
#pragma unroll
    for (int j = 0; j < TF / 4 / PRODUCERS; ++j) {
      const int kk = p / 32 + 4 * j;
      const bool ok = b_ok && k0 + kk < o.K;
      cp_async16(rb + kk * NT + 4 * q, ok ? b_src + (size_t)(k0 + 4 * j) * o.ldb : o.B, ok);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < AHEAD; ++k) {
    if (k < nk) load(k);
    else cp_async_commit();
  }
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<AHEAD - 1>();
    // stage k has landed for every producer; all are done splitting k - 1
    asm volatile("bar.sync 1, %0;\n" :: "n"(PRODUCERS) : "memory");
    const int it = it0 + k, s = it % SLOTS;
    float4* cv = reinterpret_cast<float4*>(slot_b(smem, s));
    const float* rb = slot_b(smem, s) + TF;
    float4 small[TF / 4 / PRODUCERS];
#pragma unroll
    for (int j = 0; j < TF / 4 / PRODUCERS; ++j) {  // B^T chunk (p, j): k 4j .. 4j + 3 of column p
      float4 big;
      split4(make_float4(rb[(4 * j) * NT + p], rb[(4 * j + 1) * NT + p],
                         rb[(4 * j + 2) * NT + p], rb[(4 * j + 3) * NT + p]), big, small[j]);
      cv[j * NT + p] = big;
    }
    // every producer has read the raw tile: small takes its place
    asm volatile("bar.sync 1, %0;\n" :: "n"(PRODUCERS) : "memory");
#pragma unroll
    for (int j = 0; j < TF / 4 / PRODUCERS; ++j) cv[TF / 4 + j * NT + p] = small[j];
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the tensor cores
    mbar_arrive(full + s);
    if (k + AHEAD < nk) load(k + AHEAD);
    else cp_async_commit();
  }
}

// The consumers (two warpgroups) for one tile, into total[64], the
// m64n128 accumulator fragment of warpgroup threadIdx.x / 128: per stage,
// wait for the slot's `full`, read this thread's A fragments from the raw
// A tile and split them in registers (A from registers, so A is never
// stored split), issue the stage's 12 products (small ones first) into acc
// from zero, and once they are done add acc into total in fp32 with round
// to nearest and arrive on the slot's `empty`. The tensor cores truncate
// as they accumulate, so no chain is let grow longer than one stage. Each
// output is a fixed function of the inputs.
__device__ __forceinline__ void consume(int K, int it0, float* smem, uint64_t* full,
                                        uint64_t* empty, float (&total)[64]) {
  const int tid = threadIdx.x, lane = tid % 32, nk = (K + KT - 1) / KT;
  // the A fragment's first row and k in the chunk layout (row r, k at
  // float (k / 4 * MT + r) 4 + k % 4)
  const int a_off = (64 * (tid / 128) + 16 * (tid / 32 % 4) + lane / 4) * 4 + lane % 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) total[i] = acc[i] = 0.f;
  for (int k = 0; k < nk; ++k) {
    const int it = it0 + k, s = it % SLOTS;
    mbar_wait(full + s, (it / SLOTS) & 1);
    const float* ra = slot_a(smem, s);
    uint32_t a_big[KT / 8][4], a_small[KT / 8][4];
#pragma unroll
    for (int kk = 0; kk < KT / 8; ++kk)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float v = ra[a_off + ((2 * kk + u / 2) * MT + 8 * (u % 2)) * 4];
        const float big = tf32_rne(v);
        a_big[kk][u] = __float_as_uint(big);
        a_small[kk][u] = __float_as_uint(tf32_rne(__fsub_rn(v, big)));
      }
    // a step's k offset adds to the descriptor's address field (shared
    // addresses fit its 14 bits)
    const uint64_t bb = make_desc(slot_b(smem, s), NT * 16, 128), bs = bb + TF * 4 / 16;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 8; ++kk) {  // k 8kk .. 8kk + 7: chunks 2kk, 2kk + 1
      const uint64_t off = kk * 2 * NT * 16 / 16;
      wgmma_tf32_rs(acc, a_small[kk], bb + off, kk);
      wgmma_tf32_rs(acc, a_big[kk], bs + off, 1);
    }
#pragma unroll
    for (int kk = 0; kk < KT / 8; ++kk)
      wgmma_tf32_rs(acc, a_big[kk], bb + kk * 2 * NT * 16 / 16, 1);
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] = __fadd_rn(total[i], acc[i]);
    mbar_arrive(empty + s);
  }
}

// v as lane 0 has it: the compiler then knows it is the same in the warp,
// so loops and branches on it hold no divergent path, where ptxas would
// serialize the wgmma products. The walker's plan values are the same in
// every thread anyway.
__device__ __forceinline__ int uniform(int v) { return __shfl_sync(0xffffffffu, v, 0); }

struct Moe : NoDerived {
  struct Args {
    const float* x;    // (E*C, d) dispatch buffer, expert g's slab at rows g*C
    const float* wi;   // (E, d, 2f)
    const float* wo;   // (E, f, d)
    float* out;        // (E*C, d) concat output
    float* h;          // (E*C, f) scratch: every slab's gated activations
    int rows, d, f;    // rows = E*C
  };

  static constexpr bool WHOLE_SEGMENT = true;
  static constexpr int BLOCK = CONSUMERS + PRODUCERS, MIN_BLOCKS = 1;

  static __device__ __forceinline__ float silu_mul(float g, float u) {
    return __fmul_rn(__fdiv_rn(g, __fadd_rn(1.f, expf(-g))), u);
  }

  // Tile (m0, n) of a slab at rows row0 .. row0 + C. Phase 0: gated column
  // tiles of h, its g and u halves side by side in B's tile (accumulator
  // columns c and c + 64). Phase 1: out = h wo. The fragment of consumer
  // t holds entry i at row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2) and
  // column 8 (i / 4) + 2 (t % 4) + i % 2 of its warpgroup's 64 x 128.
  static __device__ void tile(int phase, const Args& a, int d, int f, int row0, int C,
                              int m0, int n, int it0, bool producer, float* smem,
                              uint64_t* full, uint64_t* empty) {
    const bool p0 = phase == 0;
    const int g = row0 / C, n0 = p0 ? n * (NT / 2) : n * NT;
    const Operands o{p0 ? a.x + (size_t)row0 * d : a.h + (size_t)row0 * f,
                     p0 ? (size_t)d : (size_t)f, m0, C, p0 ? d : f,
                     p0 ? a.wi + (size_t)g * d * 2 * f : a.wo + (size_t)g * f * d,
                     p0 ? 2 * (size_t)f : (size_t)d, n0, p0 ? f : d,
                     p0 ? f + n0 : n0 + NT / 2, p0 ? 2 * f : d};
    if (producer) {
      produce(o, it0, smem, full, empty);
      return;
    }
    const int t = threadIdx.x % 128;
    const int r_t = m0 + 64 * (threadIdx.x / 128) + 16 * (t / 32) + (t % 32) / 4;
    float total[64];
    consume(o.K, it0, smem, full, empty, total);
    if (p0) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = r_t + 8 * ((i / 2) % 2), j = n0 + 8 * (i / 4) + 2 * (t % 4);
        if (r < C && j < f)
          *reinterpret_cast<float2*>(a.h + (size_t)(row0 + r) * f + j) =
              make_float2(silu_mul(total[i], total[i + 32]),
                          silu_mul(total[i + 1], total[i + 33]));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int r = r_t + 8 * ((i / 2) % 2), c = n0 + 8 * (i / 4) + 2 * (t % 4);
        if (r < C && c < d)
          *reinterpret_cast<float2*>(a.out + (size_t)(row0 + r) * d + c) =
              make_float2(total[i], total[i + 1]);
      }
    }
  }

  // Every slab of the segment: phase 0 writes every slab's h, one grid
  // barrier, phase 1 every slab's out. Tiles go to CTAs by grid stride
  // over (slot, n, m), m fastest: the M tiles that read one weight tile
  // run side by side, so it comes from device memory about once. In a CTA
  // the producer warpgroup and the two consumer warpgroups walk the same
  // tiles and meet only at the ring's mbarriers (and the grid barrier).
  template <class B>
  static __device__ void segment(const Walk& w, const B& b, int k0, int k1, float* smem) {
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + MOE_FLOATS);
    uint64_t* empty = full + SLOTS;
    if (threadIdx.x == 0) {
      for (int s = 0; s < SLOTS; ++s) {
        mbar_init(full + s, PRODUCERS);
        mbar_init(empty + s, CONSUMERS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // the producers give up registers that the consumers' accumulators
    // take (setmaxnreg is per warpgroup)
    const bool producer = uniform(threadIdx.x / 32) >= CONSUMERS / 32;
    if (producer)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS) : "memory");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS) : "memory");
    const int grid = gridDim.x, C = w.tile, tm = (C + MT - 1) / MT;
    k0 = uniform(k0);
    k1 = uniform(k1);
    int it = 0;  // the CTA's stages so far
    for (int phase = 0; phase < 2; ++phase) {
      if (phase == 1) grid_barrier(w.barrier);  // every slab's h is written
      int base = 0;  // tiles of the earlier slots, modulo the grid
      for (int k = k0; k < k1; ++k) {
        const int i = uniform(__ldg(w.walk + k)), sid = uniform(__ldg(w.table + 3 * i));
        if (uniform(__ldg(w.body_of_sid + sid)) < 0) continue;
        const Args& a = b.m[uniform(__ldg(w.member_of_sid + sid))];
        const int d = uniform(a.d), f = uniform(a.f);
        const int tn = phase == 0 ? (f + NT / 2 - 1) / (NT / 2) : (d + NT - 1) / NT;
        const int nk = ((phase == 0 ? d : f) + KT - 1) / KT;
        const int row0 = uniform(slot_row0(w, i, a.rows));
        for (int l = ((int)blockIdx.x - base + grid) % grid; l < tm * tn; l += grid) {
          tile(phase, a, d, f, row0, C, (l % tm) * MT, l / tm, it, producer, smem, full,
               empty);
          it += nk;
        }
        base = (base + tm * tn) % grid;
      }
    }
    if (producer)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(LAUNCH_REGS) : "memory");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(LAUNCH_REGS) : "memory");
    __syncthreads();  // the ring is idle
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
    return sizeof(float) * MOE_FLOATS + 2 * SLOTS * sizeof(uint64_t);
  }
};

// -------------------------------------------------------------------- cc
struct Cc : NoDerived {
  struct Args {
    const float* G;        // (n, n) {0, 1} adjacency, or null
    const float* c_col;    // (n,) labels read along a row, or null
    const float* c_row;    // (n,) labels a row starts from / is compared with
    float* propagate;      // (n,) concat output, or null
    int* changed;          // (1,) sum output, or null
    const float* prop_in;  // propagate as `changed` reads it
    int n, tile_c;         // tile_c = n / inner: one inner step's columns
  };

  static constexpr bool WHOLE_SEGMENT = false;
  static constexpr int BLOCK = THREADS, MIN_BLOCKS = 2;

  // propagate: one warp per row; the row's inner steps (column tiles) run
  // in ascending order inside the slot, the running max in a register.
  // With `count` (the plan's count_fusion), the warp also adds the row's
  // flip to `changed`: the count of the slot's rows is taken where they
  // are written, and their `changed` slot does nothing.
  static __device__ void propagate(const Args& a, int row0, int rows,
                                   int slot, bool count) {
    const int n = a.n, lane = threadIdx.x & 31;
    const int n_gw = grid_threads() >> 5;
    const float4* c4 = reinterpret_cast<const float4*>(a.c_col);
    for (int r = first_row(slot, rows); r < rows; r += n_gw) {
      const int row = row0 + r;
      const float4* g4 = reinterpret_cast<const float4*>(a.G + (size_t)row * n);
      const float c0 = __ldg(a.c_row + row);
      float m = c0;  // inner step 0 seeds the running max
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
      if (lane == 0) {
        a.propagate[row] = m;
        if (count && m != c0) atomicAdd(a.changed, 1);
      }
    }
  }

  // changed, for rows written before this launch or before a barrier of
  // it (__ldcg): warp 0 of CTA 0 counts a slot's flips and adds them with
  // an integer atomic, as the counting warps of propagate do; an int sum
  // is exact in any order.
  static __device__ void changed(const Args& a, int row0, int rows) {
    if (global_thread() >= 32) return;
    const int lane = threadIdx.x;
    int flips = 0;
    for (int r = lane; r < rows; r += 32)
      flips += __ldcg(a.prop_in + row0 + r) != __ldg(a.c_row + row0 + r);
    for (int off = 16; off > 0; off >>= 1)
      flips += __shfl_xor_sync(0xffffffffu, flips, off);
    if (lane == 0 && flips) atomicAdd(a.changed, flips);
  }

  static __device__ int n_rows(const Args& a) { return a.n; }

  static __device__ void run(int body, const Args& a, const Walk& w, int row0,
                             int slot, float*) {
    if (body == 0)
      propagate(a, row0, w.tile, slot, w.counts != nullptr && __ldg(w.counts + slot));
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
  const int body = __ldg(w.body_of_sid + sid);
  const typename P::Args& a = b.m[__ldg(w.member_of_sid + sid)];
  float* out = P::sum_out(body, a);
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
    P::folded(body, a, e, v);
  }
}

template <class P>
__global__ void __launch_bounds__(P::BLOCK, P::MIN_BLOCKS)
walk_kernel(Walk w, Members<P> b) {
  extern __shared__ __align__(128) float smem[];
  if (w.stamps != nullptr)
    for (int i = global_thread(); i < w.n_slots; i += grid_threads()) {
      int* st = w.stamps + 4 * i;
      st[0] = __ldg(w.table + 3 * i);
      st[1] = __ldg(w.table + 3 * i + 1);
      st[2] = __ldg(w.table + 3 * i + 2);
      st[3] = i;
    }
  P::prologue(w, b);
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
    const int k0 = __ldg(w.walk_ptr + s), k1 = __ldg(w.walk_ptr + s + 1);
    if constexpr (P::WHOLE_SEGMENT) {
      P::segment(w, b, k0, k1, smem);
    } else {
      for (int k = k0; k < k1; ++k) {
        const int i = __ldg(w.walk + k);
        const int sid = __ldg(w.table + 3 * i);
        const int body = __ldg(w.body_of_sid + sid);
        if (body < 0) continue;
        const typename P::Args& a = b.m[__ldg(w.member_of_sid + sid)];
        P::run(body, a, w, slot_row0(w, i, P::n_rows(a)), i, smem);
      }
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
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, P::BLOCK,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  Walk wc = w;
  Members<P> bc = b;
  void* args[] = {&wc, &bc};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(per_sm * sms),
                                    dim3(P::BLOCK), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The host side of every entry point. `plan` is the wrapper's int32 array
// on the device: body_of_sid, member_of_sid, then the fold plan's arrays,
// at the 11 offsets in the host array `off` (the last -1: no counts). `ptrs` holds P::NP pointers
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
               off[10] < 0 ? nullptr : plan + off[10],
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
