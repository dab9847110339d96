// The gradient of the RWKV6 WKV chunked scan (K6'): dr, dk, dv, dlogw, du
// from dy and the final state's gradient.
//
// Replaces no Pallas kernel: the Pallas kernel repro/kernels/rwkv6_scan.py:
// rwkv6_scan has no backward, and the reference trains through
// jax.value_and_grad of its plain chunk recurrence
// (repro/models/rwkv.py:88 _wkv_chunked). This is that gradient for K6's
// function (csrc/rwkv6_scan.cu), per chunk of Q steps of a (batch, head),
// with cum the inclusive cumsum of logw over the chunk, cm1 the exclusive
// one (cum_{t-1}, 0 at step 0), cQ the chunk's last, the gate g(t,s,c) =
// exp(cm1[t,c] - cum[s,c]) for s < t, S_in the state entering the chunk,
// S_out the one leaving it and dS the gradient of S_out:
//   dS entering chunk c = diag(exp(cQ)) dS + (r exp(cm1))^T dy;
//   dA[t,s] = dy_t . v_s (s < t), db_t = dy_t . v_t;
//   dv_s  = sum_{t>s} A[t,s] dy_t + bonus_s dy_s + (k exp(cQ - cum))_s dS,
//           A[t,s] = sum_c r k g, bonus_t = sum_c r u k;
//   drg_t = sum_{s<t} dA[t,s] k_s g + exp(cm1_t) (S_in dy_t),
//   dkg_s = sum_{t>s} dA[t,s] r_t g + exp(cQ - cum_s) (dS v_s),
//   dr = drg + db u k, dk = dkg + db u r, du = sum_t db_t r_t k_t;
//   dcum_j = r_{j+1} drg_{j+1} - k_j dkg_j, and at the chunk's last step
//            also sum_d dS S_out (the u bonus has no decay in it);
//   dlogw = the reverse cumsum of dcum within the chunk.
// kernels/rwkv6_scan.py:rwkv6_scan_bwd_plain is the plain version of
// the same recurrences.
//
// The gate, as in the forward, never takes a positive exponent: logw
// reaches -30 a step, and a factor exp(-cum_s) with one reference point a
// chunk overflows. A chunk is cut into 16-step sub-chunks, e_j the cumsum
// at sub-chunk j's last step; for t in sub-chunk i above s's j, g =
// exp(cm1_t - e_j) exp(e_j - cum_s) = exp(cm1_t - e_{i-1}) exp(e_{i-1} -
// cum_s), each factor <= 1 since cum does not increase (a factor that
// underflows stands for a gate below 1e-38). So the gated sums across
// sub-chunks are block products on the tensor cores between factors <= 1,
// and only the pairs inside a sub-chunk take an exp of their own. A chunk
// that is not a multiple of 16 steps is padded with steps of logw, r, k, v
// and dy 0.
//
// Bound on an H100 (NVIDIA's data sheet: 3.35 TB/s, 495 TFLOP/s TF32): at
// RWKV6-3B's training shape (4 x 40 heads x 2,048 steps x 64, bf16 r, k,
// v) the function reads r, k, v, logw and dy and writes dr, dk, dv and
// dlogw (about 290 MB, 0.087 ms); chip_smoke.py reckons its operations
// and states which bound binds.
//
// Design: three launches, no atomics and no grid barrier, so two calls
// give the same bits; the wrapper counts the call once.
//   rwkv6_bwd_states, the mirror of K6's rwkv6_states: one CTA of 8 warps
//     per (batch, head, 32 columns d of dS), warp w rows 16 (w % 4) of dS
//     and 16 of the columns; the chunks in reverse order, the one before's
//     r, logw and dy columns staged by cp.async while this one computes;
//     cum in time order (a thread a channel); the term (r exp(cm1))^T dy
//     on the tensor cores (rows c, k = t); dS written to scratch before the
//     chunk's term is added, dS = fmaf(dS, exp(cQ), term) in registers.
//   rwkv6_bwd_chunks, one CTA of 8 warps per (chunk, batch, head), all
//     chunks at once; warps i and i + 4 own sub-chunk i's 16 rows, as t
//     and as s, each a half of every product's 64 output columns.
//     Phase 1: dA = dy v^T (k = d, to shared memory), the carry-in exp(cm1)
//       (dy S_in^T) (k = d) as drg's start; then, while dS is staged by
//       cp.async over S_in's tile, the gated sums over dA: drg's blocks j
//       < i, each dA_ij K~_j (16 x 16 by 16 x 64, K~_j = k exp(e_j - cum))
//       scaled by exp(cm1_t - e_j) and added in j order; dkg's blocks i >
//       j (rows s = the warp's), each dA_ij^T R~_i (R~_i = r exp(cm1 -
//       e_{i-1})) scaled by exp(e_{i-1} - cum_s) and added in i order, so
//       each warp takes three blocks at chunk 64 (i of drg's, 3 - i of
//       dkg's); each sub-chunk's lower-left quadrant (steps 8..15 against
//       0..7) the same way on the tensor cores, recentred at e' = the
//       cumsum at its step 7; only the pairs of the two 8-step triangles
//       take the exact gate, a pair at a time in order, each lane on one
//       of drg's or dkg's pairs a step (no divergence); dr.
//     Phase 2 (rows s): A^T into dA's tile, by blocks as K6's rwkv6_outputs
//       forms A (blocks i > j as K~ R~^T, R~ = r exp(cm1 - e_j); the
//       diagonal block's quadrant at e' and its two triangles with the
//       exact gate a pair, the forward's lanes and order, each warp of the
//       pair over half the channels, the halves added as the block is
//       read); dv = K^ dS (K^ = k exp(cQ - cum), k = c) + A^T dy (k = t);
//       dkg's state term exp(cQ - cum) (v dS^T) (k = d); dk.
//     Then, over r drg and k dkg kept in freed tiles: sum_d dS S_out and
//     the chunk's share of du (lanes over d or t, an xor tree), and
//     dcum's reverse cumsum, one thread a channel, in time order.
//     Two warps a sub-chunk, because the kernel is held by latency: 117
//     registers a thread (bf16) and 101 KB of shared memory give two
//     CTAs, 16 warps, an SM, where one warp a sub-chunk gives 8.
//   rwkv6_bwd_fold: du summed over (batch, chunk) in order.
// Products: split TF32 on mma.sync (tf32_mma.cuh gives the order of the
// TF32 products); v exact when bf16 (in dA and dkg's state term), the
// gated tiles, dy, dA and the states split. kernels/ref.py:
// rwkv6_scan_bwd_split_ref emulates this order on the CPU.

#include "tf32_mma.cuh"

namespace {

constexpr int DH = 64, QMAX = 64, SUB = 16;
// rwkv6_bwd_states: CB column blocks of 16 a CTA (as rwkv6_states)
constexpr int CB = 2, ST_THREADS = 128 * CB, NB = 4 / CB;
// rwkv6_bwd_chunks: two warps a 16-step sub-chunk, warp w sub-chunk w % 4
// and column half w / 4 of each product's 64 output columns
constexpr int CH_THREADS = 256;
// Row pitches in elements, multiples of 16 bytes for cp.async: the states
// kernel reads r and cum as A with k by t (72) and dy as B with k by t
// (LDVS); the chunk kernel reads dy as A with rows by g (68), the state
// tiles as B with columns by g (68), dA transposed with k by t (72) and
// A^T with rows by g (68).
constexpr int LDT = 72, LDVS = 16 * CB + 8, LDY = 68, LDC = 68, LDS = 68, LDA = 72, LDAT = 68;
template <class T> constexpr int kRowPitch = std::is_same<T, float>::value ? 68 : 72;

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ int padded(int Q) { return (Q + SUB - 1) / SUB * SUB; }
__device__ __forceinline__ void zero(float (&a)[4][4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[m][i] = 0.f;
}

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* logw;
  const float* u;            // (H, DH) contiguous
  const float* chunk_state;  // the forward's scratch (B, H, nc, DH, DH): state entering chunk c
  const float* state;        // the forward's final state (B, H, DH, DH)
  const float* dy;           // (B, H, S, DH), strides ys, last axis contiguous
  const float* dstate;       // (B, H, DH, DH) contiguous, or null (zero)
  float* ds;                 // scratch (B, H, nc, DH, DH): gradient of the state leaving chunk c
  float* du_part;            // scratch (B, H, nc, DH)
  void* dr;                  // contiguous (B, H, S, DH), r's type
  void* dk;
  void* dv;
  float* dlogw;              // contiguous (B, H, S, DH)
  float* du;                 // (H, DH)
  long long rs[3], ks[3], vs[3], ws[3], ys[3];  // element strides (b, h, s)
  int B, H, S, Q, nc;
  int vec;   // r, k, v, logw rows start on 16 bytes: 16-byte cp.async
  int yvec;  // dy rows start on 16 bytes
};

// One channel's inclusive cumsum in place, rows 0..P-1 in time order; rows
// from Q on are padded steps and add logw 0, whatever the tile holds (the
// forward's adds, so the same bits).
__device__ __forceinline__ void cumsum_column(float* col, int pitch, int Q, int P) {
  float acc = 0.f;
  for (int t0 = 0; t0 < P; t0 += SUB) {
    float x[SUB];
#pragma unroll
    for (int i = 0; i < SUB; ++i) x[i] = t0 + i < Q ? col[(t0 + i) * pitch] : 0.f;
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
      acc = __fadd_rn(acc, x[i]);
      col[(t0 + i) * pitch] = acc;
    }
  }
}

// ------------------------------------------------------- reverse dS pass

template <class T>
struct StatesSmem {
  T R[2][QMAX * LDT];
  float W[2][QMAX * LDT];    // logw, then its cumsum in place
  float DY[2][QMAX * LDVS];  // this CTA's columns of dy
};

template <class T>
__global__ void __launch_bounds__(ST_THREADS, 3) rwkv6_bwd_states(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<StatesSmem<T>*>(smem_raw);
  const int bh = blockIdx.x / NB, cg = blockIdx.x % NB, b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int Q = p.Q, P = padded(Q), nc = p.nc;
  const int c0 = 16 * (warp % 4) + g, c1 = c0 + 8;  // this thread's rows of dS
  const int vcol = 16 * (warp / 4);                  // this warp's columns in the dy tile
  const int dcol = 16 * CB * cg + vcol;              // ... and in dS
  const T* r = static_cast<const T*>(p.r) + b * p.rs[0] + h * p.rs[1];
  const float* lw = p.logw + b * p.ws[0] + h * p.ws[1];
  const float* dy = p.dy + b * p.ys[0] + h * p.ys[1] + 16 * CB * cg;

  for (int i = 0; i < 2; ++i) {  // padded steps: r and dy 0 (cp.async writes rows below Q)
    zero_tile_rows<T, ST_THREADS>(sm.R[i], LDT, Q, P);
    zero_tile_rows<float, ST_THREADS>(sm.DY[i], LDVS, Q, P);
  }
  auto stage = [&](int c, int buf) {
    const long long s0 = (long long)c * Q;
    stage_tile<T, ST_THREADS>(sm.R[buf], LDT, r + s0 * p.rs[2], p.rs[2], Q, DH, p.vec);
    stage_tile<float, ST_THREADS>(sm.W[buf], LDT, lw + s0 * p.ws[2], p.ws[2], Q, DH, p.vec);
    stage_tile<float, ST_THREADS>(sm.DY[buf], LDVS, dy + s0 * p.ys[2], p.ys[2], Q, 16 * CB,
                                  p.yvec);
  };

  float st[2][4];
  const float* dst = p.dstate ? p.dstate + (long long)bh * DH * DH : nullptr;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int d = dcol + 8 * n + 2 * t4;
    st[n][0] = dst ? dst[c0 * DH + d] : 0.f;
    st[n][1] = dst ? dst[c0 * DH + d + 1] : 0.f;
    st[n][2] = dst ? dst[c1 * DH + d] : 0.f;
    st[n][3] = dst ? dst[c1 * DH + d + 1] : 0.f;
  }
  float* ds = p.ds + (long long)bh * nc * DH * DH;

  stage(nc - 1, 0);
  cp_commit();
  for (int c = nc - 1; c >= 0; --c) {
    const int buf = (nc - 1 - c) & 1;
    cp_wait<0>();
    __syncthreads();  // chunk c staged; every warp is done with chunk c + 1
    if (c > 0) stage(c - 1, buf ^ 1);
    cp_commit();
    float* W = sm.W[buf];
    if (tid < DH) cumsum_column(W + tid, LDT, Q, P);
    __syncthreads();
    const T* R = sm.R[buf];
    const float* DY = sm.DY[buf];
    auto cm1 = [&](int t, int ch) { return t > 0 ? W[(t - 1) * LDT + ch] : 0.f; };

    // (r exp(cm1))^T dy: rows c, columns d, k = t
    float u[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) u[n][i] = 0.f;
    for (int ks = 0; ks < P / 8; ++ks) {
      const int s0 = 8 * ks + t4, s1 = s0 + 4;
      const FragA fa = frag_a<false>(to_f(R[s0 * LDT + c0]) * expf(cm1(s0, c0)),
                                     to_f(R[s0 * LDT + c1]) * expf(cm1(s0, c1)),
                                     to_f(R[s1 * LDT + c0]) * expf(cm1(s1, c0)),
                                     to_f(R[s1 * LDT + c1]) * expf(cm1(s1, c1)));
#pragma unroll
      for (int n = 0; n < 2; ++n)
        mma_step<false, false>(u[n], fa, DY[s0 * LDVS + vcol + 8 * n + g],
                               DY[s1 * LDVS + vcol + 8 * n + g]);
    }
    float* out = ds + (long long)c * DH * DH;  // the gradient of the state leaving chunk c
    const float dec0 = expf(W[(P - 1) * LDT + c0]), dec1 = expf(W[(P - 1) * LDT + c1]);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int d = dcol + 8 * n + 2 * t4;
      store2(out + c0 * DH + d, st[n][0], st[n][1]);
      store2(out + c1 * DH + d, st[n][2], st[n][3]);
      st[n][0] = fmaf(st[n][0], dec0, u[n][0]);
      st[n][1] = fmaf(st[n][1], dec0, u[n][1]);
      st[n][2] = fmaf(st[n][2], dec1, u[n][2]);
      st[n][3] = fmaf(st[n][3], dec1, u[n][3]);
    }
  }
}

// ------------------------------------------------------- every chunk

template <class T>
struct ChunkSmem {
  T R[QMAX * kRowPitch<T>], K[QMAX * kRowPitch<T>], V[QMAX * kRowPitch<T>];
  float DY[QMAX * LDY];     // dy; then r drg
  float W[QMAX * LDC];      // logw, then its cumsum in place
  float S[DH * LDS];        // S_in [c][d]; then dS
  float dA[QMAX * LDA];     // dA [t][s]; then A^T [s][t] (pitch LDAT); then k dkg
  float D1[4][SUB * 17];    // each diagonal block's exact pairs over channels 32..63, [s][t]
  float u[DH], end[DH], db[QMAX];
};

// The pairs inside one 16-step sub-chunk of A^T's diagonal block take the
// forward's lanes for A's two 8-step triangles: lane 4 a + p, triangle a /
// 4, rows a % 4 and 7 - a % 4 of it (7 pairs between them), channels c = 4
// m + p, m ascending, fmaf(r k, exp(cm1_t - cum_s), acc), the four channel
// sums added by an xor tree; the diagonal the bonus sum_c fmaf(r u, k,
// acc) in the same order (csrc/rwkv6_scan.cu: rwkv6_outputs). Here the
// sub-chunk's two warps take channels 0..31 and 32..63, and the two sums
// are added, the first half's first, where the block is read.

template <class T>
__global__ void __launch_bounds__(CH_THREADS, 2) rwkv6_bwd_chunks(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<ChunkSmem<T>*>(smem_raw);
  constexpr int LR = kRowPitch<T>;
  constexpr bool VX = kExact<T>;
  const int ch = blockIdx.x, bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int Q = p.Q, P = padded(Q), nsub = P / SUB;
  const long long s0 = (long long)ch * Q;
  const T* rg = static_cast<const T*>(p.r) + b * p.rs[0] + h * p.rs[1] + s0 * p.rs[2];
  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + h * p.ks[1] + s0 * p.ks[2];
  const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + h * p.vs[1] + s0 * p.vs[2];
  const float* lw = p.logw + b * p.ws[0] + h * p.ws[1] + s0 * p.ws[2];
  const float* dyg = p.dy + b * p.ys[0] + h * p.ys[1] + s0 * p.ys[2];

  zero_tile_rows<T, CH_THREADS>(sm.R, LR, Q, P);  // padded steps: 0
  zero_tile_rows<T, CH_THREADS>(sm.K, LR, Q, P);
  zero_tile_rows<T, CH_THREADS>(sm.V, LR, Q, P);
  zero_tile_rows<float, CH_THREADS>(sm.DY, LDY, Q, P);
  stage_tile<T, CH_THREADS>(sm.R, LR, rg, p.rs[2], Q, DH, p.vec);
  stage_tile<T, CH_THREADS>(sm.K, LR, kg, p.ks[2], Q, DH, p.vec);
  stage_tile<T, CH_THREADS>(sm.V, LR, vg, p.vs[2], Q, DH, p.vec);
  stage_tile<float, CH_THREADS>(sm.W, LDC, lw, p.ws[2], Q, DH, p.vec);
  stage_tile<float, CH_THREADS>(sm.DY, LDY, dyg, p.ys[2], Q, DH, p.yvec);
  const long long st0 = ((long long)bh * p.nc + ch) * DH * DH;  // this chunk's states
  if (ch > 0) stage_tile<float, CH_THREADS>(sm.S, LDS, p.chunk_state + st0, DH, DH, DH, true);
  if (tid < DH) sm.u[tid] = p.u[h * DH + tid];
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  if (tid < DH) cumsum_column(sm.W + tid, LDC, Q, P);
  __syncthreads();

  auto cm1 = [&](int t, int c) { return t > 0 ? sm.W[(t - 1) * LDC + c] : 0.f; };
  auto rv = [&](int t, int c) { return to_f(sm.R[t * LR + c]); };
  auto kv = [&](int t, int c) { return to_f(sm.K[t * LR + c]); };
  auto vv = [&](int t, int c) { return to_f(sm.V[t * LR + c]); };
  const int sub = warp % 4, hf = warp / 4;    // this warp's sub-chunk and column half
  const bool active = sub < nsub;
  const int i0 = SUB * sub;
  const int t0 = i0 + g, t1 = t0 + 8;         // this thread's rows (t, then s)
  const int m0 = 4 * hf;                      // this warp's column tiles: m0..m0 + 3
  const int ep_at = (i0 + 7) * LDC;           // e': the cumsum at this sub-chunk's step 7
  const int cq_at = (P - 1) * LDC;                // cQ: the chunk's last cumsum

  // ---- phase 1, rows t: dA = dy v^T (the half's column tiles s <= this
  // sub-chunk's last) and the carry-in exp(cm1) (dy S_in^T), k = d, as
  // drg's start
  float drg[4][4], dkg[4][4], acc[4][4];
  zero(drg);
  zero(dkg);
  if (active) {
    float da[4][4];
    zero(da);
#pragma unroll 2
    for (int ks = 0; ks < 8; ++ks) {
      const int d0 = 8 * ks + t4, d1 = d0 + 4;
      const FragA fa = frag_a<false>(sm.DY[t0 * LDY + d0], sm.DY[t1 * LDY + d0],
                                     sm.DY[t0 * LDY + d1], sm.DY[t1 * LDY + d1]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 2 * jj + hf;
        if (j <= 2 * sub + 1)
          mma_step<false, VX>(da[jj], fa, vv(8 * j + g, d0), vv(8 * j + g, d1));
      }
      if (ch > 0) {
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          const int m = m0 + mm;
          mma_step<false, false>(drg[mm], fa, sm.S[(8 * m + g) * LDS + d0],
                                 sm.S[(8 * m + g) * LDS + d1]);
        }
      }
    }
#pragma unroll
    for (int mm = 0; mm < 4; ++mm) {
      const int c = 8 * (m0 + mm) + 2 * t4;
      drg[mm][0] *= expf(cm1(t0, c));
      drg[mm][1] *= expf(cm1(t0, c + 1));
      drg[mm][2] *= expf(cm1(t1, c));
      drg[mm][3] *= expf(cm1(t1, c + 1));
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 2 * jj + hf;
      if (j > 2 * sub + 1) continue;
      store2(sm.dA + t0 * LDA + 8 * j + 2 * t4, da[jj][0], da[jj][1]);
      store2(sm.dA + t1 * LDA + 8 * j + 2 * t4, da[jj][2], da[jj][3]);
    }
  }
  __syncthreads();  // dA whole; every warp is done with S_in: dS is staged over it
  stage_tile<float, CH_THREADS>(sm.S, LDS, p.ds + ((long long)bh * p.nc + ch) * DH * DH, DH, DH, DH,
                                true);
  cp_commit();

  // ---- phase 1, the gated sums over dA (read from shared memory): drg
  // for rows t of sub-chunk i = sub (blocks j < i, then i's quadrant and
  // triangles) and dkg for rows s of sub-chunk j = sub (blocks i > j, then
  // j's quadrant and triangles), each on the warp's half of the channels;
  // every warp takes three blocks at chunk 64
  // this chunk's first gradient row
  auto rows_at = [&]() { return ((long long)bh * p.S + (long long)ch * Q) * DH; };
  if (active) {
    // drg's blocks j < i: dA_ij K~_j, K~_j = k exp(e_j - cum) (k = s),
    // scaled by exp(cm1_t - e_j), added in j order
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j >= sub) continue;
      const int e_at = (SUB * j + SUB - 1) * LDC;  // e_j
      zero(acc);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int sa = SUB * j + 8 * kk + t4, sb = sa + 4;
        const FragA fa = frag_a<false>(sm.dA[t0 * LDA + sa], sm.dA[t1 * LDA + sa],
                                       sm.dA[t0 * LDA + sb], sm.dA[t1 * LDA + sb]);
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          const int c = 8 * (m0 + mm) + g;
          mma_step<false, false>(acc[mm], fa, kv(sa, c) * expf(sm.W[e_at + c] - sm.W[sa * LDC + c]),
                                 kv(sb, c) * expf(sm.W[e_at + c] - sm.W[sb * LDC + c]));
        }
      }
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) {
        const int c = 8 * (m0 + mm) + 2 * t4;
        drg[mm][0] = fmaf(expf(cm1(t0, c) - sm.W[e_at + c]), acc[mm][0], drg[mm][0]);
        drg[mm][1] = fmaf(expf(cm1(t0, c + 1) - sm.W[e_at + c + 1]), acc[mm][1], drg[mm][1]);
        drg[mm][2] = fmaf(expf(cm1(t1, c) - sm.W[e_at + c]), acc[mm][2], drg[mm][2]);
        drg[mm][3] = fmaf(expf(cm1(t1, c + 1) - sm.W[e_at + c + 1]), acc[mm][3], drg[mm][3]);
      }
    }
    // sub-chunk i's quadrant (rows t1, steps 8..15, against s 0..7),
    // recentred at e': dA's rows t1 as A (rows t0 zero), K~' = k exp(e' -
    // cum), one k-step
    {
      zero(acc);
      const int sa = i0 + t4, sb = sa + 4;
      const FragA fa = frag_a<false>(0.f, sm.dA[t1 * LDA + sa], 0.f, sm.dA[t1 * LDA + sb]);
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) {
        const int c = 8 * (m0 + mm) + g;
        mma_step<false, false>(acc[mm], fa, kv(sa, c) * expf(sm.W[ep_at + c] - sm.W[sa * LDC + c]),
                               kv(sb, c) * expf(sm.W[ep_at + c] - sm.W[sb * LDC + c]));
      }
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) {
        const int c = 8 * (m0 + mm) + 2 * t4;
        drg[mm][2] = fmaf(expf(cm1(t1, c) - sm.W[ep_at + c]), acc[mm][2], drg[mm][2]);
        drg[mm][3] = fmaf(expf(cm1(t1, c + 1) - sm.W[ep_at + c + 1]), acc[mm][3], drg[mm][3]);
      }
    }
    // dkg's blocks i > j: dA_ij^T R~_i, R~_i = r exp(cm1 - e_{i-1}) (k =
    // t), scaled by exp(e_{i-1} - cum_s), added in i order
#pragma unroll
    for (int bi = 0; bi < 3; ++bi) {
      const int i = sub + 1 + bi;
      if (i >= nsub) continue;
      const int e_at = (SUB * i - 1) * LDC;  // e_{i-1}
      zero(acc);
#pragma unroll 1  // fewer registers live: two CTAs an SM with no spill
      for (int kk = 0; kk < 2; ++kk) {
        const int ta = SUB * i + 8 * kk + t4, tb = ta + 4;
        const FragA fa = frag_a<false>(sm.dA[ta * LDA + t0], sm.dA[ta * LDA + t1],
                                       sm.dA[tb * LDA + t0], sm.dA[tb * LDA + t1]);
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          const int c = 8 * (m0 + mm) + g;
          mma_step<false, false>(acc[mm], fa, rv(ta, c) * expf(cm1(ta, c) - sm.W[e_at + c]),
                                 rv(tb, c) * expf(cm1(tb, c) - sm.W[e_at + c]));
        }
      }
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) {
        const int c = 8 * (m0 + mm) + 2 * t4;
        dkg[mm][0] = fmaf(expf(sm.W[e_at + c] - sm.W[t0 * LDC + c]), acc[mm][0], dkg[mm][0]);
        dkg[mm][1] =
            fmaf(expf(sm.W[e_at + c + 1] - sm.W[t0 * LDC + c + 1]), acc[mm][1], dkg[mm][1]);
        dkg[mm][2] = fmaf(expf(sm.W[e_at + c] - sm.W[t1 * LDC + c]), acc[mm][2], dkg[mm][2]);
        dkg[mm][3] =
            fmaf(expf(sm.W[e_at + c + 1] - sm.W[t1 * LDC + c + 1]), acc[mm][3], dkg[mm][3]);
      }
    }
    // sub-chunk j's quadrant for dkg (rows s = t0, steps 0..7, against t
    // 8..15): dA^T as A (rows t1 zero), R~' = r exp(cm1 - e'), one k-step
    {
      zero(acc);
      const int ta = i0 + 8 + t4, tb = ta + 4;
      const FragA fa = frag_a<false>(sm.dA[ta * LDA + t0], 0.f, sm.dA[tb * LDA + t0], 0.f);
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) {
        const int c = 8 * (m0 + mm) + g;
        mma_step<false, false>(acc[mm], fa, rv(ta, c) * expf(cm1(ta, c) - sm.W[ep_at + c]),
                               rv(tb, c) * expf(cm1(tb, c) - sm.W[ep_at + c]));
      }
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) {
        const int c = 8 * (m0 + mm) + 2 * t4;
        dkg[mm][0] = fmaf(expf(sm.W[ep_at + c] - sm.W[t0 * LDC + c]), acc[mm][0], dkg[mm][0]);
        dkg[mm][1] =
            fmaf(expf(sm.W[ep_at + c + 1] - sm.W[t0 * LDC + c + 1]), acc[mm][1], dkg[mm][1]);
      }
    }
    // the two 8-step triangles with the exact gate, a pair at a time in
    // order: drg over s < t (s ascending), dkg over t > s (t ascending);
    // rows t0 and t1 are step g of each triangle. At step x a lane's pair
    // is drg's (s = x, when x < g) or else dkg's (t = x + 1): one exp and
    // one fmaf a lane and entry, the operands selected, no divergence; the
    // column tiles in two passes, to keep fewer values live
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll 1
    for (int x = 0; x < 7; ++x) {
      const bool lo = x < g;
      const int sx0 = i0 + x, sx1 = i0 + 8 + x;        // drg's s, or dkg's t - 1
      const float a0 = lo ? sm.dA[t0 * LDA + sx0] : sm.dA[(sx0 + 1) * LDA + t0];
      const float a1 = lo ? sm.dA[t1 * LDA + sx1] : sm.dA[(sx1 + 1) * LDA + t1];
#pragma unroll
      for (int mm = 2 * half; mm < 2 * half + 2; ++mm) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = 8 * (m0 + mm) + 2 * t4 + (q & 1);
          const int t = q < 2 ? t0 : t1, sx = q < 2 ? sx0 : sx1;
          // drg: dA[t, sx] k[sx] exp(cm1_t - cum_sx); dkg: dA[sx + 1, t]
          // r[sx + 1] exp(cm1_{sx + 1} - cum_t), cm1_{sx + 1} = cum_sx
          const float w = lo ? kv(sx, c) : rv(sx + 1, c);
          const float arg =
              lo ? cm1(t, c) - sm.W[sx * LDC + c] : sm.W[sx * LDC + c] - sm.W[t * LDC + c];
          const float v = fmaf((q < 2 ? a0 : a1) * w, expf(arg), lo ? drg[mm][q] : dkg[mm][q]);
          drg[mm][q] = lo ? v : drg[mm][q];
          dkg[mm][q] = lo ? dkg[mm][q] : v;
        }
      }
    }
    }
    // dr, and r drg for dcum
    T* dr = static_cast<T*>(p.dr) + rows_at();
#pragma unroll
    for (int mm = 0; mm < 4; ++mm) {
      const int c = 8 * (m0 + mm) + 2 * t4;
      const float db0 = sm.dA[t0 * LDA + t0], db1 = sm.dA[t1 * LDA + t1];
      if (t0 < Q)
        store2(dr + (long long)t0 * DH + c, fmaf(db0 * sm.u[c], kv(t0, c), drg[mm][0]),
               fmaf(db0 * sm.u[c + 1], kv(t0, c + 1), drg[mm][1]));
      if (t1 < Q)
        store2(dr + (long long)t1 * DH + c, fmaf(db1 * sm.u[c], kv(t1, c), drg[mm][2]),
               fmaf(db1 * sm.u[c + 1], kv(t1, c + 1), drg[mm][3]));
      drg[mm][0] *= rv(t0, c);
      drg[mm][1] *= rv(t0, c + 1);
      drg[mm][2] *= rv(t1, c);
      drg[mm][3] *= rv(t1, c + 1);
    }
  }
  if (tid < P) sm.db[tid] = sm.dA[tid * LDA + tid];
  cp_wait<0>();
  __syncthreads();  // dS staged; every warp is done with dA: A^T goes over it

  // ---- phase 2, rows s: A^T into shared memory, by blocks as K6's
  // rwkv6_outputs forms A: blocks i > j as K~ R~^T (K~ = k exp(e_j - cum),
  // R~ = r exp(cm1 - e_j), k = c; the warp's n-tile of each), the diagonal
  // block's quadrant (s 0..7 against t 8..15) recentred at e' and its two
  // triangles with the exact gate (each warp half of the channels)
  if (active) {
    const int j = sub;
    const int e_at = (i0 + SUB - 1) * LDC;  // e_j
    if (j + 1 < nsub) {
      float at[3][4];
#pragma unroll
      for (int bi = 0; bi < 3; ++bi)
#pragma unroll
        for (int q = 0; q < 4; ++q) at[bi][q] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < 8; ++ks) {
        const int a0 = 8 * ks + t4, a1 = a0 + 4;
        const float e0 = sm.W[e_at + a0], e1 = sm.W[e_at + a1];
        const FragA fk = frag_a<false>(kv(t0, a0) * expf(e0 - sm.W[t0 * LDC + a0]),
                                       kv(t1, a0) * expf(e0 - sm.W[t1 * LDC + a0]),
                                       kv(t0, a1) * expf(e1 - sm.W[t0 * LDC + a1]),
                                       kv(t1, a1) * expf(e1 - sm.W[t1 * LDC + a1]));
#pragma unroll
        for (int bi = 0; bi < 3; ++bi) {
          const int i = j + 1 + bi;
          if (i >= nsub) continue;
          const int t = SUB * i + 8 * hf + g;
          mma_step<false, false>(at[bi], fk, rv(t, a0) * expf(cm1(t, a0) - e0),
                                 rv(t, a1) * expf(cm1(t, a1) - e1));
        }
      }
#pragma unroll
      for (int bi = 0; bi < 3; ++bi) {
        const int i = j + 1 + bi;
        if (i >= nsub) continue;
        const int t = SUB * i + 8 * hf + 2 * t4;
        store2(sm.dA + t0 * LDAT + t, at[bi][0], at[bi][1]);
        store2(sm.dA + t1 * LDAT + t, at[bi][2], at[bi][3]);
      }
    }
    const int a = lane / 4, pc = lane % 4;
    const int base = i0 + 8 * (a / 4), ta = base + a % 4, tb = base + 7 - a % 4;
    const int split_q = 7 - a % 4;  // row tb takes pairs q < split_q, row ta the rest
    float tri[7], bon_a = 0.f, bon_b = 0.f;
#pragma unroll
    for (int q = 0; q < 7; ++q) tri[q] = 0.f;
    for (int m = 8 * hf; m < 8 * hf + 8; ++m) {
      const int c = 4 * m + pc;
      const float ra = rv(ta, c), rb = rv(tb, c), ma = cm1(ta, c), mb = cm1(tb, c);
      const float uc = sm.u[c];
      bon_a = fmaf(ra * uc, kv(ta, c), bon_a);
      bon_b = fmaf(rb * uc, kv(tb, c), bon_b);
#pragma unroll
      for (int q = 0; q < 7; ++q) {
        const bool on_b = q < split_q;
        const int s = base + (on_b ? q : q - split_q);
        tri[q] = fmaf((on_b ? rb : ra) * kv(s, c), expf((on_b ? mb : ma) - sm.W[s * LDC + c]),
                      tri[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < 7; ++q) {  // (a_0 + a_1) + (a_2 + a_3)
      tri[q] += __shfl_xor_sync(0xffffffffu, tri[q], 1);
      tri[q] += __shfl_xor_sync(0xffffffffu, tri[q], 2);
    }
    bon_a += __shfl_xor_sync(0xffffffffu, bon_a, 1);
    bon_a += __shfl_xor_sync(0xffffffffu, bon_a, 2);
    bon_b += __shfl_xor_sync(0xffffffffu, bon_b, 1);
    bon_b += __shfl_xor_sync(0xffffffffu, bon_b, 2);
    // the first half writes the block into A^T (0 where t < s, the
    // quadrant, its pairs); the second half its pairs into D1, 0 elsewhere
    float* D = hf == 0 ? sm.dA + i0 * LDAT + i0 : sm.D1[sub];
    const int ld = hf == 0 ? LDAT : 17;
    for (int e2 = lane; e2 < SUB * SUB; e2 += 32) {
      const int sl = e2 / SUB, tl = e2 % SUB;
      if (hf == 1 || tl < sl) D[sl * ld + tl] = 0.f;
    }
    if (hf == 0) {
      float cross[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
      for (int ks = 0; ks < 8; ++ks) {
        const int a0 = 8 * ks + t4, a1 = a0 + 4, tx = i0 + 8 + g;
        const float e0 = sm.W[ep_at + a0], e1 = sm.W[ep_at + a1];
        const FragA fk = frag_a<false>(kv(t0, a0) * expf(e0 - sm.W[t0 * LDC + a0]), 0.f,
                                       kv(t0, a1) * expf(e1 - sm.W[t0 * LDC + a1]), 0.f);
        mma_step<false, false>(cross, fk, rv(tx, a0) * expf(cm1(tx, a0) - e0),
                               rv(tx, a1) * expf(cm1(tx, a1) - e1));
      }
      store2(D + g * ld + 8 + 2 * t4, cross[0], cross[1]);
    }
    __syncwarp();
    if (pc == 0) {
#pragma unroll
      for (int q = 0; q < 7; ++q) {
        const bool on_b = q < split_q;
        const int s = base + (on_b ? q : q - split_q), t = on_b ? tb : ta;
        D[(s - i0) * ld + t - i0] = tri[q];
      }
      D[(ta - i0) * ld + ta - i0] = bon_a;
      D[(tb - i0) * ld + tb - i0] = bon_b;
    }
  }
  __syncthreads();  // A^T whole

  // ---- phase 2, rows s, the warp's half of the columns: dv = K^ dS (K^ =
  // k exp(cQ - cum), k = c) + A^T dy (k = t >= this sub-chunk's first; the
  // diagonal block's two halves added as it is read); dkg's state term
  // exp(cQ - cum) (v dS^T) (k = d); dk
  if (active) {
    zero(acc);
#pragma unroll 2
    for (int ks = 0; ks < 8; ++ks) {
      const int a0 = 8 * ks + t4, a1 = a0 + 4;
      const FragA fk = frag_a<false>(kv(t0, a0) * expf(sm.W[cq_at + a0] - sm.W[t0 * LDC + a0]),
                                     kv(t1, a0) * expf(sm.W[cq_at + a0] - sm.W[t1 * LDC + a0]),
                                     kv(t0, a1) * expf(sm.W[cq_at + a1] - sm.W[t0 * LDC + a1]),
                                     kv(t1, a1) * expf(sm.W[cq_at + a1] - sm.W[t1 * LDC + a1]));
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) {
        const int m = m0 + mm;
        mma_step<false, false>(acc[mm], fk, sm.S[a0 * LDS + 8 * m + g], sm.S[a1 * LDS + 8 * m + g]);
      }
    }
    const float* D1 = sm.D1[sub];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {  // the diagonal block
      const int ka = 8 * kk + t4, kb = ka + 4;
      const FragA fa = frag_a<false>(sm.dA[t0 * LDAT + i0 + ka] + D1[g * 17 + ka],
                                     sm.dA[t1 * LDAT + i0 + ka] + D1[(g + 8) * 17 + ka],
                                     sm.dA[t0 * LDAT + i0 + kb] + D1[g * 17 + kb],
                                     sm.dA[t1 * LDAT + i0 + kb] + D1[(g + 8) * 17 + kb]);
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) {
        const int m = m0 + mm;
        mma_step<false, false>(acc[mm], fa, sm.DY[(i0 + ka) * LDY + 8 * m + g],
                               sm.DY[(i0 + kb) * LDY + 8 * m + g]);
      }
    }
    for (int kt = 2 * sub + 2; kt < 2 * nsub; ++kt) {  // the blocks i > j
      const int ka = 8 * kt + t4, kb = ka + 4;
      const FragA fa = frag_a<false>(sm.dA[t0 * LDAT + ka], sm.dA[t1 * LDAT + ka],
                                     sm.dA[t0 * LDAT + kb], sm.dA[t1 * LDAT + kb]);
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) {
        const int m = m0 + mm;
        mma_step<false, false>(acc[mm], fa, sm.DY[ka * LDY + 8 * m + g],
                               sm.DY[kb * LDY + 8 * m + g]);
      }
    }
    T* dv = static_cast<T*>(p.dv) + rows_at();
#pragma unroll
    for (int mm = 0; mm < 4; ++mm) {
      const int d = 8 * (m0 + mm) + 2 * t4;
      if (t0 < Q) store2(dv + (long long)t0 * DH + d, acc[mm][0], acc[mm][1]);
      if (t1 < Q) store2(dv + (long long)t1 * DH + d, acc[mm][2], acc[mm][3]);
    }

    zero(acc);
#pragma unroll 2
    for (int ks = 0; ks < 8; ++ks) {
      const int d0 = 8 * ks + t4, d1 = d0 + 4;
      const FragA fv = frag_a<VX>(vv(t0, d0), vv(t1, d0), vv(t0, d1), vv(t1, d1));
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) {
        const int m = m0 + mm;
        mma_step<VX, false>(acc[mm], fv, sm.S[(8 * m + g) * LDS + d0],
                            sm.S[(8 * m + g) * LDS + d1]);
      }
    }
    T* dk = static_cast<T*>(p.dk) + rows_at();
#pragma unroll
    for (int mm = 0; mm < 4; ++mm) {
      const int c = 8 * (m0 + mm) + 2 * t4;
      dkg[mm][0] = fmaf(expf(sm.W[cq_at + c] - sm.W[t0 * LDC + c]), acc[mm][0], dkg[mm][0]);
      dkg[mm][1] = fmaf(expf(sm.W[cq_at + c + 1] - sm.W[t0 * LDC + c + 1]), acc[mm][1], dkg[mm][1]);
      dkg[mm][2] = fmaf(expf(sm.W[cq_at + c] - sm.W[t1 * LDC + c]), acc[mm][2], dkg[mm][2]);
      dkg[mm][3] = fmaf(expf(sm.W[cq_at + c + 1] - sm.W[t1 * LDC + c + 1]), acc[mm][3], dkg[mm][3]);
      const float db0 = sm.db[t0], db1 = sm.db[t1];
      if (t0 < Q)
        store2(dk + (long long)t0 * DH + c, fmaf(db0 * sm.u[c], rv(t0, c), dkg[mm][0]),
               fmaf(db0 * sm.u[c + 1], rv(t0, c + 1), dkg[mm][1]));
      if (t1 < Q)
        store2(dk + (long long)t1 * DH + c, fmaf(db1 * sm.u[c], rv(t1, c), dkg[mm][2]),
               fmaf(db1 * sm.u[c + 1], rv(t1, c + 1), dkg[mm][3]));
      dkg[mm][0] *= kv(t0, c);
      dkg[mm][1] *= kv(t0, c + 1);
      dkg[mm][2] *= kv(t1, c);
      dkg[mm][3] *= kv(t1, c + 1);
    }
  }
  __syncthreads();  // every warp is done with dy and A^T: r drg and k dkg go over them
  if (active) {
#pragma unroll
    for (int mm = 0; mm < 4; ++mm) {
      const int c = 8 * (m0 + mm) + 2 * t4;
      store2(sm.DY + t0 * LDY + c, drg[mm][0], drg[mm][1]);
      store2(sm.DY + t1 * LDY + c, drg[mm][2], drg[mm][3]);
      store2(sm.dA + t0 * LDA + c, dkg[mm][0], dkg[mm][1]);
      store2(sm.dA + t1 * LDA + c, dkg[mm][2], dkg[mm][3]);
    }
  }
  // per channel, warp w channels 8 w..8 w + 7, the lanes over d (or t) and
  // an xor tree: sum_d dS S_out, and the chunk's share of du
  const float* sout = ch + 1 < p.nc ? p.chunk_state + ((long long)bh * p.nc + ch + 1) * DH * DH
                                    : p.state + (long long)bh * DH * DH;
  for (int cc = 0; cc < DH / 8; ++cc) {
    const int c = (DH / 8) * warp + cc;
    const float* out = sout + c * DH;
    float end = fmaf(sm.S[c * LDS + lane + 32], out[lane + 32], sm.S[c * LDS + lane] * out[lane]);
    float du = 0.f;
    for (int t = lane; t < Q; t += 32) du = fmaf(sm.db[t] * rv(t, c), kv(t, c), du);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      end += __shfl_xor_sync(0xffffffffu, end, off);
      du += __shfl_xor_sync(0xffffffffu, du, off);
    }
    if (lane == 0) {
      sm.end[c] = end;
      p.du_part[((long long)bh * p.nc + ch) * DH + c] = du;
    }
  }
  __syncthreads();

  if (tid < DH) {  // dcum and its reverse cumsum, one thread a channel
    const int c = tid;
    float* dlogw = p.dlogw + rows_at() + c;
    float acc_ = 0.f;
    for (int j = Q - 1; j >= 0; --j) {
      float dcum = (j + 1 < Q ? sm.DY[(j + 1) * LDY + c] : 0.f) - sm.dA[j * LDA + c];
      if (j == Q - 1) dcum += sm.end[c];
      acc_ += dcum;
      dlogw[(long long)j * DH] = acc_;
    }
  }
}

// ------------------------------------------------------- fold

__global__ void rwkv6_bwd_fold(Params p) {
  const int h = blockIdx.x, c = threadIdx.x;
  float du = 0.f;
  for (int b = 0; b < p.B; ++b)
    for (int ch = 0; ch < p.nc; ++ch)
      du += p.du_part[(((long long)b * p.H + h) * p.nc + ch) * DH + c];
  p.du[h * DH + c] = du;
}

template <class T>
int launch(const Params& p, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int st_smem = (int)sizeof(StatesSmem<T>), ch_smem = (int)sizeof(ChunkSmem<T>);
  cudaError_t err = cudaFuncSetAttribute(rwkv6_bwd_states<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, st_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rwkv6_bwd_chunks<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ch_smem);
  if (err != cudaSuccess) return (int)err;
  rwkv6_bwd_states<T><<<p.B * p.H * NB, ST_THREADS, st_smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rwkv6_bwd_chunks<T><<<dim3(p.nc, p.B * p.H), CH_THREADS, ch_smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rwkv6_bwd_fold<<<p.H, DH, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v: (B, H, S, dh) of one dtype (bf16 != 0: bfloat16, else float32);
// logw: (B, H, S, dh) float32; dy: (B, H, S, dh) float32; each with
// element strides (batch, head, seq) and a contiguous last axis. u:
// contiguous (H, dh) float32. chunk_state and state: the forward's scratch
// and final state of the same inputs and chunk Q; dstate: contiguous (B,
// H, dh, dh) float32 or null. ds (B * H * (S / Q) * dh * dh floats) and
// du_part (B * H * (S / Q) * dh) are the caller's scratch. Writes dr, dk,
// dv (contiguous, r's shape and type), dlogw (contiguous float32) and du
// (H, dh) float32. Three launches on `stream`.
extern "C" int rwkv6_scan_bwd(const void* r, const void* k, const void* v, const float* logw,
                              const float* u, const float* chunk_state, const float* state,
                              const float* dy, const float* dstate, float* ds, float* du_part,
                              void* dr, void* dk, void* dv, float* dlogw, float* du, int bf16,
                              int B, int H, int S, int dh, int Q, long long rsb, long long rsh,
                              long long rss, long long ksb, long long ksh, long long kss,
                              long long vsb, long long vsh, long long vss, long long wsb,
                              long long wsh, long long wss, long long ysb, long long ysh,
                              long long yss, void* stream) {
  if (dh != DH || B < 1 || H < 1 || Q < 1 || Q > QMAX || S < Q || S % Q || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long eb = bf16 ? 2 : 4;
  const int vec = aligned16(r, eb, {rsb, rsh, rss}) && aligned16(k, eb, {ksb, ksh, kss}) &&
                  aligned16(v, eb, {vsb, vsh, vss}) && aligned16(logw, 4, {wsb, wsh, wss});
  const int yvec = aligned16(dy, 4, {ysb, ysh, yss});
  const Params p{r,  k,  v,  logw, u,  chunk_state, state, dy, dstate, ds, du_part, dr, dk, dv,
                 dlogw, du, {rsb, rsh, rss}, {ksb, ksh, kss}, {vsb, vsh, vss}, {wsb, wsh, wss},
                 {ysb, ysh, yss}, B, H, S, Q, S / Q, vec, yvec};
  return bf16 ? launch<__nv_bfloat16>(p, stream) : launch<float>(p, stream);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
