// RWKV6 WKV chunked scan (K6): data-dependent per-channel decay, a
// (dh, dh) fp32 state carried across the chunks of each (batch, head).
//
// Replaces the Pallas kernel repro/kernels/rwkv6_scan.py:rwkv6_scan. The
// function is the Pallas kernel's code, per chunk of Q steps, in fp32:
//   cum      inclusive cumsum of logw over the chunk, in time order;
//   cm1      the exclusive one, cum_{t-1} (0 at step 0), as the model's
//            _wkv_chunked takes it; cQ the chunk's last cum;
//   A[t,s] = sum_c r[t,c] k[s,c] exp(cm1[t,c] - cum[s,c]), s < t only;
//   y_t    = sum_{s<t} A[t,s] v_s + (sum_c r u k)[t] v_t
//            + (r_t * exp(cm1_t)) . state;
//   state' = diag(exp(cQ)) state + (k * exp(cQ - cum))^T v.
// It also writes the final state, which the model's prefill stores in the
// decode cache (the Pallas kernel keeps it in scratch and drops it).
// Not the "factored" form the Pallas kernel's docstring names, with the
// reference point at the chunk's end: there cm1_t - cQ reaches 63 x 30 =
// 1,890 under the model's clamp (logw in [-30, 0]) and expf overflows.
//
// Bound on an H100 (NVIDIA's data sheet: 3.35 TB/s, 495 TFLOP/s TF32,
// 67 TFLOP/s fp32): bytes. At the serving shape (RWKV6-3B: 4 x 40 heads x
// 2,048 steps x 64, bf16 r, k, v) the function reads and writes 296 MB,
// 0.088 ms; its state products on split TF32 and the exact gate of its
// cheapest chunk need less time.
//
// Design: the chunk-parallel form in two launches, no grid barrier and no
// flags between CTAs; the wrapper counts the call once.
//   rwkv6_states, one CTA of 4 CB warps per (batch, head, CB blocks of 16
//     columns of v and the state; the columns d are independent): the
//     chunks in order, the next one's k, logw and v columns staged by
//     cp.async while this one computes; cum in time order (a thread a
//     channel); U_c = K^T v on the tensor cores, K^ = k exp(cQ - cum)
//     made in the A fragment (exponent <= 0); the state entering chunk c
//     written to `chunk_state`; state = fmaf(state, exp(cQ), U_c) in
//     registers, row c by its own decay. The final state goes to `state`.
//   rwkv6_outputs, one CTA of 4 warps per (chunk, batch, head), all chunks
//     at once: cum again (the same adds, so the same bits); the carry-in
//     (r exp(cm1)) S_in on the tensor cores into y's accumulator; then v
//     staged by cp.async over S_in's tile while A is formed in registers
//     by 16-step sub-chunks, e_j = cum at sub-chunk j's last step:
//       blocks j < i on the tensor cores, A_ij = R~ K~^T with
//         R~[t,c] = r[t,c] exp(cm1[t,c] - e_j[c]) and
//         K~[s,c] = k[s,c] exp(e_j[c] - cum[s,c]):
//         both exponents <= 0, since cum does not increase and
//         t - 1 >= 16 j + 15 >= s (a factor that underflows stands for a
//         term below 1e-38 |r| |k|); warp w blocks w and w + 4;
//       blocks j = i, warp i: the lower-left quadrant (steps 8..15
//         against 0..7) the same way, recentred at e' = cum at the
//         sub-chunk's step 7, on an m16 tile whose rows 0..7 are 0; the
//         two 8-step triangles with the exact gate exp(cm1_t - cum_s) a
//         pair (56 pairs x 64 channels a sub-chunk, against 2,016 x 64 a
//         chunk for the whole triangle): lane 4 a + p, triangle a / 4,
//         rows a % 4 and 7 - a % 4 of it (7 pairs between them),
//         channels c = 4 m + p, m ascending, fmaf(r k, exp(..), acc); the
//         four channel sums added by an xor tree, (a_0 + a_1) + (a_2 +
//         a_3); the diagonal the bonus sum_c fmaf(r u, k, acc) in the
//         same order;
//     then A written over r and k's tiles, and y += A v on the tensor
//     cores, warp w rows 16 w..16 w + 15 and the k-steps s < 16 w + 16
//     only. 54.5 KB of shared memory in bfloat16: four CTAs an SM.
// A chunk that is not a multiple of 16 steps is padded at its end with
// steps of logw 0, r, k, v 0: they leave the state and the real rows as
// they are (the cumsum stays cQ, each added product is 0).
// Products: split TF32 on mma.sync (tf32_mma.cuh gives the order of the
// TF32 products): K^, R~, K~ (the quadrant's too), r exp(cm1), A and the
// state are split; v is split only when it is fp32 (bfloat16 is exact in
// TF32). y adds the carry-in's k-steps first, then A v's.
// kernels/ref.py:rwkv6_scan_split_ref emulates this order on the CPU.
// Bytes of this design at the serving shape: rwkv6_states reads k and
// logw once per CTA (two CTAs a head, adjacent in the grid, so the second
// read mostly hits L2), v once, and writes 31 entering states a head and
// the final state; rwkv6_outputs reads r, k, v, logw and the entering
// states and writes y.

#include "tf32_mma.cuh"

namespace {

constexpr int DH = 64, QMAX = 64, SUB = 16;
// rwkv6_states: CB column blocks of 16 a CTA, warp w rows 16 (w % 4) of
// the state and column block w / 4; 320 CTAs at the serving shape, one
// wave at three an SM
constexpr int CB = 2, ST_THREADS = 128 * CB, NB = 4 / CB;
constexpr int OUT_THREADS = 128;
// Row pitches in elements, multiples of 16 bytes for cp.async, chosen so
// each fragment read hits distinct banks: the states tiles are read
// [s][c] with s by t = lane % 4 and c by g = lane / 4 (72); the outputs
// tiles r, k, cum and A are read [t][c] with t by g (bf16 72, fp32 68),
// v and the state [k][n] with k by t (72).
constexpr int LDT = 72, LDVS = 16 * CB + 8, LDV = 72, LDC = 68, LDS = 72, LDA = 68;
template <class T> constexpr int kRowPitch = std::is_same<T, float>::value ? 68 : 72;

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* logw;
  const float* u;      // (H, DH) contiguous
  float* y;            // contiguous (B, H, S, DH)
  float* state;        // contiguous (B, H, DH, DH)
  float* chunk_state;  // scratch, contiguous (B, H, nc, DH, DH): state entering chunk c
  long long rs[3], ks[3], vs[3], ws[3];  // element strides (b, h, s)
  int H, S, Q, nc;
  int vec;             // every row starts on 16 bytes: 16-byte cp.async
};

// One channel's inclusive cumsum in place, rows 0..P-1 in time order; rows
// from Q on are padded steps and add logw 0, whatever the tile holds.
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

__device__ __forceinline__ int padded(int Q) { return (Q + SUB - 1) / SUB * SUB; }

// ---------------------------------------------------------------- states

template <class T>
struct StatesSmem {
  T K[2][QMAX * LDT];
  float W[2][QMAX * LDT];  // logw, then its cumsum in place
  T V[2][QMAX * LDVS];     // this CTA's columns of v
};

template <class T>
__global__ void __launch_bounds__(ST_THREADS, 3) rwkv6_states(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<StatesSmem<T>*>(smem_raw);
  const int bh = blockIdx.x / NB, cg = blockIdx.x % NB, b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int Q = p.Q, P = padded(Q), nc = p.nc;
  const int c0 = 16 * (warp % 4) + g, c1 = c0 + 8;  // this thread's rows of the state
  const int vcol = 16 * (warp / 4);                  // this warp's columns in the V tile
  const int dcol = 16 * CB * cg + vcol;              // ... and in the state
  const T* k = static_cast<const T*>(p.k) + b * p.ks[0] + h * p.ks[1];
  const T* v = static_cast<const T*>(p.v) + b * p.vs[0] + h * p.vs[1] + 16 * CB * cg;
  const float* lw = p.logw + b * p.ws[0] + h * p.ws[1];

  for (int i = 0; i < 2; ++i) {  // padded steps: k and v 0 (cp.async writes rows below Q)
    zero_tile_rows<T, ST_THREADS>(sm.K[i], LDT, Q, P);
    zero_tile_rows<T, ST_THREADS>(sm.V[i], LDVS, Q, P);
  }
  auto stage = [&](int c, int buf) {
    const long long s0 = (long long)c * Q;
    stage_tile<T, ST_THREADS>(sm.K[buf], LDT, k + s0 * p.ks[2], p.ks[2], Q, DH, p.vec);
    stage_tile<float, ST_THREADS>(sm.W[buf], LDT, lw + s0 * p.ws[2], p.ws[2], Q, DH, p.vec);
    stage_tile<T, ST_THREADS>(sm.V[buf], LDVS, v + s0 * p.vs[2], p.vs[2], Q, 16 * CB, p.vec);
  };

  float st[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) st[n][i] = 0.f;
  float* entering = p.chunk_state + (long long)bh * nc * DH * DH;

  stage(0, 0);
  cp_commit();
  for (int c = 0; c < nc; ++c) {
    const int buf = c & 1;
    cp_wait<0>();
    __syncthreads();  // chunk c staged; every warp is done with chunk c - 1
    if (c + 1 < nc) stage(c + 1, buf ^ 1);
    cp_commit();
    float* W = sm.W[buf];
    if (tid < DH) cumsum_column(W + tid, LDT, Q, P);
    __syncthreads();
    const T* K = sm.K[buf];
    const T* V = sm.V[buf];
    const float cq0 = W[(P - 1) * LDT + c0], cq1 = W[(P - 1) * LDT + c1];

    // U = K^T v: rows c, columns d, k = s
    float u[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) u[n][i] = 0.f;
    for (int ks = 0; ks < P / 8; ++ks) {
      const int s0 = 8 * ks + t4, s1 = s0 + 4;
      const FragA fa = frag_a<false>(to_f(K[s0 * LDT + c0]) * expf(cq0 - W[s0 * LDT + c0]),
                                     to_f(K[s0 * LDT + c1]) * expf(cq1 - W[s0 * LDT + c1]),
                                     to_f(K[s1 * LDT + c0]) * expf(cq0 - W[s1 * LDT + c0]),
                                     to_f(K[s1 * LDT + c1]) * expf(cq1 - W[s1 * LDT + c1]));
#pragma unroll
      for (int n = 0; n < 2; ++n)
        mma_step<false, kExact<T>>(u[n], fa, to_f(V[s0 * LDVS + vcol + 8 * n + g]),
                                   to_f(V[s1 * LDVS + vcol + 8 * n + g]));
    }

    if (c > 0) {  // the state entering chunk c, for rwkv6_outputs
      float* out = entering + (long long)c * DH * DH;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int d = dcol + 8 * n + 2 * t4;
        *reinterpret_cast<float2*>(out + c0 * DH + d) = make_float2(st[n][0], st[n][1]);
        *reinterpret_cast<float2*>(out + c1 * DH + d) = make_float2(st[n][2], st[n][3]);
      }
    }
    const float dec0 = expf(cq0), dec1 = expf(cq1);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      st[n][0] = fmaf(st[n][0], dec0, u[n][0]);
      st[n][1] = fmaf(st[n][1], dec0, u[n][1]);
      st[n][2] = fmaf(st[n][2], dec1, u[n][2]);
      st[n][3] = fmaf(st[n][3], dec1, u[n][3]);
    }
  }
  float* out = p.state + (long long)bh * DH * DH;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int d = dcol + 8 * n + 2 * t4;
    *reinterpret_cast<float2*>(out + c0 * DH + d) = make_float2(st[n][0], st[n][1]);
    *reinterpret_cast<float2*>(out + c1 * DH + d) = make_float2(st[n][2], st[n][3]);
  }
}

// --------------------------------------------------------------- outputs

template <class T>
struct OutputsSmem {
  T R[QMAX * kRowPitch<T>];  // R and K, adjacent: A [t][s] (pitch LDA) goes over
  T K[QMAX * kRowPitch<T>];  // both once every warp has read them
  float W[QMAX * LDC];       // logw, then its cumsum in place
  float SV[QMAX * LDS];      // the entering state [c][d]; then v (T, pitch LDV)
  float u[DH];
};

// Block bi of A below the diagonal's 16-step blocks, in the order (1, 0),
// (2, 0), (2, 1), (3, 0), ...: its sub-chunks (i, j), j < i.
__device__ __forceinline__ void lower_block(int bi, int& i, int& j) {
  i = bi < 1 ? 1 : bi < 3 ? 2 : 3;
  j = bi - i * (i - 1) / 2;
}

template <class T>
__global__ void __launch_bounds__(OUT_THREADS, 4) rwkv6_outputs(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<OutputsSmem<T>*>(smem_raw);
  constexpr int LR = kRowPitch<T>;
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int Q = p.Q, P = padded(Q), nsub = P / SUB, nblocks = nsub * (nsub - 1) / 2;
  const long long s0 = (long long)c * Q;
  const T* rg = static_cast<const T*>(p.r) + b * p.rs[0] + h * p.rs[1] + s0 * p.rs[2];
  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + h * p.ks[1] + s0 * p.ks[2];
  const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + h * p.vs[1] + s0 * p.vs[2];
  const float* lw = p.logw + b * p.ws[0] + h * p.ws[1] + s0 * p.ws[2];

  zero_tile_rows<T, OUT_THREADS>(sm.R, LR, Q, P);  // padded steps: r, k 0
  zero_tile_rows<T, OUT_THREADS>(sm.K, LR, Q, P);
  stage_tile<T, OUT_THREADS>(sm.R, LR, rg, p.rs[2], Q, DH, p.vec);
  stage_tile<T, OUT_THREADS>(sm.K, LR, kg, p.ks[2], Q, DH, p.vec);
  stage_tile<float, OUT_THREADS>(sm.W, LDC, lw, p.ws[2], Q, DH, p.vec);
  if (c > 0)
    stage_tile<float, OUT_THREADS>(sm.SV, LDS, p.chunk_state + ((long long)bh * p.nc + c) * DH * DH,
                                   DH, DH, DH, true);
  if (tid < DH) sm.u[tid] = p.u[h * DH + tid];
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  if (tid < DH) cumsum_column(sm.W + tid, LDC, Q, P);
  __syncthreads();

  const float* W = sm.W;
  auto cm1 = [&](int t, int ch) { return t > 0 ? W[(t - 1) * LDC + ch] : 0.f; };
  auto rv = [&](int t, int ch) { return to_f(sm.R[t * LR + ch]); };
  auto kv = [&](int t, int ch) { return to_f(sm.K[t * LR + ch]); };
  const bool active = warp < nsub;
  const int t0 = 16 * warp + g, t1 = t0 + 8;  // this thread's rows of the chunk

  // the carry-in (r exp(cm1)) S_in: rows t, columns d, k = c
  float yv[8][4];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) yv[m][i] = 0.f;
  if (c > 0 && active) {
    const float* S = sm.SV;
#pragma unroll 2
    for (int ks = 0; ks < 8; ++ks) {
      const int a0 = 8 * ks + t4, a1 = a0 + 4;
      const FragA fa = frag_a<false>(rv(t0, a0) * expf(cm1(t0, a0)), rv(t1, a0) * expf(cm1(t1, a0)),
                                     rv(t0, a1) * expf(cm1(t0, a1)), rv(t1, a1) * expf(cm1(t1, a1)));
#pragma unroll
      for (int m = 0; m < 8; ++m)
        mma_step<false, false>(yv[m], fa, S[a0 * LDS + 8 * m + g], S[a1 * LDS + 8 * m + g]);
    }
  }
  __syncthreads();  // every warp is done with S_in: v is staged over it while A is formed
  T* V = reinterpret_cast<T*>(sm.SV);
  zero_tile_rows<T, OUT_THREADS>(V, LDV, Q, P);  // padded steps: v 0
  stage_tile<T, OUT_THREADS>(V, LDV, vg, p.vs[2], Q, DH, p.vec);
  cp_commit();

  // A's blocks below the diagonal's blocks, (i, j) with j < i: warp w
  // takes blocks w and w + 4, in registers until every warp has read R, K
  float low[2][2][4];
#pragma unroll
  for (int sl = 0; sl < 2; ++sl) {
    const int bi = warp + 4 * sl;
    if (bi >= nblocks) continue;
    int i, j;
    lower_block(bi, i, j);
    const int ti0 = 16 * i + g, ti1 = ti0 + 8;
    const float* e = W + (16 * j + 15) * LDC;  // e_j: the cumsum at sub-chunk j's last step
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) low[sl][n][q] = 0.f;
#pragma unroll 2
    for (int ks = 0; ks < 8; ++ks) {
      const int a0 = 8 * ks + t4, a1 = a0 + 4;
      const float e0 = e[a0], e1 = e[a1];
      const FragA fa = frag_a<false>(
          rv(ti0, a0) * expf(cm1(ti0, a0) - e0), rv(ti1, a0) * expf(cm1(ti1, a0) - e0),
          rv(ti0, a1) * expf(cm1(ti0, a1) - e1), rv(ti1, a1) * expf(cm1(ti1, a1) - e1));
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int s = 16 * j + 8 * n + g;
        mma_step<false, false>(low[sl][n], fa, kv(s, a0) * expf(e0 - W[s * LDC + a0]),
                               kv(s, a1) * expf(e1 - W[s * LDC + a1]));
      }
    }
  }

  // A's diagonal block of sub-chunk i = warp. Its lower-left quadrant
  // (steps 8..15 against 0..7) on the tensor cores, recentred at e' = the
  // cumsum at step 7 of the sub-chunk, rows 0..7 of the tile zero; the two
  // 8-step triangles with the exact gate: lane 4 a + p, triangle a / 4,
  // rows a % 4 and 7 - a % 4 of it (7 pairs between them).
  const int i0 = 16 * warp, a = lane / 4, pc = lane % 4;
  const int base = i0 + 8 * (a / 4), ta = base + a % 4, tb = base + 7 - a % 4;
  const int split_q = 7 - a % 4;  // row tb takes pairs q < split_q, row ta the rest
  float cross[4] = {0.f, 0.f, 0.f, 0.f}, tri[7], bon_a = 0.f, bon_b = 0.f;
#pragma unroll
  for (int q = 0; q < 7; ++q) tri[q] = 0.f;
  if (active) {
    const float* e = W + (i0 + 7) * LDC;
#pragma unroll 2
    for (int ks = 0; ks < 8; ++ks) {
      const int a0 = 8 * ks + t4, a1 = a0 + 4, tx = i0 + 8 + g, sx = i0 + g;
      const float e0 = e[a0], e1 = e[a1];
      const FragA fa = frag_a<false>(0.f, rv(tx, a0) * expf(cm1(tx, a0) - e0), 0.f,
                                     rv(tx, a1) * expf(cm1(tx, a1) - e1));
      mma_step<false, false>(cross, fa, kv(sx, a0) * expf(e0 - W[sx * LDC + a0]),
                             kv(sx, a1) * expf(e1 - W[sx * LDC + a1]));
    }
    for (int m = 0; m < DH / 4; ++m) {
      const int ch = 4 * m + pc;
      const float ra = rv(ta, ch), rb = rv(tb, ch), ma = cm1(ta, ch), mb = cm1(tb, ch);
      const float uc = sm.u[ch];
      bon_a = fmaf(ra * uc, kv(ta, ch), bon_a);
      bon_b = fmaf(rb * uc, kv(tb, ch), bon_b);
#pragma unroll
      for (int q = 0; q < 7; ++q) {
        const bool on_b = q < split_q;
        const int s = base + (on_b ? q : q - split_q);
        tri[q] = fmaf((on_b ? rb : ra) * kv(s, ch), expf((on_b ? mb : ma) - W[s * LDC + ch]),
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
  }
  __syncthreads();  // every warp is done with R and K: A goes over them

  float* A = reinterpret_cast<float*>(sm.R);
#pragma unroll
  for (int sl = 0; sl < 2; ++sl) {
    const int bi = warp + 4 * sl;
    if (bi >= nblocks) continue;
    int i, j;
    lower_block(bi, i, j);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int s = 16 * j + 8 * n + 2 * t4;
      *reinterpret_cast<float2*>(A + (16 * i + g) * LDA + s) =
          make_float2(low[sl][n][0], low[sl][n][1]);
      *reinterpret_cast<float2*>(A + (16 * i + g + 8) * LDA + s) =
          make_float2(low[sl][n][2], low[sl][n][3]);
    }
  }
  if (active) {
    for (int e = lane; e < SUB * SUB; e += 32) {  // zeros above the diagonal
      const int tt = e / SUB, ss = e % SUB;
      if (ss > tt) A[(i0 + tt) * LDA + i0 + ss] = 0.f;
    }
    *reinterpret_cast<float2*>(A + (i0 + 8 + g) * LDA + i0 + 2 * t4) =
        make_float2(cross[2], cross[3]);
    if (pc == 0) {
#pragma unroll
      for (int q = 0; q < 7; ++q) {
        const bool on_b = q < split_q;
        A[(on_b ? tb : ta) * LDA + base + (on_b ? q : q - split_q)] = tri[q];
      }
      A[ta * LDA + ta] = bon_a;
      A[tb * LDA + tb] = bon_b;
    }
  }
  cp_wait<0>();
  __syncthreads();  // A formed and v staged
  if (!active) return;

  // y += A v: rows t, columns d, k = s <= this warp's last row
  for (int ks = 0; ks < 2 * warp + 2; ++ks) {
    const int a0 = 8 * ks + t4, a1 = a0 + 4;
    const FragA fa = frag_a<false>(A[t0 * LDA + a0], A[t1 * LDA + a0], A[t0 * LDA + a1],
                                   A[t1 * LDA + a1]);
#pragma unroll
    for (int m = 0; m < 8; ++m)
      mma_step<false, kExact<T>>(yv[m], fa, to_f(V[a0 * LDV + 8 * m + g]),
                                 to_f(V[a1 * LDV + 8 * m + g]));
  }
  float* y = p.y + ((long long)bh * p.S + s0) * DH;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int d = 8 * m + 2 * t4;
    if (t0 < Q) *reinterpret_cast<float2*>(y + t0 * DH + d) = make_float2(yv[m][0], yv[m][1]);
    if (t1 < Q) *reinterpret_cast<float2*>(y + t1 * DH + d) = make_float2(yv[m][2], yv[m][3]);
  }
}

template <class T>
int launch(const Params& p, int B, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int states_smem = (int)sizeof(StatesSmem<T>), outputs_smem = (int)sizeof(OutputsSmem<T>);
  cudaError_t err = cudaFuncSetAttribute(rwkv6_states<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, states_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rwkv6_outputs<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               outputs_smem);
  if (err != cudaSuccess) return (int)err;
  rwkv6_states<T><<<B * p.H * NB, ST_THREADS, states_smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rwkv6_outputs<T><<<dim3(p.nc, B * p.H), OUT_THREADS, outputs_smem, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v: (B, H, S, dh) of one dtype (bf16 != 0: bfloat16, else float32);
// logw: (B, H, S, dh) float32; each with element strides (batch, head,
// seq) and a contiguous last axis. u: contiguous (H, dh) float32. Writes
// y, contiguous (B, H, S, dh) float32, and state, contiguous (B, H, dh,
// dh) float32. chunk_state (B * H * (S / Q) * dh * dh floats) is the
// caller's scratch. dh must be 64, the chunk Q at most 64 and a divisor of
// S. Two launches on `stream`.
extern "C" int rwkv6_scan(const void* r, const void* k, const void* v,
                          const float* logw, const float* u, float* y,
                          float* state, float* chunk_state, int bf16, int B, int H,
                          int S, int dh, int Q, long long rsb, long long rsh, long long rss,
                          long long ksb, long long ksh, long long kss,
                          long long vsb, long long vsh, long long vss,
                          long long wsb, long long wsh, long long wss,
                          void* stream) {
  if (dh != DH || B < 1 || H < 1 || Q < 1 || Q > QMAX || S < Q || S % Q || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long eb = bf16 ? 2 : 4;
  const int vec = aligned16(r, eb, {rsb, rsh, rss}) && aligned16(k, eb, {ksb, ksh, kss}) &&
                  aligned16(v, eb, {vsb, vsh, vss}) && aligned16(logw, 4, {wsb, wsh, wss});
  const Params p{r, k, v, logw, u, y, state, chunk_state, {rsb, rsh, rss}, {ksb, ksh, kss},
                 {vsb, vsh, vss}, {wsb, wsh, wss}, H, S, Q, S / Q, vec};
  return bf16 ? launch<__nv_bfloat16>(p, B, stream) : launch<float>(p, B, stream);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
