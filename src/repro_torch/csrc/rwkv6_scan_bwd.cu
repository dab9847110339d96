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
// at sub-chunk j's last step. Pairs in one sub-chunk take the exact gate,
// exp(cm1[t,c] - cum[s,c]); a pair with t in sub-chunk i above s's j takes
// g = F[t,c] D_{i-1,j}[c] Gt[s,c], with F = exp(cm1 - e_{i-1}), D_{a,j} =
// exp(e_a - e_j) (1 when a = j) and Gt = exp(e_j - cum_s): every exponent
// <= 0, since cum does not increase. A factor that underflows stands for a
// gate below 1e-38. So A's blocks below the diagonal and the gated parts
// of drg and dkg are sums of products of these factors, and only the
// pairs inside a sub-chunk take an exp of their own. A chunk that is not
// a multiple of 16 steps is padded with steps of logw, r, k, v and dy 0.
//
// Bound on an H100 (NVIDIA's data sheet: 3.35 TB/s, 67 TFLOP/s fp32): at
// RWKV6-3B's training shape (4 x 40 heads x 2,048 steps x 64, bf16 r, k,
// v) the function reads r, k, v, logw and dy and writes dr, dk, dv and
// dlogw (about 290 MB, 0.087 ms); chip_smoke.py reckons its operations
// and states which bound binds.
//
// Design: three launches, no atomics and no grid barrier, so two calls
// give the same bits; the wrapper counts the call once.
//   rwkv6_bwd_states, one CTA of 128 threads per (batch, head, 16 columns
//     of dS): the chunks in reverse order, r, logw (its cumsum in place,
//     the forward's adds) and dy's columns staged, r exp(cm1) formed once,
//     dS written to scratch before the chunk's term is added, dS =
//     fmaf(dS, exp(cQ), sum_t (r exp(cm1))_t dy_t) in registers.
//   rwkv6_bwd_chunks, one CTA of 256 threads per (chunk, batch, head), all
//     chunks at once: r, k, v, dy, the cumsum, F, Gt, k exp(cQ - cum), A,
//     dA, S_in and dS as fp32 tiles (200 KB of shared memory); then dv,
//     then dr and dk (r drg and k dkg kept over A's and k exp(cQ - cum)'s
//     tiles), the chunk's share of du, and the reverse cumsum, one thread
//     a channel; each entry by one thread over its sum's terms in a fixed
//     order.
//   rwkv6_bwd_fold: du summed over (batch, chunk) in order.
// Products on fp32 FMA (a simple kernel first; K6's forward runs split
// TF32 on mma.sync). Tiles are fp32 with a pitch of 65 floats.

#include "tf32_mma.cuh"

namespace {

constexpr int DH = 64, QMAX = 64, SUB = 16, NSUB = QMAX / SUB, LD = 65;
constexpr int ST_THREADS = 128, ST_COLS = 16, ST_BLOCKS = DH / ST_COLS;
constexpr int CH_THREADS = 256;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ int padded(int Q) { return (Q + SUB - 1) / SUB * SUB; }

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
};

// One channel's inclusive cumsum in place, rows 0..Q-1 in time order, rows
// Q..P-1 (padded steps) the last value: the forward's adds.
__device__ __forceinline__ void cumsum_column(float* col, int Q, int P) {
  float acc = 0.f;
  for (int t = 0; t < P; ++t) {
    if (t < Q) acc = __fadd_rn(acc, col[t * LD]);
    col[t * LD] = acc;
  }
}

// ------------------------------------------------------- reverse dS pass

struct StatesSmem {
  float Rg[QMAX][LD];  // r, then r exp(cm1)
  float W[QMAX][LD];   // logw, then its cumsum in place
  float dy[QMAX][ST_COLS + 1];
};

template <class T>
__global__ void __launch_bounds__(ST_THREADS) rwkv6_bwd_states(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<StatesSmem*>(smem_raw);
  const int bh = blockIdx.x / ST_BLOCKS, blk = blockIdx.x % ST_BLOCKS;
  const int b = bh / p.H, h = bh % p.H, tid = threadIdx.x, Q = p.Q;
  const int dl = tid % ST_COLS, d = ST_COLS * blk + dl;  // this thread's column of dS
  const T* r = static_cast<const T*>(p.r) + b * p.rs[0] + h * p.rs[1];
  const float* lw = p.logw + b * p.ws[0] + h * p.ws[1];
  const float* dy = p.dy + b * p.ys[0] + h * p.ys[1] + ST_COLS * blk;
  float* ds = p.ds + (long long)bh * p.nc * DH * DH;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = tid / ST_COLS + 8 * j;
    acc[j] = p.dstate ? p.dstate[((long long)bh * DH + c) * DH + d] : 0.f;
  }
  for (int ch = p.nc - 1; ch >= 0; --ch) {
    const long long s0 = (long long)ch * Q;
    __syncthreads();  // every thread is done with chunk ch + 1's tiles
    for (int e = tid; e < Q * DH; e += ST_THREADS) {
      const int t = e / DH, c = e % DH;
      sm.Rg[t][c] = to_f(r[(s0 + t) * p.rs[2] + c]);
      sm.W[t][c] = lw[(s0 + t) * p.ws[2] + c];
    }
    for (int e = tid; e < Q * ST_COLS; e += ST_THREADS)
      sm.dy[e / ST_COLS][e % ST_COLS] = dy[(s0 + e / ST_COLS) * p.ys[2] + e % ST_COLS];
    __syncthreads();
    if (tid < DH) cumsum_column(&sm.W[0][tid], Q, Q);
    __syncthreads();
    for (int e = tid; e < Q * DH; e += ST_THREADS) {
      const int t = e / DH, c = e % DH;
      sm.Rg[t][c] *= expf(t > 0 ? sm.W[t - 1][c] : 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tid / ST_COLS + 8 * j;
      ds[((long long)ch * DH + c) * DH + d] = acc[j];
      float v = 0.f;
      for (int t = 0; t < Q; ++t) v = fmaf(sm.Rg[t][c], sm.dy[t][dl], v);
      acc[j] = fmaf(acc[j], expf(sm.W[Q - 1][c]), v);
    }
  }
}

// ------------------------------------------------------- every chunk

struct ChunkSmem {
  float R[QMAX][LD], K[QMAX][LD], V[QMAX][LD], DY[QMAX][LD];
  float W[QMAX][LD];   // logw, then its cumsum in place
  float F[QMAX][LD];   // exp(cm1 - e_{i-1}), rows of sub-chunks i >= 1
  float Gt[QMAX][LD];  // exp(e_j - cum), j the row's own sub-chunk
  float Kh[QMAX][LD];  // k exp(cQ - cum); then k dkg
  float A[QMAX][LD];   // A, the bonus on its diagonal; then r drg
  float dA[QMAX][LD];  // dA, db on its diagonal
  float Si[DH][LD], So[DH][LD];  // [c][d]
  float D[NSUB - 1][NSUB - 1][DH];  // D[a][j] = exp(e_a - e_j), j < a
  float u[DH], end[DH];
};

template <class T>
__global__ void __launch_bounds__(CH_THREADS) rwkv6_bwd_chunks(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<ChunkSmem*>(smem_raw);
  const int ch = blockIdx.x, bh = blockIdx.y, b = bh / p.H, h = bh % p.H, tid = threadIdx.x;
  const int Q = p.Q, P = padded(Q);
  const long long s0 = (long long)ch * Q;
  const T* rg = static_cast<const T*>(p.r) + b * p.rs[0] + h * p.rs[1] + s0 * p.rs[2];
  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + h * p.ks[1] + s0 * p.ks[2];
  const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + h * p.vs[1] + s0 * p.vs[2];
  const float* lw = p.logw + b * p.ws[0] + h * p.ws[1] + s0 * p.ws[2];
  const float* dy = p.dy + b * p.ys[0] + h * p.ys[1] + s0 * p.ys[2];
  const float* si = p.chunk_state + ((long long)bh * p.nc + ch) * DH * DH;
  const float* so = p.ds + ((long long)bh * p.nc + ch) * DH * DH;
  const float* sout = ch + 1 < p.nc ? si + DH * DH : p.state + (long long)bh * DH * DH;

  for (int e = tid; e < P * DH; e += CH_THREADS) {  // padded steps: 0
    const int t = e / DH, c = e % DH;
    const bool in = t < Q;
    sm.R[t][c] = in ? to_f(rg[t * p.rs[2] + c]) : 0.f;
    sm.K[t][c] = in ? to_f(kg[t * p.ks[2] + c]) : 0.f;
    sm.V[t][c] = in ? to_f(vg[t * p.vs[2] + c]) : 0.f;
    sm.DY[t][c] = in ? dy[t * p.ys[2] + c] : 0.f;
    sm.W[t][c] = in ? lw[t * p.ws[2] + c] : 0.f;
  }
  for (int e = tid; e < DH * DH; e += CH_THREADS) {
    sm.Si[e / DH][e % DH] = ch > 0 ? si[e] : 0.f;
    sm.So[e / DH][e % DH] = so[e];
  }
  if (tid < DH) sm.u[tid] = p.u[h * DH + tid];
  __syncthreads();
  if (tid < DH) cumsum_column(&sm.W[0][tid], Q, P);
  __syncthreads();

  auto cm1 = [&](int t, int c) { return t > 0 ? sm.W[t - 1][c] : 0.f; };
  auto ev = [&](int j, int c) { return sm.W[SUB * j + SUB - 1][c]; };  // e_j
  const float* cq = sm.W[P - 1];

  // the factors, dA and db
  for (int e = tid; e < P * DH; e += CH_THREADS) {
    const int t = e / DH, c = e % DH, i = t / SUB;
    sm.F[t][c] = i > 0 ? expf(cm1(t, c) - ev(i - 1, c)) : 0.f;
    sm.Gt[t][c] = expf(ev(i, c) - sm.W[t][c]);
    sm.Kh[t][c] = sm.K[t][c] * expf(cq[c] - sm.W[t][c]);
  }
  for (int e = tid; e < (NSUB - 1) * (NSUB - 1) * DH; e += CH_THREADS) {
    const int a = e / ((NSUB - 1) * DH), j = e / DH % (NSUB - 1), c = e % DH;
    if (j < a && SUB * (a + 1) <= P) sm.D[a][j][c] = expf(ev(a, c) - ev(j, c));
  }
  for (int e = tid; e < P * P; e += CH_THREADS) {
    const int t = e / P, s = e % P;
    float acc = 0.f;
    if (s <= t)
      for (int d = 0; d < DH; ++d) acc = fmaf(sm.DY[t][d], sm.V[s][d], acc);
    sm.dA[t][s] = acc;
  }
  __syncthreads();

  // the gate of a pair s < t across sub-chunks, for channel c:
  // F[t] D[i-1][j] Gt[s] (D is 1 when j = i - 1)
  auto dfac = [&](int i, int j, int c) { return j == i - 1 ? 1.f : sm.D[i - 1][j][c]; };

  // A (s < t) and the bonus on its diagonal
  for (int e = tid; e < P * P; e += CH_THREADS) {
    const int t = e / P, s = e % P, i = t / SUB, j = s / SUB;
    float acc = 0.f;
    if (s == t) {
      for (int c = 0; c < DH; ++c) acc = fmaf(sm.R[t][c] * sm.u[c], sm.K[t][c], acc);
    } else if (s < t && i == j) {
      for (int c = 0; c < DH; ++c)
        acc = fmaf(sm.R[t][c] * sm.K[s][c], expf(cm1(t, c) - sm.W[s][c]), acc);
    } else if (s < t) {
      for (int c = 0; c < DH; ++c)
        acc = fmaf(sm.R[t][c] * sm.F[t][c] * dfac(i, j, c), sm.K[s][c] * sm.Gt[s][c], acc);
    }
    sm.A[t][s] = acc;
  }
  __syncthreads();

  // dv, in v's type
  T* dv = static_cast<T*>(p.dv) + ((long long)bh * p.S + s0) * DH;
  for (int e = tid; e < Q * DH; e += CH_THREADS) {
    const int s = e / DH, d = e % DH;
    float acc = 0.f, st = 0.f;
    for (int t = s; t < P; ++t) acc = fmaf(sm.A[t][s], sm.DY[t][d], acc);
    for (int c = 0; c < DH; ++c) st = fmaf(sm.Kh[s][c], sm.So[c][d], st);
    store(dv + (long long)s * DH + d, acc + st);
  }
  __syncthreads();  // A and Kh are free: r drg and k dkg go over them

  T* dr = static_cast<T*>(p.dr) + ((long long)bh * p.S + s0) * DH;
  T* dk = static_cast<T*>(p.dk) + ((long long)bh * p.S + s0) * DH;
  for (int e = tid; e < P * DH; e += CH_THREADS) {
    const int t = e / DH, c = e % DH, i = t / SUB;
    if (t >= Q) {  // padded steps: r and k 0
      sm.A[t][c] = 0.f;
      sm.Kh[t][c] = 0.f;
      continue;
    }
    const float m1 = cm1(t, c), wt = sm.W[t][c];
    // drg: the carry-in, the sub-chunks below, the pairs inside t's own
    float carry = 0.f;
    for (int d = 0; d < DH; ++d) carry = fmaf(sm.Si[c][d], sm.DY[t][d], carry);
    float below = 0.f;
    for (int j = 0; j < i; ++j) {
      float part = 0.f;
      for (int s = SUB * j; s < SUB * j + SUB; ++s)
        part = fmaf(sm.dA[t][s], sm.K[s][c] * sm.Gt[s][c], part);
      below = fmaf(dfac(i, j, c), part, below);
    }
    float own = 0.f;
    for (int s = SUB * i; s < t; ++s)
      own = fmaf(sm.dA[t][s] * sm.K[s][c], expf(m1 - sm.W[s][c]), own);
    const float drg = fmaf(expf(m1), carry, fmaf(sm.F[t][c], below, own));
    // dkg (row t as s): the update, the sub-chunks above, the pairs inside
    float upd = 0.f;
    for (int d = 0; d < DH; ++d) upd = fmaf(sm.So[c][d], sm.V[t][d], upd);
    float above = 0.f;
    for (int a = i + 1; a < P / SUB; ++a) {
      float part = 0.f;
      for (int s = SUB * a; s < SUB * a + SUB; ++s)
        part = fmaf(sm.dA[s][t], sm.R[s][c] * sm.F[s][c], part);
      above = fmaf(dfac(a, i, c), part, above);
    }
    float own_k = 0.f;
    for (int s = t + 1; s < SUB * i + SUB; ++s)
      own_k = fmaf(sm.dA[s][t] * sm.R[s][c], expf(cm1(s, c) - wt), own_k);
    const float dkg = fmaf(expf(cq[c] - wt), upd, fmaf(sm.Gt[t][c], above, own_k));
    const float db = sm.dA[t][t];
    store(dr + (long long)t * DH + c, fmaf(db * sm.u[c], sm.K[t][c], drg));
    store(dk + (long long)t * DH + c, fmaf(db * sm.u[c], sm.R[t][c], dkg));
    sm.A[t][c] = sm.R[t][c] * drg;
    sm.Kh[t][c] = sm.K[t][c] * dkg;
  }
  if (tid < DH) {  // the chunk's share of du, and sum_d dS S_out
    const int c = tid;
    float du = 0.f, end = 0.f;
    for (int t = 0; t < Q; ++t) du = fmaf(sm.dA[t][t] * sm.R[t][c], sm.K[t][c], du);
    for (int d = 0; d < DH; ++d) end = fmaf(sm.So[c][d], sout[c * DH + d], end);
    p.du_part[((long long)bh * p.nc + ch) * DH + c] = du;
    sm.end[c] = end;
  }
  __syncthreads();

  if (tid < DH) {  // dcum and its reverse cumsum, one thread a channel
    const int c = tid;
    float* dlogw = p.dlogw + ((long long)bh * p.S + s0) * DH + c;
    float acc = 0.f;
    for (int j = Q - 1; j >= 0; --j) {
      float dcum = (j + 1 < Q ? sm.A[j + 1][c] : 0.f) - sm.Kh[j][c];
      if (j == Q - 1) dcum += sm.end[c];
      acc += dcum;
      dlogw[(long long)j * DH] = acc;
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
  const int st_smem = (int)sizeof(StatesSmem), ch_smem = (int)sizeof(ChunkSmem);
  cudaError_t err = cudaFuncSetAttribute(rwkv6_bwd_states<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, st_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rwkv6_bwd_chunks<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ch_smem);
  if (err != cudaSuccess) return (int)err;
  rwkv6_bwd_states<T><<<p.B * p.H * ST_BLOCKS, ST_THREADS, st_smem, s>>>(p);
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
  const Params p{r,  k,  v,  logw, u,  chunk_state, state, dy, dstate, ds, du_part, dr, dk, dv,
                 dlogw, du, {rsb, rsh, rss}, {ksb, ksh, kss}, {vsb, vsh, vss}, {wsb, wsh, wss},
                 {ysb, ysh, yss}, B, H, S, Q, S / Q};
  return bf16 ? launch<__nv_bfloat16>(p, stream) : launch<float>(p, stream);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
