// Mamba2 SSD chunked scan (K5): a scalar decay per head, a (dh, N) fp32
// state carried across the chunks of each (batch, head).
//
// Replaces the Pallas kernel repro/kernels/ssm_scan.py:ssm_scan (without
// its D * x skip, which the wrapper adds, as the Pallas wrapper does). Per
// chunk of Q steps, all in fp32:
//   cum_t   = inclusive cumsum of dt * A over the chunk, in time order;
//   G[t,s]  = (C_t . B_s) exp(cum_t - cum_s) dt_s, s <= t only;
//   y_t     = sum_{s<=t} G[t,s] x_s + exp(cum_t) (C_t . state^T);
//   state' = exp(cum_Q) state + sum_s (exp(cum_Q - cum_s) dt_s x_s) B_s^T.
// B and C are shared by all heads and x is a strided view of the conv
// output: the kernel reads them in place by their strides (the Pallas
// wrapper broadcasts and transposes copies). It also writes the final
// state, which the model's prefill stores in the decode cache.
//
// Bound on an H100: operations. At the serving shape (Zamba2-7B: 4 x 112
// heads x 2,048 steps, dh = N = 64) the function needs 1.6e10 fp32 flop
// at the least (the chunked form at its cheapest chunk, 8 steps, C B^T
// once for all heads): 0.24 ms at 67 TFLOP/s, against 0.11 ms of bytes
// (bf16 x, B, C, fp32 dt read once; fp32 y and state written once). This
// kernel, chunks of 64 and C B^T once a head, does 2.3e10. Design: the
// simple one. One CTA of 256 threads per (batch, head) walks its chunks in
// order with the state in shared memory (rows padded to 65 floats); the
// 2,080 (t, s) pairs of the triangle are spread evenly over the threads;
// the output and the state update are one column of 16 rows a thread.
// fp32 FMA throughout, each sum in ascending order; no tensor cores.
// ~84 KB of shared memory, two CTAs an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int DH = 64, N = 64, QMAX = 64, THREADS = 256, LD = 65;
constexpr size_t SMEM = sizeof(float) * (QMAX * DH + 3 * QMAX * LD + DH * LD + 3 * QMAX);

struct Params {
  const void* x;
  const float* dt;
  const float* A;      // (H,)
  const void* B;
  const void* C;
  float* y;            // contiguous (Bt, S, H, DH)
  float* state;        // contiguous (Bt, H, DH, N)
  long long xs[3];     // element strides (b, s, h); dh contiguous
  long long ds[3];     // dt's (b, s, h)
  long long bs[2], cs[2];  // B's and C's (b, s); N contiguous
  int H, S, Q;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <class T>
__global__ void __launch_bounds__(THREADS, 2) ssm_fwd(Params p) {
  extern __shared__ float sm[];
  float* X = sm;                // Q x DH
  float* Bm = X + QMAX * DH;    // Q x LD
  float* Cm = Bm + QMAX * LD;   // Q x LD
  float* G = Cm + QMAX * LD;    // Q x LD: G[t][s], s <= t
  float* St = G + QMAX * LD;    // DH x LD: state [d][n]
  float* cum = St + DH * LD;    // Q
  float* dtv = cum + QMAX;      // Q
  float* ws = dtv + QMAX;       // Q: exp(cum_Q - cum_s) dt_s

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H, tid = threadIdx.x;
  const int Q = p.Q;
  const float a = p.A[h];
  const T* x = static_cast<const T*>(p.x) + b * p.xs[0] + h * p.xs[2];
  const T* Bg = static_cast<const T*>(p.B) + b * p.bs[0];
  const T* Cg = static_cast<const T*>(p.C) + b * p.cs[0];
  const float* dt = p.dt + b * p.ds[0] + h * p.ds[2];

  for (int e = tid; e < DH * LD; e += THREADS) St[e] = 0.f;
  const int n_tri = Q * (Q + 1) / 2;

  for (int s0 = 0; s0 < p.S; s0 += Q) {
    __syncthreads();  // the previous chunk is done with every buffer
    for (int e = tid; e < Q * DH; e += THREADS) {
      const int t = e / DH, c = e % DH;
      const long long row = s0 + t;
      X[t * DH + c] = to_f(x[row * p.xs[1] + c]);
      Bm[t * LD + c] = to_f(Bg[row * p.bs[1] + c]);
      Cm[t * LD + c] = to_f(Cg[row * p.cs[1] + c]);
    }
    if (tid < Q) dtv[tid] = dt[(long long)(s0 + tid) * p.ds[1]];
    __syncthreads();
    if (tid == 0) {  // inclusive cumsum of dt * A, in time order
      float acc = 0.f;
      for (int t = 0; t < Q; ++t) {
        acc += dtv[t] * a;
        cum[t] = acc;
      }
    }
    __syncthreads();
    if (tid < Q) ws[tid] = expf(cum[Q - 1] - cum[tid]) * dtv[tid];
    // G over the lower triangle with its diagonal, spread evenly
    for (int e = tid; e < n_tri; e += THREADS) {
      int t = (int)((sqrtf(8.f * e + 1.f) - 1.f) * 0.5f);
      while (t * (t + 1) / 2 > e) --t;
      while ((t + 1) * (t + 2) / 2 <= e) ++t;
      const int s = e - t * (t + 1) / 2;
      const float* ct = Cm + t * LD;
      const float* bs_ = Bm + s * LD;
      float acc = 0.f;
#pragma unroll 8
      for (int n = 0; n < N; ++n) acc = fmaf(ct[n], bs_[n], acc);
      G[t * LD + s] = acc * expf(cum[t] - cum[s]) * dtv[s];
    }
    __syncthreads();
    {  // y: one column d, rows t0, t0 + 4, ...
      const int d = tid % DH;
      float* y = p.y + ((long long)b * p.S * p.H + h) * DH + d;
      for (int t = tid / DH; t < Q; t += THREADS / DH) {
        float acc = 0.f;
        for (int s = 0; s <= t; ++s) acc = fmaf(G[t * LD + s], X[s * DH + d], acc);
        float carry = 0.f;
#pragma unroll 8
        for (int n = 0; n < N; ++n) carry = fmaf(Cm[t * LD + n], St[d * LD + n], carry);
        y[(long long)(s0 + t) * p.H * DH] = fmaf(expf(cum[t]), carry, acc);
      }
    }
    __syncthreads();
    {  // state' = exp(cum_Q) state + (x * ws)^T B: one column n, rows d
      const int n = tid % N;
      const float decay = expf(cum[Q - 1]);
      for (int d = tid / N; d < DH; d += THREADS / N) {
        float acc = 0.f;
        for (int s = 0; s < Q; ++s) acc = fmaf(X[s * DH + d] * ws[s], Bm[s * LD + n], acc);
        St[d * LD + n] = fmaf(St[d * LD + n], decay, acc);
      }
    }
  }
  __syncthreads();
  float* out = p.state + (long long)bh * DH * N;
  for (int e = tid; e < DH * N; e += THREADS) out[e] = St[(e / N) * LD + e % N];
}

template <class T>
int launch(const Params& p, int B, void* stream) {
  auto kernel = ssm_fwd<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * p.H, THREADS, SMEM, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (Bt, S, H, dh) with element strides (batch, seq, head) and a
// contiguous last axis; dt: (Bt, S, H) float32, strides (batch, seq,
// head); A: contiguous (H,) float32; B and C: (Bt, S, N) of x's dtype
// (bf16 != 0: bfloat16, else float32), strides (batch, seq), N contiguous.
// Writes y, contiguous (Bt, S, H, dh) float32, without D * x, and state,
// contiguous (Bt, H, dh, N) float32. dh and N must be 64, the chunk Q at
// most 64 and a divisor of S.
extern "C" int ssm_scan(const void* x, const float* dt, const float* A,
                        const void* B, const void* C, float* y, float* state,
                        int bf16, int Bt, int H, int S, int dh, int n, int Q,
                        long long xsb, long long xss, long long xsh,
                        long long dsb, long long dss, long long dsh,
                        long long bsb, long long bss, long long csb,
                        long long css, void* stream) {
  if (dh != DH || n != N || Bt < 1 || H < 1 || Q < 1 || Q > QMAX || S < Q ||
      S % Q)
    return (int)cudaErrorInvalidValue;
  const Params p{x, dt, A, B, C, y, state, {xsb, xss, xsh}, {dsb, dss, dsh},
                 {bsb, bss}, {csb, css}, H, S, Q};
  return bf16 ? launch<__nv_bfloat16>(p, Bt, stream) : launch<float>(p, Bt, stream);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
