// RWKV6 WKV chunked scan (K6): data-dependent per-channel decay, a
// (dh, dh) fp32 state carried across the chunks of each (batch, head).
//
// Replaces the Pallas kernel repro/kernels/rwkv6_scan.py:rwkv6_scan. The
// function is the Pallas kernel's code (its exact form, not the "factored"
// form its docstring names), per chunk of Q steps, all in fp32:
//   cum      inclusive cumsum of logw over the chunk, in time order;
//   cum_{t-1} the exclusive one (cum_{-1} = 0), as the model's
//            _wkv_chunked takes it;
//   A[t,s] = sum_c r[t,c] k[s,c] exp(cum_{t-1,c} - cum_{s,c}), s < t only
//            (every exponent <= 0: no overflow under fast decay);
//   y_t    = sum_{s<t} A[t,s] v_s + (sum_c r u k)[t] v_t
//            + (r_t * exp(cum_{t-1})) . state;
//   state' = diag(exp(cum_Q)) state + (k * exp(cum_Q - cum))^T v.
// It also writes the final state, which the model's prefill stores in the
// decode cache (the Pallas kernel keeps it in scratch and drops it).
//
// Bound on an H100: operations. At the serving shape (RWKV6-3B: 4 x 40
// heads x 2,048 steps x 64) the function needs 6.0e9 fp32 flop at the
// least (the chunked form at its cheapest chunk, 4 steps, where the
// state's carry-in and update, 4 dh^2 a step, dominate): 0.090 ms at
// 67 TFLOP/s, against 0.088 ms of bytes (bf16 r, k, v and fp32 logw read
// once, fp32 y and state written once). This kernel's exact gate over
// chunks of 64 alone takes 160 x 32 x 2,016 x 64 = 6.6e8 expf, 0.16 ms at
// the 16 results a clock of each SM's special-function units.
// Design: the simple one. One CTA of 256 threads per (batch, head) walks
// its chunks in order with the state in shared memory; a chunk's r, k, v
// and cum are staged as fp32 rows padded to 65 floats (conflict-free
// column reads); the 2,016 (t, s) pairs of the triangle are spread evenly
// over the threads, each summing its 64 channels with one expf each; the
// output and the state update are one column of 16 rows a thread. fp32
// FMA throughout, each sum in ascending order. ~100 KB of shared memory,
// two CTAs an SM, so the 160 CTAs of a serving prefill run in one wave.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int DH = 64, QMAX = 64, THREADS = 256, LD = DH + 1;
constexpr size_t SMEM = sizeof(float) * (4 * QMAX * LD + QMAX * DH + DH * DH + QMAX + DH);

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* logw;
  const float* u;      // (H, DH) contiguous
  float* y;            // contiguous (B, H, S, DH)
  float* state;        // contiguous (B, H, DH, DH)
  long long rs[3], ks[3], vs[3], ws[3];  // element strides (b, h, s)
  int H, S, Q;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <class T>
__global__ void __launch_bounds__(THREADS, 2) rwkv6_fwd(Params p) {
  extern __shared__ float sm[];
  float* R = sm;                // Q x LD: r, then r * exp(cum_{t-1})
  float* K = R + QMAX * LD;     // Q x LD: k, then k * exp(cum_Q - cum)
  float* CUM = K + QMAX * LD;   // Q x LD: logw, then its inclusive cumsum
  float* Am = CUM + QMAX * LD;  // Q x LD: A[t][s], s < t
  float* V = Am + QMAX * LD;    // Q x DH
  float* St = V + QMAX * DH;    // DH x DH state [c][d]
  float* diag = St + DH * DH;   // Q
  float* U = diag + QMAX;       // DH

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H, tid = threadIdx.x;
  const int Q = p.Q;
  const T* r = static_cast<const T*>(p.r) + b * p.rs[0] + h * p.rs[1];
  const T* k = static_cast<const T*>(p.k) + b * p.ks[0] + h * p.ks[1];
  const T* v = static_cast<const T*>(p.v) + b * p.vs[0] + h * p.vs[1];
  const float* lw = p.logw + b * p.ws[0] + h * p.ws[1];
  float* y = p.y + (long long)bh * p.S * DH;

  for (int e = tid; e < DH * DH; e += THREADS) St[e] = 0.f;
  for (int c = tid; c < DH; c += THREADS) U[c] = p.u[h * DH + c];
  const int n_tri = Q * (Q - 1) / 2;

  for (int s0 = 0; s0 < p.S; s0 += Q) {
    __syncthreads();  // the previous chunk is done with every buffer
    for (int e = tid; e < Q * DH; e += THREADS) {
      const int t = e / DH, c = e % DH;
      const long long row = s0 + t;
      R[t * LD + c] = to_f(r[row * p.rs[2] + c]);
      K[t * LD + c] = to_f(k[row * p.ks[2] + c]);
      V[t * DH + c] = to_f(v[row * p.vs[2] + c]);
      CUM[t * LD + c] = lw[row * p.ws[2] + c];
    }
    __syncthreads();
    if (tid < DH) {  // inclusive cumsum, in time order
      float acc = 0.f;
      for (int t = 0; t < Q; ++t) {
        acc += CUM[t * LD + tid];
        CUM[t * LD + tid] = acc;
      }
    }
    __syncthreads();
    // A over the strict lower triangle, pairs spread evenly over threads
    for (int e = tid; e < n_tri; e += THREADS) {
      int t = (int)((1.f + sqrtf(8.f * e + 1.f)) * 0.5f);
      while (t * (t - 1) / 2 > e) --t;
      while ((t + 1) * t / 2 <= e) ++t;
      const int s = e - t * (t - 1) / 2;
      const float* rt = R + t * LD;
      const float* ct = CUM + (t - 1) * LD;
      const float* ks_ = K + s * LD;
      const float* cs = CUM + s * LD;
      float acc = 0.f;
#pragma unroll 8
      for (int c = 0; c < DH; ++c)
        acc = fmaf(rt[c] * ks_[c], expf(ct[c] - cs[c]), acc);
      Am[t * LD + s] = acc;
    }
    if (tid < Q) {  // the diagonal bonus sum_c r u k
      float acc = 0.f;
      for (int c = 0; c < DH; ++c)
        acc = fmaf(R[tid * LD + c] * U[c], K[tid * LD + c], acc);
      diag[tid] = acc;
    }
    __syncthreads();
    // r * exp(cum_{t-1}) and k * exp(cum_Q - cum), in place
    for (int e = tid; e < Q * DH; e += THREADS) {
      const int t = e / DH, c = e % DH;
      if (t > 0) R[t * LD + c] *= expf(CUM[(t - 1) * LD + c]);
      K[t * LD + c] *= expf(CUM[(Q - 1) * LD + c] - CUM[t * LD + c]);
    }
    __syncthreads();
    {  // y: one column d, rows t0, t0 + 4, ...
      const int d = tid % DH;
      for (int t = tid / DH; t < Q; t += THREADS / DH) {
        float acc = 0.f;
        for (int s = 0; s < t; ++s) acc = fmaf(Am[t * LD + s], V[s * DH + d], acc);
        acc = fmaf(diag[t], V[t * DH + d], acc);
        float carry = 0.f;
#pragma unroll 8
        for (int c = 0; c < DH; ++c) carry = fmaf(R[t * LD + c], St[c * DH + d], carry);
        y[(long long)(s0 + t) * DH + d] = acc + carry;
      }
    }
    __syncthreads();
    {  // state' = diag(exp(cum_Q)) state + kw^T v: one column d, rows c
      const int d = tid % DH;
      for (int c = tid / DH; c < DH; c += THREADS / DH) {
        float acc = 0.f;
        for (int s = 0; s < Q; ++s) acc = fmaf(K[s * LD + c], V[s * DH + d], acc);
        St[c * DH + d] = fmaf(St[c * DH + d], expf(CUM[(Q - 1) * LD + c]), acc);
      }
    }
  }
  __syncthreads();
  float* out = p.state + (long long)bh * DH * DH;
  for (int e = tid; e < DH * DH; e += THREADS) out[e] = St[e];
}

template <class T>
int launch(const Params& p, int B, void* stream) {
  auto kernel = rwkv6_fwd<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * p.H, THREADS, SMEM, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v: (B, H, S, dh) of one dtype (bf16 != 0: bfloat16, else float32);
// logw: (B, H, S, dh) float32; each with element strides (batch, head,
// seq) and a contiguous last axis. u: contiguous (H, dh) float32. Writes
// y, contiguous (B, H, S, dh) float32, and state, contiguous (B, H, dh,
// dh) float32. dh must be 64, the chunk Q at most 64 and a divisor of S.
extern "C" int rwkv6_scan(const void* r, const void* k, const void* v,
                          const float* logw, const float* u, float* y,
                          float* state, int bf16, int B, int H, int S, int dh,
                          int Q, long long rsb, long long rsh, long long rss,
                          long long ksb, long long ksh, long long kss,
                          long long vsb, long long vsh, long long vss,
                          long long wsb, long long wsh, long long wss,
                          void* stream) {
  if (dh != DH || B < 1 || H < 1 || Q < 1 || Q > QMAX || S < Q || S % Q)
    return (int)cudaErrorInvalidValue;
  const Params p{r, k, v, logw, u, y, state, {rsb, rsh, rss}, {ksb, ksh, kss},
                 {vsb, vsh, vss}, {wsb, wsh, wss}, H, S, Q};
  return bf16 ? launch<__nv_bfloat16>(p, B, stream) : launch<float>(p, B, stream);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
