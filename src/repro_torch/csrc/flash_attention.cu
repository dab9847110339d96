// Flash-attention forward (K4): causal or non-causal online-softmax
// attention over (B, H, Sq, dh) queries and (B, KV, Skv, dh) keys/values.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:flash_attention
// (and the GQA expansion of repro/kernels/ops.py:attention). The function is
// the Pallas kernel's, step for step:
//   s = (q . k^T in fp32) * scale, masked with -1e30 (key > query, or past
//       the end of the keys);
//   m, l, acc in fp32; per kv tile m' = max(m, rowmax s), p = exp(s - m'),
//   corr = exp(m - m'), l = l corr + rowsum p (the unrounded p),
//   acc = acc corr + (p rounded to v's type) . v in fp32;
//   out = acc / max(l, 1e-30), rounded to q's type.
// Causal kv tiles wholly above the diagonal are skipped: key 0 is always
// visible, so m is finite after the first tile, and a masked tile adds
// exp(-1e30 - m) = 0 with corr = 1, which changes nothing. GQA: query head
// h reads kv head h / (H / KV) in place, without the reference's repeat.
//
// Bound on an H100: operations. At the serving shape (4 x 32 heads x 2,048
// x 128, 8 kv heads, causal) the two products are 1.37e11 flop, 0.14 ms at
// 989 TFLOP/s of bf16 tensor cores, against 0.05 ms of bytes (q, k, v read
// once, out written once). Design: the simple one. One CTA per (b.h, 64-row
// q tile), the heaviest causal tiles launched first; the q tile, then each
// 64-row K tile and V tile are staged through shared memory as fp32; 256
// threads, each owning 4 query rows x 4 keys of a score tile (row max and
// sum by shuffles over the 16 threads of a row group) and 4 rows x dh/16
// output columns, with m, l and acc in registers; fp32 FMA for both
// products, each sum in ascending order. Compiled for dh 16, 64, 112
// (Zamba2-7B's shared attention: NC = 7 accumulator columns a thread) and
// 128. The tensor cores (mma.sync or wgmma), TMA and a pipelined K/V ring
// are the way to the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  void* o;              // contiguous (B, H, Sq, dh)
  Strides qs, ks, vs;
  int H, group;         // query heads, query heads per kv head
  int Sq, Skv, causal;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <class T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype
}

// Rows [row0, row0 + 64) of a (rows, DH) slice into shared memory as fp32,
// row stride LD; rows at or past n_rows load as zero. 16-byte loads.
template <class T, int DH, int LD>
__device__ __forceinline__ void stage(float* dst, const T* base,
                                      long long row_stride, int row0,
                                      int n_rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = DH / VEC;
  for (int e = threadIdx.x; e < 64 * PER_ROW; e += THREADS) {
    const int r = e / PER_ROW, cv = (e % PER_ROW) * VEC;
    float vals[VEC];
    if (row0 + r < n_rows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          base + (long long)(row0 + r) * row_stride + cv);
      const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < VEC; ++u) vals[u] = to_f(t[u]);
    } else {
#pragma unroll
      for (int u = 0; u < VEC; ++u) vals[u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < VEC; u += 4)
      *reinterpret_cast<float4*>(dst + r * LD + cv + u) =
          make_float4(vals[u], vals[u + 1], vals[u + 2], vals[u + 3]);
  }
}

// Output column of a thread's jj-th accumulator (NC = DH / 16 of them):
// four neighbouring columns per 64 when NC is a multiple of 4 (dh 64 and
// 128: float4 reads of a V row), else one per 16 (dh 16 and 112).
template <int NC>
__device__ __forceinline__ int out_col(int c, int jj) {
  if constexpr (NC % 4 == 0) return (jj / 4) * 64 + 4 * c + (jj % 4);
  else return c + 16 * jj;
}

template <class T, int DH>
__global__ void __launch_bounds__(THREADS, 2) flash_fwd(Params p) {
  constexpr int LD = DH + 4;  // padded rows (116 floats at dh 112): conflict-
                              // free, 16-byte aligned float4 reads
  constexpr int LP = BK + 4;
  constexpr int NC = DH / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // BQ x LD
  float* KVs = Qs + BQ * LD;   // BK x LD: the K tile, then the V tile
  float* Ps = KVs + BK * LD;   // BQ x LP: p rounded to v's type

  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H, kvh = h / p.group;
  const T* q = static_cast<const T*>(p.q) + b * p.qs.b + h * p.qs.h;
  const T* k = static_cast<const T*>(p.k) + b * p.ks.b + kvh * p.ks.h;
  const T* v = static_cast<const T*>(p.v) + b * p.vs.b + kvh * p.vs.h;
  const int q0 = qt * BQ;
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;  // rows 4r.., keys c+16j

  stage<T, DH, LD>(Qs, q, p.qs.s, q0, p.Sq);
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
    stage<T, DH, LD>(KVs, k, p.ks.s, k0, p.Skv);
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
    stage<T, DH, LD>(KVs, v, p.vs.s, k0, p.Skv);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(4 * r + i) * LP + c + 16 * j] = to_f(from_f<T>(s[i][j]));
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
        const float* vrow = KVs + (kk + u) * LD;
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

  T* o = static_cast<T*>(p.o) + ((long long)b * p.H + h) * p.Sq * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * r + i;
    if (row >= p.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NC; ++jj)
      o[(long long)row * DH + out_col<NC>(c, jj)] = from_f<T>(acc[i][jj] / den);
  }
}

template <class T, int DH>
int launch(const Params& p, int B, void* stream) {
  constexpr size_t smem = sizeof(float) * (2 * BQ * (DH + 4) + BQ * (BK + 4));
  auto kernel = flash_fwd<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, B * p.H);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <class T>
int dispatch(const Params& p, int B, int dh, void* stream) {
  switch (dh) {
    case 16: return launch<T, 16>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    case 112: return launch<T, 112>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, H, Sq, dh), k and v: (B, KV, Skv, dh), each with element strides
// (batch, head, seq) and a contiguous last axis, 16-byte aligned rows; out:
// contiguous (B, H, Sq, dh). bf16 != 0: bfloat16 tensors, else float32.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int bf16, int B, int H, int KV,
                               int Sq, int Skv, int dh, long long qsb,
                               long long qsh, long long qss, long long ksb,
                               long long ksh, long long kss, long long vsb,
                               long long vsh, long long vss, int causal,
                               float scale, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV || Sq < 1 || Skv < 1 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, out, {qsb, qsh, qss}, {ksb, ksh, kss},
                 {vsb, vsh, vss}, H, H / KV, Sq, Skv, causal, scale};
  return bf16 ? dispatch<__nv_bfloat16>(p, B, dh, stream)
              : dispatch<float>(p, B, dh, stream);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
