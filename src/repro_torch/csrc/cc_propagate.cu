// One DLS-scheduled connected-components propagation step.
//
// Replaces the Pallas kernel repro/kernels/cc_propagate.py:cc_propagate.
//   u[i] = max(max_{j: G[i,j] > 0} c[j], c[i])
// over a dense float32 {0, 1} adjacency G (n x n, row-major).
//
// Bound on an H100: bytes. The step reads G once (4 n^2 bytes, 1 GiB at
// n = 16,384, 0.32 ms at 3.35 TB/s) and does about 2 n^2 compare/max
// operations. Design: the whole card streams G. A grid of as many CTAs as
// fit on every SM at once takes work items of (slot, group of 8 rows of
// the slot's row tile), item i = slot * groups + group, CTA b items b,
// b + grid, ...: so row tiles are begun in the schedule's slot order, the
// order the DLS technique chose. A padding slot (t < 0 or t >= n / tile_r)
// does nothing. Each warp owns one row of its item: lanes on neighbouring
// 16-byte vectors, 8 streaming loads of G in flight a lane before the
// compares, a running max that starts from the row's own label c[row]
// (c is 64 KB at n = 16,384 and stays in L1). The row's columns are read
// in one sweep, not tile by tile: tile_c only chooses how the plain
// version groups them. Max is exact, so the result is bitwise the plain
// version's whatever the order. Masked entries contribute 0: labels are
// >= 1, so a 0 never wins.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32, UNROLL = 8;

__device__ __forceinline__ float masked_max(float m, float4 g, float4 c) {
  m = fmaxf(m, g.x > 0.f ? c.x : 0.f);
  m = fmaxf(m, g.y > 0.f ? c.y : 0.f);
  m = fmaxf(m, g.z > 0.f ? c.z : 0.f);
  return fmaxf(m, g.w > 0.f ? c.w : 0.f);
}

__global__ void __launch_bounds__(THREADS)
cc_propagate_kernel(const float* __restrict__ G, const float* __restrict__ c,
                    const int* __restrict__ schedule, float* __restrict__ out,
                    int n, int tile_r, int groups) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_slots = n / tile_r, n4 = n >> 2;
  const float4* c4 = reinterpret_cast<const float4*>(c);
  const long long items = (long long)n_slots * groups;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int slot = (int)(item / groups), r = (int)(item % groups) * WARPS + warp;
    const int t = schedule[slot];
    if (t < 0 || t >= n_slots || r >= tile_r) continue;  // padding slot, or past the tile
    const int row = t * tile_r + r;
    const float4* g4 = reinterpret_cast<const float4*>(G + (size_t)row * n);
    float m = c[row];
    int k = lane;
    for (; k + 32 * (UNROLL - 1) < n4; k += 32 * UNROLL) {
      float4 g[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) g[u] = __ldcs(g4 + k + 32 * u);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) m = masked_max(m, g[u], __ldg(c4 + k + 32 * u));
    }
    for (; k < n4; k += 32) m = masked_max(m, __ldcs(g4 + k), __ldg(c4 + k));
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) out[row] = m;
  }
}

}  // namespace

extern "C" int cc_propagate(const float* G, const float* c, const int* schedule,
                            float* out, int n, int tile_r, int tile_c,
                            void* stream) {
  if (n <= 0 || tile_r <= 0 || tile_c <= 0 || n % tile_r || n % tile_c ||
      tile_c % 4)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cc_propagate_kernel,
                                                        THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  const int groups = (tile_r + WARPS - 1) / WARPS;
  const long long items = (long long)(n / tile_r) * groups;
  const int grid = (int)(items < (long long)sms * per_sm ? items : (long long)sms * per_sm);
  cc_propagate_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(G, c, schedule, out, n,
                                                                  tile_r, groups);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
