// One DLS-scheduled connected-components propagation step.
//
// Replaces the Pallas kernel repro/kernels/cc_propagate.py:cc_propagate.
//   u[i] = max(max_{j: G[i,j] > 0} c[j], c[i])
// over a dense float32 {0, 1} adjacency G (n x n, row-major).
//
// Bound on an H100: bytes. The step reads G once (4 n^2 bytes, 1 GiB at
// n = 16,384, 0.32 ms at 3.35 TB/s) and does about 2 n^2 compare/max
// operations. Design: one CTA per row tile, visited in the DLS schedule's
// order (blockIdx.x -> schedule[blockIdx.x]); each warp owns rows of the
// tile and walks the column tiles in order with 16-byte streaming loads,
// lanes on neighbouring addresses, keeping a running max that starts from
// the row's own label. Max is exact, so the result is bitwise the plain
// version's whatever the order. Masked entries contribute 0: labels are
// >= 1, so a 0 never wins.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;

__global__ void __launch_bounds__(THREADS)
cc_propagate_kernel(const float* __restrict__ G, const float* __restrict__ c,
                    const int* __restrict__ schedule, float* __restrict__ out,
                    int n, int tile_r, int tile_c) {
  const int t = schedule[blockIdx.x];
  if (t < 0 || t >= n / tile_r) return;  // not a row tile: no work
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const float4* c4 = reinterpret_cast<const float4*>(c);
  for (int r = warp; r < tile_r; r += n_warps) {
    const int row = t * tile_r + r;
    const float4* g4 = reinterpret_cast<const float4*>(G + (size_t)row * n);
    float m = c[row];  // column tile 0 seeds the running max with c[row]
    for (int j0 = 0; j0 < n; j0 += tile_c) {
      const int k_end = (j0 + tile_c) >> 2;
#pragma unroll 4
      for (int k = (j0 >> 2) + lane; k < k_end; k += 32) {
        const float4 g = __ldcs(g4 + k);
        const float4 cc = __ldg(c4 + k);
        m = fmaxf(m, g.x > 0.f ? cc.x : 0.f);
        m = fmaxf(m, g.y > 0.f ? cc.y : 0.f);
        m = fmaxf(m, g.z > 0.f ? cc.z : 0.f);
        m = fmaxf(m, g.w > 0.f ? cc.w : 0.f);
      }
    }
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
  cc_propagate_kernel<<<n / tile_r, THREADS, 0, (cudaStream_t)stream>>>(
      G, c, schedule, out, n, tile_r, tile_c);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
