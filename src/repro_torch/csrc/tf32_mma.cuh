// Pieces shared by the scan kernels (ssm_scan.cu, rwkv6_scan.cu and their
// gradients ssm_scan_bwd.cu, rwkv6_scan_bwd.cu): cp.async
// staging, and fp32-accurate products on the tensor cores as split TF32.
//
// Products run on mma.sync m16n8k8 TF32 with fp32 accumulation (SASS
// HMMA). An fp32 operand a is split into big = tf32(a) (cvt.rn.tf32.f32,
// nearest even; kernels/ref.py:tf32_round) and small = tf32(a - big) (the
// subtraction is exact), which keeps about 21 bits. An operand exact in
// TF32 is not split: bfloat16 data (7 stored mantissa bits of TF32's 10).
// One k-step of 8 adds, into one fp32 accumulator:
//   one split operand   a_small b, then a_big b (or a b_small, a b_big);
//   both split          a_small b_big, a_big b_small, a_big b_big;
//   neither             a b.
// kernels/ref.py:_tf32_terms and _mma_sum emulate that order on the CPU.
//
// Fragments (PTX ISA, m16n8k8 .tf32): with g = lane / 4 and t = lane % 4,
// A holds (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B holds
// (k row t, col g), (t + 4, g); the accumulator (row g, cols 2t, 2t + 1)
// and (g + 8, 2t, 2t + 1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

// bfloat16 data is exact in TF32: not split
template <class T> constexpr bool kExact = !std::is_same<T, float>::value;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void set_zero(float& v) { v = 0.f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16& v) { v = __float2bfloat16(0.f); }

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// x rounded to TF32 (10 stored mantissa bits), to nearest, ties to even;
// the low 13 bits come out zero (kernels/ref.py:tf32_round).
__device__ __forceinline__ uint32_t tf32_rne(float x) {
  uint32_t r;
  asm("cvt.rn.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float v, uint32_t& big, uint32_t& small) {
  big = tf32_rne(v);
  small = tf32_rne(__fsub_rn(v, __uint_as_float(big)));
}

// An A fragment (m16 x k8) as TF32 halves: big and small, or, when the
// operand is exact in TF32, the value itself in big.
struct FragA {
  uint32_t big[4], small[4];
};

template <bool EXACT>
__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
  FragA f;
  const float v[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (EXACT) {
      f.big[i] = __float_as_uint(v[i]);
      f.small[i] = 0u;
    } else {
      split(v[i], f.big[i], f.small[i]);
    }
  }
  return f;
}

// d += a b on the tensor cores, m16n8k8, TF32 in, fp32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k-step of an fp32-accurate product: the TF32 products above, in
// their order. AX / BX: the A / B operand is exact in TF32.
template <bool AX, bool BX>
__device__ __forceinline__ void mma_step(float (&d)[4], const FragA& a, float b0, float b1) {
  if constexpr (AX && BX) {
    mma(d, a.big, __float_as_uint(b0), __float_as_uint(b1));
  } else if constexpr (AX) {
    uint32_t bb0, bs0, bb1, bs1;
    split(b0, bb0, bs0);
    split(b1, bb1, bs1);
    mma(d, a.big, bs0, bs1);
    mma(d, a.big, bb0, bb1);
  } else if constexpr (BX) {
    mma(d, a.small, __float_as_uint(b0), __float_as_uint(b1));
    mma(d, a.big, __float_as_uint(b0), __float_as_uint(b1));
  } else {
    uint32_t bb0, bs0, bb1, bs1;
    split(b0, bb0, bs0);
    split(b1, bb1, bs1);
    mma(d, a.small, bb0, bb1);
    mma(d, a.big, bs0, bs1);
    mma(d, a.big, bb0, bb1);
  }
}

// Copy `rows` rows of `cols` elements (global row i at src + i * stride)
// into a shared tile of `pitch` elements a row, by the NT threads of the
// block: 16-byte cp.async when `vec`, else plain loads and stores.
template <class T, int NT>
__device__ __forceinline__ void stage_tile(T* dst, int pitch, const T* src, long long stride,
                                           int rows, int cols, bool vec) {
  constexpr int PER = 16 / sizeof(T);
  if (vec) {
    const int pieces = cols / PER;
    for (int e = threadIdx.x; e < rows * pieces; e += NT) {
      const int i = e / pieces, j = e % pieces;
      cp16(dst + i * pitch + j * PER, src + i * stride + j * PER);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += NT) {
      const int i = e / cols, j = e % cols;
      dst[i * pitch + j] = src[i * stride + j];
    }
  }
}

// Zero rows [from, to) of a shared tile of `pitch` elements a row.
template <class T, int NT>
__device__ __forceinline__ void zero_tile_rows(T* dst, int pitch, int from, int to) {
  for (int e = threadIdx.x; e < (to - from) * pitch; e += NT) set_zero(dst[from * pitch + e]);
}

// Whether `ptr` and every stride (in elements of `elem_bytes`) fall on 16
// bytes, so rows can be staged with 16-byte cp.async.
bool aligned16(const void* ptr, long long elem_bytes, std::initializer_list<long long> strides) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  for (long long st : strides)
    if ((st * elem_bytes) % 16) return false;
  return true;
}

}  // namespace
