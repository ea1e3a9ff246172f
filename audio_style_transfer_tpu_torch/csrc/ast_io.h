// Shared helpers for the port's kernels: element loads and stores in the
// storage type (float or bf16) with float32 arithmetic, and the rounding that
// stands in for JAX's `.astype(dt)` cast points; the valid-window predicate of
// the trunk kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float ld(const float* p, long i) { return p[i]; }
  static __device__ __forceinline__ void st(float* p, long i, float v) { p[i] = v; }
  static __device__ __forceinline__ float rnd(float v) { return v; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float ld(const __nv_bfloat16* p, long i) {
    return __bfloat162float(p[i]);
  }
  static __device__ __forceinline__ void st(__nv_bfloat16* p, long i, float v) {
    p[i] = __float2bfloat16(v);
  }
  // Round to bf16 (nearest-even, as torch and XLA do) and widen back.
  static __device__ __forceinline__ float rnd(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
};

// Whether row `row` lies inside the valid window [lo, hi) of its clip.
__device__ __forceinline__ bool in_window(long row, int clip_rows, int lo, int hi) {
  const int pos = (int)(row % clip_rows);
  return pos >= lo && pos < hi;
}
