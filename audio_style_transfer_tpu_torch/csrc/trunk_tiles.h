// Register-tile product and weight staging shared by the trunk kernels
// (trunk.cu: K1, K2, K7f, K7b; trunk_wf.cu: K2-wf).
//
// A group of 256 threads owns a [64, 128] float32 output tile: thread
// (tx, ty), tx = tid % 16, ty = tid / 16, holds rows ty + 16 i (i < 4) and
// columns tx + 16 j (j < 8). The contraction runs in chunks of KC, both
// operands staged in shared memory, the left one k-major.
#pragma once

#include "ast_io.h"

constexpr int C = 128;  // trunk width
constexpr int KC = 16;  // contraction chunk staged in shared memory

// acc[i][j] += sum_k A[k * lda + ty + 16 i] * B[k][tx + 16 j] for i < NI
// (NI < 4 skips the 16-row groups a short tile does not have).
template <int NI>
__device__ __forceinline__ void mma_rows(float (&acc)[4][8], const float* A, int lda,
                                         const float (*B)[C + 1], int tx, int ty) {
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    float a[NI], b[8];
#pragma unroll
    for (int i = 0; i < NI; ++i) a[i] = A[k * lda + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = B[k][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void mma_chunk(float (&acc)[4][8], const float* A, int lda,
                                          const float (*B)[C + 1], int tx, int ty) {
  mma_rows<4>(acc, A, lda, B, tx, ty);
}

// Stage W[c0 + k][n] (transposed=false) or W[n][c0 + k] (transposed=true)
// of a [C, C] weight into b, by the `nthreads` threads numbered `tid`.
template <typename T>
__device__ __forceinline__ void stage_b(float (*b)[C + 1], const T* __restrict__ w, int c0,
                                        bool transposed, int tid, int nthreads) {
  for (int e = tid; e < KC * C; e += nthreads) {
    int k, n;
    long idx;
    if (transposed) {
      n = e / KC;
      k = e % KC;
      idx = (long)n * C + c0 + k;
    } else {
      k = e / C;
      n = e % C;
      idx = (long)(c0 + k) * C + n;
    }
    b[k][n] = Io<T>::ld(w, idx);
  }
}
