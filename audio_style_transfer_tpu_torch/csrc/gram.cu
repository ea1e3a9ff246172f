// All-pairs channel gram forward (K5).
//
// Replaces: audio_style_transfer_tpu/ops/pallas_gram.py::_fwd_kernel.
//   G[n, a, b, c] = sum_t E_a[n, t, c] * E_b[n, t, c]
// for L taps (each [B, T, C], float32 or bf16), float32 products and sums,
// written as [B, L, L, C] float32.
//
// What bounds it on the H100 (L=10, T=16384, C=128, bf16): the taps are
// 42 MB to read once, 12.5 us at 3.35 TB/s; the L(L+1)/2 = 55 pair products
// are 0.23 GFLOP of float32 FMA, about 3.5 us at the CUDA-core peak. So it is
// bound by reading the taps, and the design reads each tap element from
// device memory exactly once: a block stages an [8, L, 32] (time, tap,
// channel) slab in shared memory and every thread (channel c, tap a) sums
// E_a * E_b for b >= a into registers.
//
// Channels are independent. Pass 1 runs a grid of (channel block, time
// chunk, clip) and writes per-chunk partial sums; pass 2 adds the partials in
// a fixed order and mirrors the upper triangle. No atomics, so the result,
// and the L-BFGS trajectory built on it, repeats bit for bit from run to run.
// A T that is not a multiple of the chunk or of the 8-row slab is masked.

#include "ast_io.h"

namespace {

constexpr int MAXL = 32;  // taps per launch
constexpr int CB = 32;    // channels per block
constexpr int TT = 8;     // time rows per shared-memory slab

struct TapPtrs {
  const void* p[MAXL];
};

// Up to MAXL x CB = 1024 threads a block: cap registers so that many fit.
template <typename T>
__global__ void __launch_bounds__(MAXL * CB)
gram_partial_kernel(TapPtrs taps, int L, int t_len, int c_len, int chunk,
                    float* __restrict__ partial) {
  __shared__ float s[TT][MAXL][CB];
  const int c = threadIdx.x, a = threadIdx.y;
  const int cg = blockIdx.x * CB + c;
  const int n = blockIdx.z;
  const long t0 = (long)blockIdx.y * chunk;
  const long t1 = min(t0 + (long)chunk, (long)t_len);
  const T* ea_ptr = static_cast<const T*>(taps.p[a]);

  float acc[MAXL];
#pragma unroll
  for (int b = 0; b < MAXL; ++b) acc[b] = 0.f;

  for (long tb = t0; tb < t1; tb += TT) {
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
      const long t = tb + tt;
      s[tt][a][c] = t < t1 ? Io<T>::ld(ea_ptr, ((long)n * t_len + t) * c_len + cg) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
      const float ea = s[tt][a][c];
#pragma unroll
      for (int b = 0; b < MAXL; ++b)
        if (b >= a && b < L) acc[b] += ea * s[tt][b][c];
    }
    __syncthreads();
  }

  // partial: [B, n_chunks, L, L, C]; only b >= a is written and read.
  float* P = partial + (((long)n * gridDim.y + blockIdx.y) * L + a) * (long)L * c_len;
#pragma unroll
  for (int b = 0; b < MAXL; ++b)
    if (b >= a && b < L) P[(long)b * c_len + cg] = acc[b];
}

__global__ void gram_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                   int B, int L, int c_len, int n_chunks) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long total = (long)B * L * L * c_len;
  if (idx >= total) return;
  const int c = idx % c_len;
  const int b = (idx / c_len) % L;
  const int a = (idx / ((long)c_len * L)) % L;
  const long n = idx / ((long)c_len * L * L);
  const int lo = min(a, b), hi = max(a, b);
  float sum = 0.f;
  for (int k = 0; k < n_chunks; ++k)
    sum += partial[(((n * n_chunks + k) * L + lo) * L + hi) * c_len + c];
  out[idx] = sum;
}

}  // namespace

extern "C" {

// taps: host array of L device pointers. partial: [B, ceil(T/chunk), L, L, C]
// float32 scratch; out: [B, L, L, C] float32. Returns cudaGetLastError().
int ast_pair_gram(const void* const* taps, int L, int B, int t_len, int c_len, int chunk,
                  int is_bf16, void* partial, void* out, void* stream) {
  if (L < 1 || L > MAXL || c_len % CB != 0 || chunk < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  TapPtrs ptrs = {};
  for (int i = 0; i < L; ++i) ptrs.p[i] = taps[i];
  const int n_chunks = (t_len + chunk - 1) / chunk;
  const dim3 grid(c_len / CB, n_chunks, B), block(CB, L);
  if (is_bf16)
    gram_partial_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(ptrs, L, t_len, c_len, chunk,
                                                              (float*)partial);
  else
    gram_partial_kernel<float><<<grid, block, 0, s>>>(ptrs, L, t_len, c_len, chunk,
                                                      (float*)partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long total = (long)B * L * L * c_len;
  gram_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      (const float*)partial, (float*)out, B, L, c_len, n_chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
