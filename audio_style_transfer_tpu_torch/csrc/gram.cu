// All-pairs channel gram: forward (K5) and backward (K6).
//
// K5 replaces: audio_style_transfer_tpu/ops/pallas_gram.py::_fwd_kernel.
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
//
// K6 replaces: audio_style_transfer_tpu/ops/pallas_gram.py::_bwd_kernel.
//   dE_a[n, t, c] = sum_b h[n, a, b, c] * E_b[n, t, c],   h = g + g^T (f32)
// summed over b in ascending order in float32 and rounded once to the tap
// dtype. JAX routes the gram backward here for L > 15 or T > 32768 (the
// full-stack transfer, L=30).
//
// What bounds it on the H100 (L=30, T=16384, C=128, bf16): the taps are
// 126 MB to read once and the cotangents 126 MB to write once, about 75 us
// at 3.35 TB/s; the L^2 = 900 multiply-adds per element are 3.8 GFLOP of
// float32 FMA, about 56 us at the CUDA-core peak. So bytes and FMAs are about
// even, and the design keeps both at one pass:
//   - a thread owns one channel and R=4 time rows, and holds E_b for every
//     b <= 32 of its rows in registers (128 values): each tap element is read
//     from device memory once and each cotangent written once;
//   - h[:, :, c] for the block's 16 channels lives in shared memory, c
//     fastest, so the 16 lanes of a half-warp read 16 banks without conflict
//     (the two row groups of a warp read the same words: a broadcast). Each
//     h word read from shared memory feeds R=4 FMAs, which keeps the shared
//     memory rate (32 words a clock) level with the FMA rate (128 a clock).
//   - h for 16 channels at L=32 is 64 KB, above the 48 KB static limit: it is
//     dynamic shared memory, raised once with cudaFuncSetAttribute.
//   - 128 threads a block under __launch_bounds__, so the ~150 registers a
//     thread needs always fit (K5's 1024-thread blocks failed at L=32 before
//     theirs were capped); every block walks 256 time rows, so h is staged
//     once per 256 x 16 outputs.

#include "ast_io.h"

namespace {

constexpr int MAXL = 32;  // taps per launch
constexpr int CB = 32;    // channels per block
constexpr int TT = 8;     // time rows per shared-memory slab

// K6 geometry.
constexpr int BW_CB = 16;                 // channels per block
constexpr int BW_RG = 8;                  // row groups per block
constexpr int BW_R = 4;                   // time rows per thread
constexpr int BW_NT = BW_CB * BW_RG;      // 128 threads
constexpr int BW_STEP = BW_RG * BW_R;     // 32 rows per block step
constexpr int BW_ROWS = 8 * BW_STEP;      // 256 rows per block
constexpr int BW_SMEM = MAXL * MAXL * BW_CB * (int)sizeof(float);

struct TapPtrs {
  const void* p[MAXL];
};

struct OutPtrs {
  void* p[MAXL];
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

// K6. Grid (C / BW_CB, ceil(T / BW_ROWS), B); thread (channel cc, row group
// rg) owns rows t0 + rg + BW_RG * r, r < BW_R, of each 32-row step.
template <typename T>
__global__ void __launch_bounds__(BW_NT)
gram_bwd_kernel(TapPtrs taps, OutPtrs outs, const float* __restrict__ h, int L, int t_len,
                int c_len) {
  extern __shared__ float sh[];  // [L * L][BW_CB]: h[n, a, b, c0 + cc]
  const int cc = threadIdx.x % BW_CB, rg = threadIdx.x / BW_CB;
  const int cg = blockIdx.x * BW_CB + cc;
  const int n = blockIdx.z;
  const float* hn = h + (long)n * L * L * c_len + blockIdx.x * BW_CB;
  for (int e = threadIdx.x; e < L * L * BW_CB; e += BW_NT)
    sh[e] = hn[(long)(e / BW_CB) * c_len + e % BW_CB];
  __syncthreads();

  const long t_begin = (long)blockIdx.y * BW_ROWS;
  const long t_end = min(t_begin + (long)BW_ROWS, (long)t_len);
  for (long t0 = t_begin; t0 < t_end; t0 += BW_STEP) {
    float e[MAXL][BW_R];
#pragma unroll
    for (int b = 0; b < MAXL; ++b) {
#pragma unroll
      for (int r = 0; r < BW_R; ++r) {
        const long t = t0 + rg + BW_RG * r;
        e[b][r] = (b < L && t < t_end)
                      ? Io<T>::ld(static_cast<const T*>(taps.p[b]),
                                  ((long)n * t_len + t) * c_len + cg)
                      : 0.f;
      }
    }
    for (int a = 0; a < L; ++a) {
      const float* ha = sh + a * L * BW_CB + cc;
      float acc[BW_R];
#pragma unroll
      for (int r = 0; r < BW_R; ++r) acc[r] = 0.f;
#pragma unroll
      for (int b = 0; b < MAXL; ++b) {
        if (b < L) {
          const float hv = ha[b * BW_CB];
#pragma unroll
          for (int r = 0; r < BW_R; ++r) acc[r] = fmaf(hv, e[b][r], acc[r]);
        }
      }
      T* dst = static_cast<T*>(outs.p[a]);
#pragma unroll
      for (int r = 0; r < BW_R; ++r) {
        const long t = t0 + rg + BW_RG * r;
        if (t < t_end) Io<T>::st(dst, ((long)n * t_len + t) * c_len + cg, acc[r]);
      }
    }
  }
}

template <typename T>
cudaError_t launch_gram_bwd(const TapPtrs& taps, const OutPtrs& outs, const float* h, int L,
                            int B, int t_len, int c_len, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(gram_bwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, BW_SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(c_len / BW_CB, (t_len + BW_ROWS - 1) / BW_ROWS, B);
  const size_t smem = (size_t)L * L * BW_CB * sizeof(float);
  gram_bwd_kernel<T><<<grid, BW_NT, smem, s>>>(taps, outs, h, L, t_len, c_len);
  return cudaGetLastError();
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

// taps / outs: host arrays of L device pointers ([B, T, C], one dtype);
// h: [B, L, L, C] float32. Returns cudaGetLastError().
int ast_pair_gram_bwd(const void* const* taps, void* const* outs, int L, int B, int t_len,
                      int c_len, int is_bf16, const void* h, void* stream) {
  if (L < 1 || L > MAXL || c_len % BW_CB != 0) return (int)cudaErrorInvalidValue;
  TapPtrs in = {};
  OutPtrs out = {};
  for (int i = 0; i < L; ++i) {
    in.p[i] = taps[i];
    out.p[i] = outs[i];
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const float* hp = (const float*)h;
  const cudaError_t e =
      is_bf16 ? launch_gram_bwd<__nv_bfloat16>(in, out, hp, L, B, t_len, c_len, s)
              : launch_gram_bwd<float>(in, out, hp, L, B, t_len, c_len, s);
  return (int)e;
}

}  // extern "C"
