// All-pairs channel gram: forward (K5) and backward (K6), float32 FMAs on the
// CUDA cores. Per channel both are tiny matrix products (L x L, depth T), but
// channel is the fastest axis in memory and every tap is an array of its own:
// the layout, not the arithmetic, is what the design serves. Every figure in
// this note is for one NVIDIA H100 80GB HBM3 at a 700.00 W power limit
// (nvidia-smi --query-gpu=name,power.limit): 132 SMs, 3.35 TB/s.
//
// K5 replaces: audio_style_transfer_tpu/ops/pallas_gram.py::_fwd_kernel.
//   G[n, a, b, c] = sum_t E_a[n, t, c] * E_b[n, t, c]
// for L taps (each [B, T, C], float32 or bf16), float32 products and sums,
// written as [B, L, L, C] float32.
//
// What bounds K5 (bf16, T=16384, C=128): at L=30 the taps are 126 MB to read
// once, 37.7 us at 3.35 TB/s; the 465 pairs of the upper triangle are 0.98 G
// float32 FMAs, about 30 us on the CUDA cores. At L=10: 42 MB, 12.5 us, and
// 0.12 G FMAs. So bytes bound it, with the FMAs close behind at L=30. An SM
// starts 128 FMAs but only 32 shared-memory words a clock, so a word read
// from shared memory has to feed at least 4 FMAs. The design:
//   - a thread owns one channel and an 8 x 8 tile of (tap a, tap b) pairs: 16
//     values read per time row for 64 FMAs (8 read on a diagonal tile). The
//     upper triangle of tiles is 10 tiles for L <= 32, 6 for L <= 24, 3 for
//     L <= 16 and 1 for L <= 8; the kernel is compiled for each, and every
//     warp of a block does the same work (no triangular imbalance);
//   - a block owns 8 channels (one 16-byte piece of a bf16 row) and a run of
//     time rows. A warp is 8 channels x 4 rows of one tile; RQ warps a tile
//     share the rows of a stage. The taps come in as 16-byte cp.async into a
//     ring of 4 stages of 32..128 rows, [row][tap][channel] with an odd
//     number of tap slots a row, so the 4 rows a warp reads at once fall in
//     distinct banks; loads of the next three stages run under the FMAs;
//   - the sum over T has a fixed order: ascending rows in a thread, a
//     shuffle tree over a warp's 4 rows, the block's warps in order through
//     shared memory, then the blocks' partial sums in order in a second
//     small kernel that also mirrors the triangle. No atomics: the result
//     repeats bit for bit. The wrapper cuts T so that the grid is about one
//     block an SM (8 chunks of 2048 rows at C=128), which keeps the partial
//     sums, [B, chunks, L(L+1)/2, C] float32, at 1.9 MB for L=30.
//
// K6 replaces: audio_style_transfer_tpu/ops/pallas_gram.py::_bwd_kernel.
//   dE_a[n, t, c] = sum_b h[n, a, b, c] * E_b[n, t, c],   h = g + g^T (f32)
// summed over b in ascending order in float32 (fmaf) and rounded once to the
// tap dtype. Every gram backward on the card runs it, at any L.
//
// What bounds K6 (bf16, T=16384, C=128): at L=30 taps in and cotangents out
// are 252 MB, 75.3 us; the L^2 = 900 FMAs per element are 1.89 G, about 64 us
// on the CUDA cores, which need every instruction slot for that. At L=10: 84 MB,
// 25.1 us, 0.21 G FMAs. The registers a thread can give to sums (128) set how
// often a word of h or E is used again, and shared memory delivers 32 words
// a clock against 128 FMAs. The design:
//   - a block owns 16 channels (whole 32-byte sectors of a bf16 row) and a
//     run of time rows, walked 32 at a time. A warp is 16 channels x the two
//     halves of the taps a at 8 rows; a thread keeps (bucket / 2) x 8 sums in
//     registers, so every word of h feeds 8 FMAs and every word of E 4 to
//     16. The kernel is compiled for L <= 8, 16, 24 and 32: ten taps pay for
//     16, not for 32;
//   - h of the block's channels lives in shared memory as [b][channel][a],
//     a padded to an odd count of float4, read as float4 along a: one read
//     feeds 32 FMAs, and the lanes of a quarter-warp hit distinct banks. It
//     is staged once per block; the wrapper gives a block as many rows as
//     make the grid one wave of resident blocks (512 at L=30, 256 at L=10);
//   - the taps come in as 16-byte cp.async, four taps b at a time, into a
//     ring of 4 (float32) or 6 (bf16) stages, [row][tap][channel]: the loads
//     of the next stages run under the FMAs of this one, whatever the
//     registers hold. The sum over b is ascending, fmaf, rounded once;
//   - float32 cotangents are stored as 4-byte words in 64-byte runs; bf16
//     ones as 4-byte pairs of channels: the two lanes of a channel pair hold
//     the same rows, swap halves with one shuffle and store two rows each;
//   - 128 threads a block; two blocks resident an SM for L > 16 (shared
//     memory: 69 KB of h and 24 to 32 KB of ring at L=30), four below.
//
// Registers a thread (nvcc -Xptxas -v, sm_90a; tools/kernel_resources.py)
// stand beside the geometry below; the times are in PERF.md.

#include "ast_io.h"

namespace {

constexpr int MAXL = 32;  // taps per launch

struct TapPtrs {
  const void* p[MAXL];
};

struct OutPtrs {
  void* p[MAXL];
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's commit groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- K5 ------

constexpr int FW_CB = 8;      // channels per block
constexpr int FW_STAGES = 4;  // stages of the cp.async ring

// Geometry of the forward kernel for NG groups of 8 taps (L <= 8 * NG).
// Registers a thread, bf16 / float32 (nvcc -Xptxas -v, no spills), one
// block an SM: NG=1, 2, 3 114 / 116 (256, 384, 384 threads), NG=4 95 / 96
// (640 threads, capped at 102).
template <typename T, int NG>
struct FwdGeom {
  static constexpr int RQ = NG == 1 ? 8 : NG == 2 ? 4 : 2;      // warps per tile
  static constexpr int SR = NG == 1 ? 128 : NG == 2 ? 64 : 32;  // rows per stage
  static constexpr int NTILES = NG * (NG + 1) / 2;
  static constexpr int NTHR = NTILES * RQ * 32;
  static constexpr int NRS = RQ * 4;    // rows a tile's warps read at once
  static constexpr int RPT = SR / NRS;  // rows per thread and stage
  static constexpr int U = FW_CB * (int)sizeof(T) / 16;  // 16-byte pieces per row and tap
  static constexpr int LP = NG * 8 + 1;                  // tap slots per row, odd
  static constexpr int TAPB = FW_CB * (int)sizeof(T);
  static constexpr int ROWB = LP * TAPB;
  static constexpr int STAGEB = SR * ROWB;
  static constexpr int SMEM = FW_STAGES * STAGEB;
  static_assert(NTHR % (SR * U) == 0, "a stage's loads must split evenly over the threads");
  static_assert(RQ * NTILES * 64 * FW_CB * (int)sizeof(float) <= SMEM,
                "the block's reduction reuses the ring");
};

// Tile number -> (tap group a, tap group b), b >= a, row by row.
__device__ __forceinline__ void tile_groups(int tile, int ng, int& ga, int& gb) {
  ga = 0;
  gb = tile;
  while (gb >= ng - ga) {
    gb -= ng - ga;
    ++ga;
  }
  gb += ga;
}

// Grid (C / 8, chunks, B). partial: [B, chunks, L (L + 1) / 2, C].
template <typename T, int NG>
__global__ void __launch_bounds__(FwdGeom<T, NG>::NTHR, 1)
gram_fwd_kernel(const __grid_constant__ TapPtrs taps, int L, int t_len, int c_len, int chunk,
                float* __restrict__ partial) {
  using G = FwdGeom<T, NG>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tile = warp / G::RQ, rq = warp % G::RQ;
  const int slot = rq * 4 + lane / 8, c = lane % 8;
  int ga, gb;
  tile_groups(tile, NG, ga, gb);
  const int c0 = blockIdx.x * FW_CB, n = blockIdx.z;
  const long t0 = (long)blockIdx.y * chunk;
  const long t1 = min(t0 + (long)chunk, (long)t_len);
  const int n_stages = (int)((t1 - t0 + G::SR - 1) / G::SR);
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);

  // This thread's piece of a stage: row `lrow`, 16-byte piece `lu`, of the
  // taps ltap, ltap + NTHR / (SR * U), ...
  const int lr = tid % (G::SR * G::U);
  const int lrow = lr / G::U, lu = lr % G::U;
  const int ltap = tid / (G::SR * G::U);
  auto load = [&](int s) {
    if (s < n_stages) {
      const long t = t0 + (long)s * G::SR + lrow;
      const bool in = t < t1;  // rows past the chunk are zero-filled
      const long off = (((long)n * t_len + (in ? t : t0)) * c_len + c0) * (long)sizeof(T) + lu * 16;
      const uint32_t dst = sbase + (s % FW_STAGES) * G::STAGEB + lrow * G::ROWB + lu * 16;
      for (int tap = ltap; tap < L; tap += G::NTHR / (G::SR * G::U))
        cp_async16(dst + tap * G::TAPB, static_cast<const char*>(taps.p[tap]) + off, in ? 16 : 0);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < FW_STAGES - 1; ++s) load(s);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<FW_STAGES - 2>();  // stage s has landed (this thread's part)
    __syncthreads();                 // everyone's part; stage s - 1 is free
    load(s + FW_STAGES - 1);
    const unsigned char* buf = smem + (s % FW_STAGES) * G::STAGEB;
#pragma unroll
    for (int i = 0; i < G::RPT; ++i) {
      const T* row = reinterpret_cast<const T*>(buf + (slot + G::NRS * i) * G::ROWB) + c;
      float ea[8], eb[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) ea[k] = Io<T>::ld(row, (ga * 8 + k) * FW_CB);
      if (ga != gb) {
#pragma unroll
        for (int k = 0; k < 8; ++k) eb[k] = Io<T>::ld(row, (gb * 8 + k) * FW_CB);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) eb[k] = ea[k];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[k][j] = fmaf(ea[k], eb[j], acc[k][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it becomes the reduction buffer

  // A warp's 4 rows (lanes 8 apart), then the tile's warps in order.
  float* red = reinterpret_cast<float*>(smem);  // [RQ][NTILES][64][8]
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = acc[k][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 8) red[((rq * G::NTILES + tile) * 64 + k * 8 + j) * FW_CB + c] = v;
    }
  __syncthreads();
  const int n_pairs = L * (L + 1) / 2;
  float* dst = partial + ((long)n * gridDim.y + blockIdx.y) * n_pairs * c_len + c0;
  for (int idx = tid; idx < G::NTILES * 64 * FW_CB; idx += G::NTHR) {
    const int cc = idx % FW_CB, ij = (idx / FW_CB) % 64, tl = idx / (64 * FW_CB);
    int ta, tb;
    tile_groups(tl, NG, ta, tb);
    const int a = ta * 8 + ij / 8, b = tb * 8 + ij % 8;
    if (a <= b && b < L) {
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < G::RQ; ++q) sum += red[((q * G::NTILES + tl) * 64 + ij) * FW_CB + cc];
      dst[(long)(a * L - a * (a - 1) / 2 + b - a) * c_len + cc] = sum;
    }
  }
}

// out[n, a, b, c] = the chunks' partial sums of pair (min, max), in order.
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
  const long n_pairs = L * (L + 1) / 2;
  const long pair = lo * L - lo * (lo - 1) / 2 + hi - lo;
  float sum = 0.f;
  for (int k = 0; k < n_chunks; ++k)
    sum += partial[((n * n_chunks + k) * n_pairs + pair) * c_len + c];
  out[idx] = sum;
}

template <typename T, int NG>
cudaError_t launch_gram_fwd(const TapPtrs& taps, int L, int B, int t_len, int c_len, int chunk,
                            float* partial, cudaStream_t s) {
  using G = FwdGeom<T, NG>;
  cudaError_t e = cudaFuncSetAttribute(gram_fwd_kernel<T, NG>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(c_len / FW_CB, (t_len + chunk - 1) / chunk, B);
  gram_fwd_kernel<T, NG><<<grid, G::NTHR, G::SMEM, s>>>(taps, L, t_len, c_len, chunk, partial);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_gram_fwd(const TapPtrs& taps, int L, int B, int t_len, int c_len, int chunk,
                              float* partial, cudaStream_t s) {
  switch ((L + 7) / 8) {
    case 1: return launch_gram_fwd<T, 1>(taps, L, B, t_len, c_len, chunk, partial, s);
    case 2: return launch_gram_fwd<T, 2>(taps, L, B, t_len, c_len, chunk, partial, s);
    case 3: return launch_gram_fwd<T, 3>(taps, L, B, t_len, c_len, chunk, partial, s);
    default: return launch_gram_fwd<T, 4>(taps, L, B, t_len, c_len, chunk, partial, s);
  }
}

// ---------------------------------------------------------------- K6 ------

constexpr int BW_CB = 16;    // channels per block
constexpr int BW_NT = 128;   // threads: 4 warps, each 16 channels x 2 halves of the taps a
constexpr int BW_STEP = 32;  // time rows per block step
constexpr int BW_R = 8;      // time rows per thread: t0 + warp + 4 i
constexpr int BW_GT = 4;     // taps b per stage of the ring

// Four rows (tr, tr + 4, tr + 8, tr + 12; those >= t_end masked) of the
// thread's channel, rounded to the tap dtype and stored. `idx` is the
// element index of (row tr, own channel), `stride` that of 4 rows, `cc` the
// channel within the block.
template <typename T>
struct Store4;

template <>
struct Store4<float> {
  static __device__ __forceinline__ void st(float* p, long idx, long stride, long tr, long t_end,
                                            int, unsigned, const float* v) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (tr + 4 * r < t_end) p[idx + r * stride] = v[r];
  }
};

// bf16 is stored as 4-byte pairs of channels. The lanes of channels 2k and
// 2k + 1 hold the same rows: the even lane stores the first two rows of the
// pair, the odd lane the last two, and one shuffle hands each the other's
// halves. The lanes of `mask` (whole channel pairs) must call together.
template <>
struct Store4<__nv_bfloat16> {
  static __device__ __forceinline__ void st(__nv_bfloat16* p, long idx, long stride, long tr,
                                            long t_end, int cc, unsigned mask, const float* v) {
    const bool odd = cc & 1;
    const int r0 = odd ? 2 : 0;
    const __nv_bfloat162 p01 = __floats2bfloat162_rn(v[0], v[1]);  // rows 0, 1
    const __nv_bfloat162 p23 = __floats2bfloat162_rn(v[2], v[3]);  // rows 2, 3
    const uint32_t lo = *reinterpret_cast<const uint32_t*>(&p01);
    const uint32_t hi = *reinterpret_cast<const uint32_t*>(&p23);
    const uint32_t keep = odd ? hi : lo;
    const uint32_t rcv = __shfl_xor_sync(mask, odd ? lo : hi, 1);
    // Channel order within a pair: the even lane's value first.
    const uint32_t x = odd ? rcv : keep, y = odd ? keep : rcv;
    __nv_bfloat16* q = p + (idx - (cc & 1)) + r0 * stride;
    if (tr + 4 * r0 < t_end) *reinterpret_cast<uint32_t*>(q) = __byte_perm(x, y, 0x5410);
    if (tr + 4 * (r0 + 1) < t_end)
      *reinterpret_cast<uint32_t*>(q + stride) = __byte_perm(x, y, 0x7632);
  }
};

// Geometry of the backward kernel for the bucket LB (L <= LB).
template <typename T, int LB>
struct BwdGeom {
  static constexpr int NST = sizeof(T) == 2 ? 6 : 4;      // stages of the cp.async ring
  static constexpr int U = BW_CB * (int)sizeof(T) / 16;   // 16-byte pieces per row and tap
  static constexpr int TAPB = BW_CB * (int)sizeof(T);
  static constexpr int ROWB = BW_GT * TAPB;
  static constexpr int STAGEB = BW_STEP * ROWB;           // 4 KB bf16, 8 KB float32
  static constexpr int PIECES = BW_STEP * BW_GT * U;
  static constexpr int RINGB = NST * STAGEB;
  static constexpr int HA = LB / 2;   // taps a per thread
  static constexpr int LP = LB + 4;   // floats per (b, channel): an odd count of float4
  static constexpr int MIN_BLOCKS = LB >= 24 ? 2 : 4;  // resident an SM
  static_assert(PIECES % BW_NT == 0, "a stage's loads must split evenly over the threads");
  static_assert(HA % 4 == 0, "a thread reads its taps a as float4");
};

// Grid (C / 16, ceil(T / rows), B). A warp is 16 channels x the two halves of
// the taps a, at the 8 rows t0 + warp + 4 i of each 32-row step; a thread
// keeps its LB / 2 x 8 sums in registers. The block walks (step, group of 4
// taps b) in order; each is one stage of the ring, [row][tap][channel] in the
// tap dtype, loaded NST - 1 stages ahead.
// Registers a thread, bf16 / float32 (nvcc -Xptxas -v, no spills):
// LB=8 92 / 105, LB=16 110 / 119, LB=24 167 / 173, LB=32 187 / 186.
template <typename T, int LB>
__global__ void __launch_bounds__(BW_NT, BwdGeom<T, LB>::MIN_BLOCKS)
gram_bwd_kernel(const __grid_constant__ TapPtrs taps, const __grid_constant__ OutPtrs outs,
                const float* __restrict__ h, int L, int t_len, int c_len, int rows) {
  using G = BwdGeom<T, LB>;
  constexpr int LP4 = G::LP / 4;
  extern __shared__ float4 smem4[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem4);
  // [L][BW_CB][LP4]: h[n, a, b, c0 + cc] at [b][cc][a]
  float4* sh4 = reinterpret_cast<float4*>(ring + G::RINGB);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cc = lane % BW_CB, ah = lane / BW_CB;
  const int c0 = blockIdx.x * BW_CB, n = blockIdx.z;
  {
    const int hc = tid % BW_CB, hr = tid / BW_CB;
    const float* hn = h + (long)n * L * L * c_len + c0 + hc;
#pragma unroll 4
    for (int b = 0; b < L; ++b)
      for (int a4 = hr; a4 < LB / 4; a4 += BW_NT / BW_CB) {
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int a = 4 * a4 + k;
          v[k] = a < L ? hn[((long)a * L + b) * c_len] : 0.f;
        }
        sh4[(b * BW_CB + hc) * LP4 + a4] = make_float4(v[0], v[1], v[2], v[3]);
      }
  }

  const long t_begin = (long)blockIdx.y * rows;
  const long t_end = min(t_begin + (long)rows, (long)t_len);
  const int n_steps = (int)((t_end - t_begin + BW_STEP - 1) / BW_STEP);
  const int n_groups = (L + BW_GT - 1) / BW_GT;
  const int total = n_steps * n_groups;
  const uint32_t ring_base = (uint32_t)__cvta_generic_to_shared(ring);

  // The loads of the next (step, group), in the walk's order.
  int ld_step = 0, ld_group = 0, ld_slot = 0;
  auto start_loads = [&]() {
    if (ld_step < n_steps) {
#pragma unroll
      for (int j = 0; j < G::PIECES / BW_NT; ++j) {
        const int piece = tid + BW_NT * j;
        const int u = piece % G::U, row = (piece / G::U) % BW_STEP, k = piece / (G::U * BW_STEP);
        const int b = ld_group * BW_GT + k;
        const long t = t_begin + (long)ld_step * BW_STEP + row;
        const bool in = b < L && t < t_end;  // what is not there is zero-filled
        const long off =
            (((long)n * t_len + (in ? t : t_begin)) * c_len + c0) * (long)sizeof(T) + u * 16;
        cp_async16(ring_base + ld_slot * G::STAGEB + row * G::ROWB + k * G::TAPB + u * 16,
                   static_cast<const char*>(taps.p[in ? b : 0]) + off, in ? 16 : 0);
      }
      ld_slot = ld_slot + 1 == G::NST ? 0 : ld_slot + 1;
      if (++ld_group == n_groups) {
        ld_group = 0;
        ++ld_step;
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < G::NST - 1; ++i) start_loads();

  float acc[G::HA][BW_R];
  int group = 0, slot = 0;
  long t0 = t_begin;
  const unsigned pair_mask = ah ? 0xffff0000u : 0x0000ffffu;
  for (int q = 0; q < total; ++q) {
    cp_async_wait<G::NST - 2>();  // this (step, group) has landed (this thread's part)
    __syncthreads();              // everyone's part, and h; the stage before is free
    start_loads();
    if (group == 0) {
#pragma unroll
      for (int a = 0; a < G::HA; ++a)
#pragma unroll
        for (int i = 0; i < BW_R; ++i) acc[a][i] = 0.f;
    }
    const unsigned char* buf = ring + slot * G::STAGEB + warp * G::ROWB;
#pragma unroll
    for (int k = 0; k < BW_GT; ++k) {
      const int b = group * BW_GT + k;
      if (b < L) {
        float e[BW_R];
#pragma unroll
        for (int i = 0; i < BW_R; ++i)
          e[i] = Io<T>::ld(reinterpret_cast<const T*>(buf + 4 * i * G::ROWB + k * G::TAPB), cc);
        const float4* hb = sh4 + (b * BW_CB + cc) * LP4 + ah * (G::HA / 4);
#pragma unroll
        for (int a4 = 0; a4 < G::HA / 4; ++a4) {
          const float4 hv = hb[a4];
#pragma unroll
          for (int i = 0; i < BW_R; ++i) {
            acc[4 * a4][i] = fmaf(hv.x, e[i], acc[4 * a4][i]);
            acc[4 * a4 + 1][i] = fmaf(hv.y, e[i], acc[4 * a4 + 1][i]);
            acc[4 * a4 + 2][i] = fmaf(hv.z, e[i], acc[4 * a4 + 2][i]);
            acc[4 * a4 + 3][i] = fmaf(hv.w, e[i], acc[4 * a4 + 3][i]);
          }
        }
      }
    }
    slot = slot + 1 == G::NST ? 0 : slot + 1;
    if (++group == n_groups) {  // the step's sums are whole: round and store
      group = 0;
      const long tr = t0 + warp;
      const long idx = ((long)n * t_len + tr) * c_len + c0 + cc;
      const long stride = 4L * c_len;
#pragma unroll
      for (int a = 0; a < G::HA; ++a) {
        const int ag = ah * G::HA + a;
        if (ag < L) {
          T* dst = static_cast<T*>(outs.p[ag]);
          Store4<T>::st(dst, idx, stride, tr, t_end, cc, pair_mask, &acc[a][0]);
          Store4<T>::st(dst, idx + 4 * stride, stride, tr + 16, t_end, cc, pair_mask, &acc[a][4]);
        }
      }
      t0 += BW_STEP;
    }
  }
}

template <typename T, int LB>
cudaError_t launch_gram_bwd(const TapPtrs& taps, const OutPtrs& outs, const float* h, int L,
                            int B, int t_len, int c_len, int rows, cudaStream_t s) {
  using G = BwdGeom<T, LB>;
  const int smem = G::RINGB + L * BW_CB * G::LP * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(gram_bwd_kernel<T, LB>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(c_len / BW_CB, (t_len + rows - 1) / rows, B);
  gram_bwd_kernel<T, LB><<<grid, BW_NT, smem, s>>>(taps, outs, h, L, t_len, c_len, rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_gram_bwd(const TapPtrs& taps, const OutPtrs& outs, const float* h, int L,
                              int B, int t_len, int c_len, int rows, cudaStream_t s) {
  switch ((L + 7) / 8) {
    case 1: return launch_gram_bwd<T, 8>(taps, outs, h, L, B, t_len, c_len, rows, s);
    case 2: return launch_gram_bwd<T, 16>(taps, outs, h, L, B, t_len, c_len, rows, s);
    case 3: return launch_gram_bwd<T, 24>(taps, outs, h, L, B, t_len, c_len, rows, s);
    default: return launch_gram_bwd<T, 32>(taps, outs, h, L, B, t_len, c_len, rows, s);
  }
}

}  // namespace

extern "C" {

// taps: host array of L device pointers ([B, T, C], one dtype, 16-byte
// aligned). chunk: time rows per block. partial: [B, ceil(T / chunk),
// L (L + 1) / 2, C] float32 scratch; out: [B, L, L, C] float32. Returns
// cudaGetLastError().
int ast_pair_gram(const void* const* taps, int L, int B, int t_len, int c_len, int chunk,
                  int is_bf16, void* partial, void* out, void* stream) {
  if (L < 1 || L > MAXL || B < 1 || t_len < 1 || c_len % FW_CB != 0 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  TapPtrs ptrs = {};
  for (int i = 0; i < L; ++i) ptrs.p[i] = taps[i];
  float* pp = (float*)partial;
  cudaError_t e = is_bf16 ? dispatch_gram_fwd<__nv_bfloat16>(ptrs, L, B, t_len, c_len, chunk, pp, s)
                          : dispatch_gram_fwd<float>(ptrs, L, B, t_len, c_len, chunk, pp, s);
  if (e != cudaSuccess) return (int)e;
  const long total = (long)B * L * L * c_len;
  gram_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      pp, (float*)out, B, L, c_len, (t_len + chunk - 1) / chunk);
  return (int)cudaGetLastError();
}

// taps / outs: host arrays of L device pointers ([B, T, C], one dtype, 16-byte
// aligned); h: [B, L, L, C] float32; rows: time rows per block, a multiple
// of 32. Returns cudaGetLastError().
int ast_pair_gram_bwd(const void* const* taps, void* const* outs, int L, int B, int t_len,
                      int c_len, int rows, int is_bf16, const void* h, void* stream) {
  if (L < 1 || L > MAXL || B < 1 || t_len < 1 || c_len % BW_CB != 0 || rows < BW_STEP ||
      rows % BW_STEP != 0)
    return (int)cudaErrorInvalidValue;
  TapPtrs in = {};
  OutPtrs out = {};
  for (int i = 0; i < L; ++i) {
    in.p[i] = taps[i];
    out.p[i] = outs[i];
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const float* hp = (const float*)h;
  const cudaError_t e =
      is_bf16 ? dispatch_gram_bwd<__nv_bfloat16>(in, out, hp, L, B, t_len, c_len, rows, s)
              : dispatch_gram_bwd<float>(in, out, hp, L, B, t_len, c_len, rows, s);
  return (int)e;
}

}  // extern "C"
