// All-pairs channel gram: forward (K5) and backward (K6), float32 FMAs on the
// CUDA cores; the per-layer (Gatys) gram, K8f and K8b, at the end of the
// file. Per channel K5 and K6 are tiny matrix products (L x L, depth T), but
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

#include "mma_tiles.h"

namespace {

constexpr int MAXL = 32;  // taps per launch

struct TapPtrs {
  const void* p[MAXL];
};

struct OutPtrs {
  void* p[MAXL];
};

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


// ------------------------------------------------------------ K8f, K8b ------
//
// The per-layer (Gatys) gram. K8f and K8b replace no TPU kernel: the JAX
// package leaves this gram to XLA (transfer/grams.py, a bf16 x bf16 einsum
// with float32 accumulation). The port's plain route concatenated the taps,
// cast them to float32 and ran float32 products on the CUDA cores (TF32 off),
// which at the full stack of a 15 s clip was most of an evaluation's device
// work. For each tap X_l ([T, C], C = 128, the encoder's width):
//   K8f: G_l = X_l^T X_l, [C, C] float32
//   K8b: dX_l = X_l (dG_l^T + dG_l), float32 sums rounded once to the tap dtype
//
// What bounds them (bf16, 237568 rows, L = 30): K8f reads the taps once, 1.82
// GB, 0.545 ms at 3.35 TB/s; its products are 233 GFLOP (117 for the upper
// triangle), 0.12-0.24 ms at 989 TFLOP/s. K8b reads the taps and writes their
// cotangents, 3.65 GB, 1.09 ms; its two products (X hi and X lo, the bf16 parts
// of dG + dG^T, instead of one product of dG + dG^T rounded to bf16) are 467
// GFLOP, 0.47 ms. Bytes bound both,
// with the tensor cores close behind, so neither may read a byte twice from
// memory.
// Design (bf16):
//  - K8f: a block owns one tap and a chunk of rows; the wrapper cuts T so that
//    the grid is about one wave of two blocks an SM (8 chunks a tap at L=30).
//    Its 10 warps own the 10 upper 32 x 32 tiles of the 4 x 4 tiles of the
//    gram (the lower 6 are their mirror): 2 x 4 accumulator tiles of
//    mma.sync.m16n8k16, 32 registers a thread. Rows stream in as 16-byte
//    cp.async into a ring of 4 stages of 64 rows, [row][channel] with the
//    16-byte chunks swizzled by row (mma_tiles.h); both operands, A = X^T and
//    B = X, are read from the same stage with ldmatrix.trans. The tensor
//    cores' accumulation cuts low bits, so each stage's products are added
//    into a float32 sum rounded to nearest (32 registers more): on an H100 a
//    sum of 29696 rows kept in the accumulator alone came out 1.2e-4 low on
//    the diagonal, flushed every 4 k-steps 2e-7 (against float64). A
//    block writes the partial sums of its upper tiles ([L, chunks, C, C]
//    float32, 15.7 MB at L=30); gram_layer_sum_kernel adds the chunks in
//    order and mirrors the lower tiles. No atomics: the result repeats bit
//    for bit.
//  - K8b computes dX_l^T = (dG_l + dG_l^T) X_l^T, the channels as the
//    product's rows, so that X, the large operand, is read from shared memory
//    once a warp as B, and dG in both orientations is the A fragments. Each
//    of 8 warps owns 16 output channels by a tile's 128 rows: 16 accumulator
//    tiles, 64 registers a thread. A block walks a contiguous run of the L x
//    ceil(T / 128) (tap, tile) pairs, so the grid is one block an SM whatever
//    L and T; tiles stream in two ahead (3 buffers of 32 KB). At each new tap
//    the hi and lo bf16 parts of H = dG + dG^T are staged (stage_operands):
//    H is summed in float32 and symmetric, hi + lo is within 2^-18 of it, far
//    below the cotangents' one rounding to bf16 (2^-9). Two products a tile,
//    hi read as A and lo, transposed on load, as A (the same matrix). The
//    float32 sums are rounded once, written back
//    transposed into the tile's buffer with stmatrix.trans, and stored as
//    16-byte pieces of whole rows.
// float32 taps take FMA kernels on the same grids (gram_layer_fwd_fma_kernel,
// gram_layer_bwd_fma_kernel): a thread owns an 8 x 8 tile of the output and
// reads 16 float4 from shared memory for 256 FMAs; K8b's H = dG + dG^T is
// summed in float32 once a tap.

// Registers a thread (nvcc -Xptxas -v, sm_90a, no spills): gram_layer_fwd_kernel
// 96, gram_layer_fwd_fma_kernel 114, gram_layer_sum_kernel 30,
// gram_layer_bwd_kernel 137, gram_layer_bwd_fma_kernel 168.
constexpr int GL_TILE = 32;  // K8f: a warp's tile of channels a by channels b

// K8f, bf16.
constexpr int LF_NT = 320;   // 10 warps: the upper 32 x 32 tiles
constexpr int LF_SR = 64;    // rows per stage; a block's rows are a multiple of it
constexpr int LF_NST = 4;    // stages of the cp.async ring
constexpr int LF_STAGEB = LF_SR * ROWB;
constexpr int LF_SMEM = LF_NST * LF_STAGEB;  // 64 KB

// K8f, float32.
constexpr int FF_NT = 256;   // 16 x 16 threads, an 8 x 8 tile of the gram each
constexpr int FF_SR = 32;
constexpr int FF_NST = 4;
constexpr int FROWB = C * 4;  // bytes of one float32 row
constexpr int FF_STAGEB = FF_SR * FROWB;
constexpr int FF_SMEM = FF_NST * FF_STAGEB;  // 64 KB

// K8b.
constexpr int LB_NT = 256;   // 8 warps (bf16) or 16 x 16 threads (float32)
constexpr int LB_TN = 128;   // rows per tile
constexpr int LB_NB = 3;     // bf16 tile buffers: two tiles stream in under one
constexpr int LB_TILEB = LB_TN * ROWB;
constexpr int LB_SMEM = 2 * WBYTES + LB_NB * LB_TILEB;  // 160 KB: 2 operands, 3 tiles
constexpr int FB_NB = 2;     // float32 tile buffers
constexpr int FB_TILEB = LB_TN * FROWB;
constexpr int FB_SMEM = C * FROWB + FB_NB * FB_TILEB;   // 192 KB

__device__ __forceinline__ void stmatrix4_trans(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// Channels 4q..4q+3 and 64+4q..64+4q+3 of a float32 row: a thread's 8.
__device__ __forceinline__ void ld8(const float* row, int q, float (&v)[8]) {
  const float4 lo = reinterpret_cast<const float4*>(row)[q];
  const float4 hi = reinterpret_cast<const float4*>(row)[q + C / 8];
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

// Start the copies of rows [r0, r0 + n) of a [t_len, C] tap into buffer rows
// [0, n) (bf16: 256-byte rows, chunks swizzled; float32: plain 512-byte
// rows); rows at or past `end` are zero-filled.
template <int kThreads, typename T>
__device__ __forceinline__ void stage_tap_rows(uint32_t dst, const T* __restrict__ x, long r0,
                                               int n, long end) {
  constexpr int P = C * (int)sizeof(T) / 16;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < n * P; i += kThreads) {
    const int row = i / P, piece = i % P;
    const bool in = r0 + row < end;
    const uint32_t at =
        sizeof(T) == 2 ? chunk_at(row, piece) : (uint32_t)(row * FROWB + piece * 16);
    cp_async16(dst + at, x + (in ? r0 + row : 0) * C + piece * (16 / (int)sizeof(T)), in ? 16 : 0);
  }
}

// Grid (chunks, L). partial: [L, chunks, C, C] float32; the upper tiles are written.
__global__ void __launch_bounds__(LF_NT, 2)
gram_layer_fwd_kernel(const __grid_constant__ TapPtrs taps, int t_len, int chunk,
                      float* __restrict__ partial) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sbase = smem_addr(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = lane & 7, mat = lane >> 3;
  int ti, tj;
  tile_groups(warp, C / GL_TILE, ti, tj);
  const bf16* x = static_cast<const bf16*>(taps.p[blockIdx.y]);
  const long t0 = (long)blockIdx.x * chunk;
  const long t1 = min(t0 + (long)chunk, (long)t_len);
  const int n_stages = (int)((t1 - t0 + LF_SR - 1) / LF_SR);
  auto load = [&](int s) {
    if (s < n_stages)
      stage_tap_rows<LF_NT>(sbase + (s % LF_NST) * LF_STAGEB, x, t0 + (long)s * LF_SR, LF_SR, t1);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < LF_NST - 1; ++s) load(s);

  // The tensor cores add into acc with low bits cut, a bias that grows with
  // the chunk's length: acc holds one stage (64 rows) and is added into sum,
  // rounded to nearest.
  float acc[2][4][4], sum[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[mi][n][e] = 0.f;

  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<LF_NST - 2>();  // stage s has landed (this thread's part)
    __syncthreads();              // everyone's part; stage s - 1 is free
    load(s + LF_NST - 1);
    const uint32_t buf = sbase + (s % LF_NST) * LF_STAGEB;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < LF_SR / 16; ++kk) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // A[m][k] = X[k][m]: stage rows k, 16 channels m of tile ti, transposed
        // on load: matrices (m lo, k lo), (m hi, k lo), (m lo, k hi), (m hi, k hi).
        ldmatrix4_trans(a[h], buf + chunk_at(kk * 16 + r + (mat >> 1) * 8,
                                              ti * 4 + h * 2 + (mat & 1)));
        // B[k][n] = X[k][n]: 16 channels n of tile tj, as mma_kstep reads W[k][n].
        ldmatrix4_trans(b[h], buf + chunk_at(kk * 16 + r + (mat & 1) * 8,
                                              tj * 4 + h * 2 + (mat >> 1)));
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          mma16816(acc[mi][2 * nj], a[mi], b[nj][0], b[nj][1]);
          mma16816(acc[mi][2 * nj + 1], a[mi], b[nj][2], b[nj][3]);
        }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[mi][n][e] += acc[mi][n][e];
  }
  cp_async_wait<0>();
  const int g = lane >> 2, t = lane & 3;
  float* dst = partial + ((long)blockIdx.y * gridDim.x + blockIdx.x) * C * C;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int row = ti * GL_TILE + mi * 16 + g, col = tj * GL_TILE + n * 8 + 2 * t;
      *reinterpret_cast<float2*>(dst + row * C + col) = make_float2(sum[mi][n][0], sum[mi][n][1]);
      *reinterpret_cast<float2*>(dst + (row + 8) * C + col) =
          make_float2(sum[mi][n][2], sum[mi][n][3]);
    }
}

// The float32 K8f: the same grid and partial sums, every tile computed.
__global__ void __launch_bounds__(FF_NT, 2)
gram_layer_fwd_fma_kernel(const __grid_constant__ TapPtrs taps, int t_len, int chunk,
                          float* __restrict__ partial) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t sbase = smem_addr(smem);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* x = static_cast<const float*>(taps.p[blockIdx.y]);
  const long t0 = (long)blockIdx.x * chunk;
  const long t1 = min(t0 + (long)chunk, (long)t_len);
  const int n_stages = (int)((t1 - t0 + FF_SR - 1) / FF_SR);
  auto load = [&](int s) {
    if (s < n_stages)
      stage_tap_rows<FF_NT>(sbase + (s % FF_NST) * FF_STAGEB, x, t0 + (long)s * FF_SR, FF_SR, t1);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < FF_NST - 1; ++s) load(s);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<FF_NST - 2>();
    __syncthreads();
    load(s + FF_NST - 1);
    const float* buf = reinterpret_cast<const float*>(smem + (s % FF_NST) * FF_STAGEB);
    for (int rr = 0; rr < FF_SR; ++rr) {
      float a[8], b[8];
      ld8(buf + rr * C, ty, a);
      ld8(buf + rr * C, tx, b);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  float* dst = partial + ((long)blockIdx.y * gridDim.x + blockIdx.x) * C * C;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = dst + (long)(i < 4 ? 4 * ty + i : C / 2 + 4 * ty + i - 4) * C;
    reinterpret_cast<float4*>(row)[tx] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    reinterpret_cast<float4*>(row)[tx + C / 8] =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// out[l, a, b] = the chunks' partial sums in order; an element of a tile below
// the diagonal reads its mirror.
__global__ void gram_layer_sum_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                      int L, int n_chunks) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)L * C * C) return;
  const int b = idx % C, a = (idx / C) % C;
  const long l = idx / (C * C);
  const long at = a / GL_TILE > b / GL_TILE ? (long)b * C + a : (long)a * C + b;
  float sum = 0.f;
  for (int k = 0; k < n_chunks; ++k) sum += partial[(l * n_chunks + k) * C * C + at];
  out[idx] = sum;
}

// The two A operands of one tap's products, bf16 in shared memory ([a][b],
// swizzled): s1 = hi = bf16(H) and s2 = lo = bf16(H - hi) of H = dG + dG^T,
// summed in float32 (so bit for bit symmetric); hi + lo is within 2^-18 of H.
// The barrier before the first tile's products publishes them.
__device__ __forceinline__ void stage_operands(uint8_t* s1, uint8_t* s2,
                                               const float* __restrict__ g) {
  for (int p = threadIdx.x; p < C * C / 4; p += LB_NT) {
    const float4 v = reinterpret_cast<const float4*>(g)[p];
    const int a = p / (C / 4), b = (p % (C / 4)) * 4;
    const float h[4] = {v.x + g[b * C + a], v.y + g[(b + 1) * C + a], v.z + g[(b + 2) * C + a],
                        v.w + g[(b + 3) * C + a]};
    const uint2 hi = make_uint2(pack2(h[0], h[1]), pack2(h[2], h[3]));
    const uint2 lo = make_uint2(pack2(h[0] - bf_lo(hi.x), h[1] - bf_hi(hi.x)),
                                pack2(h[2] - bf_lo(hi.y), h[3] - bf_hi(hi.y)));
    const uint32_t off = chunk_at(a, b / 8) + (b % 8) * 2;
    *reinterpret_cast<uint2*>(s1 + off) = hi;
    *reinterpret_cast<uint2*>(s2 + off) = lo;
  }
}

// acc[n tile] += A B over k-chunk kk for A = a and A = at (16 channels m),
// B[k][n] = X[n][k] of the tile's 128 rows n (mma_kstep's transposed form).
__device__ __forceinline__ void bwd_products(float (&acc)[16][4], const uint32_t (&a)[4],
                                             const uint32_t (&at)[4], uint32_t buf, int kk,
                                             int lane) {
  const int r = lane & 7, mat = lane >> 3;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    uint32_t b[4];
    ldmatrix4(b, buf + chunk_at(jj * 16 + r + (mat >> 1) * 8, kk * 2 + (mat & 1)));
    mma16816(acc[2 * jj], a, b[0], b[1]);
    mma16816(acc[2 * jj], at, b[0], b[1]);
    mma16816(acc[2 * jj + 1], a, b[2], b[3]);
    mma16816(acc[2 * jj + 1], at, b[2], b[3]);
  }
}

// Grid (blocks). Block k walks the (tap, tile) pairs [k per, (k + 1) per) of
// the L x ceil(T / 128) in order: tap-major, tiles ascending.
__global__ void __launch_bounds__(LB_NT, 1)
gram_layer_bwd_kernel(const __grid_constant__ TapPtrs taps, const __grid_constant__ OutPtrs outs,
                      const float* __restrict__ dg, int L, int t_len, int per) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* s1 = smem;
  uint8_t* s2 = smem + WBYTES;
  uint8_t* tiles = smem + 2 * WBYTES;
  const uint32_t s1_s = smem_addr(s1), s2_s = smem_addr(s2), tiles_s = smem_addr(tiles);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = lane & 7, mat = lane >> 3;
  const int n_tiles = (t_len + LB_TN - 1) / LB_TN;
  const long first = (long)blockIdx.x * per;
  const int count = (int)min((long)per, (long)L * n_tiles - first);
  auto load = [&](int i) {
    if (i < count) {
      const long pair = first + i;
      stage_tap_rows<LB_NT>(tiles_s + (i % LB_NB) * LB_TILEB,
                            static_cast<const bf16*>(taps.p[pair / n_tiles]),
                            (pair % n_tiles) * LB_TN, LB_TN, t_len);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < LB_NB - 1; ++i) load(i);

  for (int i = 0; i < count; ++i) {
    const long pair = first + i;
    const int l = (int)(pair / n_tiles);
    const long r0 = (pair % n_tiles) * LB_TN;
    // A new tap: every warp is past the last tile's products (two barriers).
    if (i == 0 || r0 == 0) stage_operands(s1, s2, dg + (long)l * C * C);
    cp_async_wait<LB_NB - 2>();  // tile i has landed (this thread's part)
    __syncthreads();             // everyone's part; tile i - 1's buffer is free
    load(i + LB_NB - 1);
    const uint32_t buf = tiles_s + (i % LB_NB) * LB_TILEB;
    float acc[16][4];
    zero(acc);
#pragma unroll 1
    for (int kk = 0; kk < C / 16; ++kk) {
      uint32_t a[4], at[4];
      load_a_frag(a, s1_s, warp * 16, kk, lane);  // A[m][k] = s1[m][k]
      // A[m][k] = s2[k][m]: rows k, the warp's 16 channels m, transposed on load.
      ldmatrix4_trans(at, s2_s + chunk_at(kk * 16 + r + (mat >> 1) * 8, warp * 2 + (mat & 1)));
      bwd_products(acc, a, at, buf, kk, lane);
    }
    __syncthreads();  // every warp has read the tile: its buffer takes the result
    // Rounded once; accumulator tile 2 jj (+1) is channels g, g + 8 by rows
    // 16 jj + 2 t, + 1 (+ 8), stored transposed as rows of 8 channels.
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const uint32_t v[4] = {pack2(acc[2 * jj][0], acc[2 * jj][1]),
                             pack2(acc[2 * jj][2], acc[2 * jj][3]),
                             pack2(acc[2 * jj + 1][0], acc[2 * jj + 1][1]),
                             pack2(acc[2 * jj + 1][2], acc[2 * jj + 1][3])};
      stmatrix4_trans(buf + chunk_at(jj * 16 + (mat >> 1) * 8 + r, warp * 2 + (mat & 1)), v);
    }
    __syncthreads();
    bf16* dx = static_cast<bf16*>(outs.p[l]);
    const uint8_t* src = tiles + (i % LB_NB) * LB_TILEB;
    for (int p = threadIdx.x; p < LB_TN * 16; p += LB_NT) {
      const long t = r0 + (p >> 4);
      if (t < t_len)
        *reinterpret_cast<uint4*>(dx + t * C + (p & 15) * 8) =
            *reinterpret_cast<const uint4*>(src + chunk_at(p >> 4, p & 15));
    }
  }
  cp_async_wait<0>();
}

// The float32 K8b: the same walk; H = dG + dG^T in shared memory, a thread's
// 8 rows x 8 channels of a tile from 16 float4 reads a step of 4 channels k.
__global__ void __launch_bounds__(LB_NT, 1)
gram_layer_bwd_fma_kernel(const __grid_constant__ TapPtrs taps,
                          const __grid_constant__ OutPtrs outs, const float* __restrict__ dg,
                          int L, int t_len, int per) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* h = reinterpret_cast<float*>(smem);  // [k][c]
  const uint32_t tiles_s = smem_addr(smem + C * FROWB);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int n_tiles = (t_len + LB_TN - 1) / LB_TN;
  const long first = (long)blockIdx.x * per;
  const int count = (int)min((long)per, (long)L * n_tiles - first);
  auto load = [&](int i) {
    if (i < count) {
      const long pair = first + i;
      stage_tap_rows<LB_NT>(tiles_s + (i % FB_NB) * FB_TILEB,
                            static_cast<const float*>(taps.p[pair / n_tiles]),
                            (pair % n_tiles) * LB_TN, LB_TN, t_len);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < FB_NB - 1; ++i) load(i);

  for (int i = 0; i < count; ++i) {
    const long pair = first + i;
    const int l = (int)(pair / n_tiles);
    const long r0 = (pair % n_tiles) * LB_TN;
    if (i == 0 || r0 == 0) {
      __syncthreads();  // every thread is past the last tile's products
      const float* g = dg + (long)l * C * C;
      for (int p = threadIdx.x; p < C * C; p += LB_NT) h[p] = g[p] + g[(p % C) * C + p / C];
    }
    cp_async_wait<FB_NB - 2>();
    __syncthreads();
    load(i + FB_NB - 1);
    const float* buf = reinterpret_cast<const float*>(smem + C * FROWB + (i % FB_NB) * FB_TILEB);
    float acc[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[a][j] = 0.f;
    for (int k = 0; k < C; k += 4) {
      float4 xv[8];
#pragma unroll
      for (int a = 0; a < 8; ++a)
        xv[a] = *reinterpret_cast<const float4*>(buf + (ty * 8 + a) * C + k);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float hv[8];
        ld8(h + (k + q) * C, tx, hv);
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const float xs = q == 0 ? xv[a].x : q == 1 ? xv[a].y : q == 2 ? xv[a].z : xv[a].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[a][j] = fmaf(xs, hv[j], acc[a][j]);
        }
      }
    }
    float* dx = static_cast<float*>(outs.p[l]);
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const long t = r0 + ty * 8 + a;
      if (t < t_len) {
        float4* row = reinterpret_cast<float4*>(dx + t * C);
        row[tx] = make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
        row[tx + C / 8] = make_float4(acc[a][4], acc[a][5], acc[a][6], acc[a][7]);
      }
    }
  }
  cp_async_wait<0>();
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

// The per-layer gram K8f. taps: host array of L device pointers ([T, C = 128],
// one dtype, 16-byte aligned); chunk: rows per block, a multiple of 64;
// partial: [L, ceil(T / chunk), C, C] float32 scratch; out: [L, C, C] float32.
// Returns cudaGetLastError().
int ast_layer_gram(const void* const* taps, int L, int t_len, int chunk, int is_bf16,
                   void* partial, void* out, void* stream) {
  if (L < 1 || L > MAXL || t_len < 1 || chunk < LF_SR || chunk % LF_SR != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  TapPtrs ptrs = {};
  for (int i = 0; i < L; ++i) ptrs.p[i] = taps[i];
  const int chunks = (t_len + chunk - 1) / chunk;
  const dim3 grid(chunks, L);
  float* pp = (float*)partial;
  cudaError_t e;
  if (is_bf16) {
    e = cudaFuncSetAttribute(gram_layer_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             LF_SMEM);
    if (e != cudaSuccess) return (int)e;
    gram_layer_fwd_kernel<<<grid, LF_NT, LF_SMEM, s>>>(ptrs, t_len, chunk, pp);
  } else {
    e = cudaFuncSetAttribute(gram_layer_fwd_fma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, FF_SMEM);
    if (e != cudaSuccess) return (int)e;
    gram_layer_fwd_fma_kernel<<<grid, FF_NT, FF_SMEM, s>>>(ptrs, t_len, chunk, pp);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long total = (long)L * C * C;
  gram_layer_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(pp, (float*)out, L,
                                                                         chunks);
  return (int)cudaGetLastError();
}

// The per-layer gram's backward K8b. taps / outs: host arrays of L device
// pointers ([T, C = 128], one dtype, 16-byte aligned); dg: [L, C, C] float32;
// per: (tap, 128-row tile) pairs a block. Returns cudaGetLastError().
int ast_layer_gram_bwd(const void* const* taps, void* const* outs, int L, int t_len, int per,
                       int is_bf16, const void* dg, void* stream) {
  if (L < 1 || L > MAXL || t_len < 1 || per < 1) return (int)cudaErrorInvalidValue;
  TapPtrs in = {};
  OutPtrs out = {};
  for (int i = 0; i < L; ++i) {
    in.p[i] = taps[i];
    out.p[i] = outs[i];
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const long pairs = (long)L * ((t_len + LB_TN - 1) / LB_TN);
  const unsigned blocks = (unsigned)((pairs + per - 1) / per);
  const float* g = (const float*)dg;
  cudaError_t e;
  if (is_bf16) {
    e = cudaFuncSetAttribute(gram_layer_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             LB_SMEM);
    if (e != cudaSuccess) return (int)e;
    gram_layer_bwd_kernel<<<blocks, LB_NT, LB_SMEM, s>>>(in, out, g, L, t_len, per);
  } else {
    e = cudaFuncSetAttribute(gram_layer_bwd_fma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, FB_SMEM);
    if (e != cudaSuccess) return (int)e;
    gram_layer_bwd_fma_kernel<<<blocks, LB_NT, FB_SMEM, s>>>(in, out, g, L, t_len, per);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
