// All-pairs channel gram: forward (K5) and backward (K6); the per-layer
// (Gatys) gram, K8f and K8b, at the end of the file. Per channel K5 and K6
// are small matrix products (L x L, depth T), but channel is the fastest
// axis in memory and every tap is an array of its own: the layout, not the
// arithmetic, is what the designs serve. bf16 taps take tensor-core kernels
// (gram_fwd_mma_kernel, gram_bwd_mma_kernel); float32 taps take float32 FMA
// kernels on the CUDA cores (gram_fwd_kernel, gram_bwd_kernel), since TF32
// is off in the port and float32 has no tensor-core route that keeps its
// numbers. Every figure in this note is for one NVIDIA H100 80GB HBM3 at a
// 700.00 W power limit (nvidia-smi --query-gpu=name,power.limit): 132 SMs,
// 3.35 TB/s, 989 TFLOP/s bf16.
//
// K5 replaces: audio_style_transfer_tpu/ops/pallas_gram.py::_fwd_kernel.
//   G[n, a, b, c] = sum_t E_a[n, t, c] * E_b[n, t, c]
// for L taps (each [B, T, C]), float32 products and sums, written as
// [B, L, L, C] float32.
// K6 replaces: audio_style_transfer_tpu/ops/pallas_gram.py::_bwd_kernel.
//   dE_a[n, t, c] = sum_b h[n, a, b, c] * E_b[n, t, c]
// for any float32 h (the gram's is g + g^T), summed in float32 and rounded
// once to the tap dtype.
//
// bf16: what bounds them (237568 rows, C = 128). At L = 30 K5 reads 1.82 GB
// of taps, 0.545 ms at 3.35 TB/s; its 465 pairs are 28.3 GFLOP, 0.03 ms on
// the tensor cores. K6 reads the taps and writes their cotangents, 3.65 GB,
// 1.089 ms; its products (h in two parts) are 109 GFLOP, 0.11 ms. So bytes
// bound both, with the tensor cores far behind. What the layout costs is
// the bytes' path: a block that reads 32 or 64 bytes of each (row, tap) line
// streams about 2.0-2.1 TB/s on an H100, one that reads whole 128-byte lines
// 2.9-3.1 TB/s (load-only benchmarks, 30 taps). The design, common to both:
//   - a block owns a group of 64 channels, the whole 128-byte line of each
//     (row, tap), and a run of rows; 512 threads, one block an SM; the
//     wrapper cuts T so that the grid is one wave (K5 at 237568 rows: 2
//     groups x 66 runs of 3616 rows). A last group narrower than 64 channels
//     is masked (K5 takes any C that is a multiple of 8);
//   - rows stream in 8 at a time as 16-byte cp.async pieces, 8 lanes a line,
//     into a ring of 4 stages (8 at L <= 16, whose stages are a third as
//     large), [row][tap][piece] with the pieces of a line XORed by the tap
//     (ring_at): the copies and the transpose's reads fall on distinct banks;
//   - a per-channel product needs (rows x taps) operands, so each stage is
//     transposed once in shared memory into [channel][row][tap], 16-byte
//     chunks of 8 taps, swizzled (tr_at): ldmatrix.trans reads a block of 8
//     taps x 8 channels of one row as its rows, stmatrix writes each
//     channel's 8 taps as a row; two instructions a warp for 512 bytes;
//   - K5: warp w owns channels 4 w .. 4 w + 3. One ldmatrix.trans of a
//     channel's 8 rows gives both operands of mma.sync.m16n8k8, A = E^T (16
//     taps x 8 rows) and B = E (8 rows x 8 taps), over the upper triangle of
//     (16-tap half, 8-tap block) tiles only: 6 at L <= 32, 2 at L <= 16, the
//     last block's tiles skipped at L <= 24 and L <= 8. The tensor cores'
//     accumulation cuts low bits, so each stage's products (8 rows) start
//     from zero and are added into a float32 sum rounded to nearest (K8f's
//     measure of the cut: 1.2e-4 low on the diagonal over 29696 rows kept in
//     the accumulator, 2e-7 flushed every 64; here 1.3e-7 of the float64
//     gram at 237568 rows). A block writes the partial sums of its run;
//     gram_reduce_kernel adds the runs in order and mirrors the triangle. No
//     atomics: the result repeats bit for bit;
//   - K6: dE^T = h E^T per 16 taps a, A = h of one channel in two bf16
//     parts, hi = bf16(h) and lo = bf16(h - hi) (hi + lo within 2^-18 of h),
//     staged once per block into registers; B = E^T (16 taps b x 8 rows) by
//     ldmatrix; both products into the same float32 accumulators, rounded
//     once to bf16 and written back in place by stmatrix.trans. Each channel
//     needs 32 registers of h at L > 16, so there two blocks share a group's
//     run of rows, each computing 32 of its channels (2 a warp) from whole
//     lines that the second reads from L2; at L <= 16 one block computes all
//     64 (4 a warp). The stage then goes out by all threads: a word (2 taps)
//     of 8 channels' chunks read from 32 banks, the axes swapped with byte
//     permutes, two 16-byte pieces stored, side by side along the line;
//   - one barrier a stage: between two, the block transposes stage s, each
//     warp multiplies stage s - 1 and (K6) every thread stores its part of
//     stage s - 2, each in a buffer of its own (K5 two transposed stages, K6
//     three).
// Shared memory a block: K5 192 KB at L > 16, 160 KB at L <= 16; K6 176 KB.
// Registers a thread (nvcc -Xptxas -v, no spills): gram_fwd_mma_kernel<2>
// 126, <1> 86; gram_bwd_mma_kernel<2> 116, <1> 96 (stage_tid keeps them so).
// Measured at 237568 rows (one H100, replayed CUDA graph, median of 20): K5
// 0.68 ms at L = 30 (80% of its bound), 0.28-0.33 ms at L = 10; K6 1.45-1.48
// ms at L = 30 (74%), 0.45-0.46 ms at L = 10 (79%).
// Tried and dropped, on the same card: blocks of 16 channels (32-byte
// pieces, 32-row stages) read at about 2.0 TB/s whatever the ring depth:
// K5 1.00 ms, K6 2.14 ms at L = 30; neither TMA boxes of 32 rows x 16
// channels (1.94 TB/s), the .L2::128B / 256B prefetch hints, bulk L2
// prefetches, nor clusters of 4 or 8 such blocks in lockstep (1.2-1.8
// TB/s) lifted that; a cluster of 4 sharing whole lines through
// distributed shared memory read at 0.88 TB/s. With whole lines: the ring
// laid out [row][piece][tap] put a warp's 32 copies on 4 banks (K5 1.97 ms,
// K6 4.11 ms); K5 split like K6 into two 32-channel blocks read each line
// twice (1.00 ms); K6 split by taps a instead of channels made both blocks
// transpose all 64 channels (1.78-2.1 ms).
// Route not taken: the channel-diagonal product straight off the ring
// (ldmatrix.trans of [row][tap][channel] makes (tap, channel) the M or N
// index, and only c = c' is kept). It does 8x the tensor-core work, and K5
// would hold 8x the accumulators (930 registers a thread for one warp's
// pairs at L = 30), K6 about 0.88 ms of products at peak against its 1.09
// ms of bytes. It was not built: the transposed stage costs two ldmatrix /
// stmatrix instructions a warp per 512 bytes.
//
// float32 (FMA), the designs before the tensor-core kernels, at T=16384:
// K5 reads 252 MB at L = 30, 75 us; the 465 pairs are 0.98 G float32 FMAs,
// about 30 us on the CUDA cores. An SM starts 128 FMAs but only 32
// shared-memory words a clock, so a word read from shared memory has to
// feed at least 4 FMAs:
//   - a thread owns one channel and an 8 x 8 tile of (tap a, tap b) pairs: 16
//     values read per time row for 64 FMAs (8 read on a diagonal tile). The
//     upper triangle of tiles is 10 tiles for L <= 32, 6 for L <= 24, 3 for
//     L <= 16 and 1 for L <= 8; the kernel is compiled for each, and every
//     warp of a block does the same work (no triangular imbalance);
//   - a block owns 8 channels (two 16-byte pieces of a float32 row) and a
//     run of time rows. A warp is 8 channels x 4 rows of one tile; RQ warps
//     a tile share the rows of a stage. The taps come in as 16-byte cp.async
//     into a ring of 4 stages of 32..128 rows, [row][tap][channel] with an
//     odd number of tap slots a row, so the 4 rows a warp reads at once fall
//     in distinct banks; loads of the next three stages run under the FMAs;
//   - the sum over T has a fixed order: ascending rows in a thread, a
//     shuffle tree over a warp's 4 rows, the block's warps in order through
//     shared memory, then the blocks' partial sums in order in
//     gram_reduce_kernel. The wrapper cuts T so that the grid is about one
//     block an SM (8 chunks of 2048 rows at C=128).
// K6 (float32): 504 MB at L = 30, 150 us; the L^2 = 900 FMAs per element
// are 1.89 G, about 64 us, which need every instruction slot. The registers
// a thread can give to sums (128) set how often a word of h or E is used
// again:
//   - a block owns 16 channels and a run of time rows, walked 32 at a time.
//     A warp is 16 channels x the two halves of the taps a at 8 rows; a
//     thread keeps (bucket / 2) x 8 sums in registers, so every word of h
//     feeds 8 FMAs and every word of E 4 to 16. The kernel is compiled for
//     L <= 8, 16, 24 and 32;
//   - h of the block's channels lives in shared memory as [b][channel][a],
//     a padded to an odd count of float4, read as float4 along a: one read
//     feeds 32 FMAs, and the lanes of a quarter-warp hit distinct banks. It
//     is staged once per block; the wrapper gives a block as many rows as
//     make the grid one wave of resident blocks;
//   - the taps come in as 16-byte cp.async, four taps b at a time, into a
//     ring of 4 stages, [row][tap][channel]. The sum over b is ascending,
//     fmaf; the cotangents are stored as 4-byte words in 64-byte runs;
//   - 128 threads a block; two blocks resident an SM for L > 16, four below.
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
// Registers a thread, float32 (nvcc -Xptxas -v, no spills), one block an
// SM: NG=1, 2, 3 116 (256, 384, 384 threads), NG=4 96 (640 threads, capped
// at 102).
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
// thread's channel, stored. `idx` is the element index of (row tr, own
// channel), `stride` that of 4 rows.
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
// Registers a thread, float32 (nvcc -Xptxas -v, no spills): LB=8 105,
// LB=16 119, LB=24 173, LB=32 186.
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

// ------------------------------------------------------- K5, K6 in bf16 ----

constexpr int PM_U = 8;     // 16-byte pieces a row and tap: 64 channels, a whole 128-byte line
constexpr int PM_NT = 512;  // 16 warps
constexpr int PM_SR = 8;    // rows a stage
constexpr int PM_NST1 = 8;  // stages of the cp.async ring at L <= 16 (10 KB a stage at L = 10)
constexpr int PM_NST2 = 4;  // and above (30 KB at L = 30)

// Geometry for NH halves of 16 taps (L <= 16 NH).
template <int NH>
struct PmGeom {
  static constexpr int NST = NH == 1 ? PM_NST1 : PM_NST2;
  static constexpr int NB = 16 * NH;                   // tap slots a row
  static constexpr int NJ = 2 * NH;                    // 16-byte chunks (8 taps) a transposed row
  static constexpr int RING_ROWB = NB * PM_U * 16;     // ring row: [tap][piece], ring_at
  static constexpr int RING_STAGEB = PM_SR * RING_ROWB;
  static constexpr int TR_AT = NST * RING_STAGEB;      // the transposed stages after the ring
};

// Byte offset of chunk j (taps 8 j .. 8 j + 7) of row `row` of channel `ch` in
// a transposed stage, [channel][row][chunk]. The chunk's slot in its 128-byte
// line is XORed by the row's place among the line's rows and by the channel,
// so that the 8 rows of one channel (ldmatrix, stmatrix in the products), 8
// consecutive channels of one row (stmatrix in the transpose) and 8 channels
// 8 apart (the reads of K6's stores) each fall on distinct banks.
template <int NJ>
__device__ __forceinline__ uint32_t tr_at(int ch, int row, int j) {
  const int q = (ch * PM_SR + row) * NJ + j;
  return (uint32_t)((q ^ (((row * NJ >> 3) & (NJ - 1)) ^ ((ch ^ (ch >> 3)) & 7))) << 4);
}

__device__ __forceinline__ void stmatrix4_trans(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

__device__ __forceinline__ void stmatrix4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// c[16x8] += a[16x8] b[8x8], bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma1688(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Byte offset of piece u (channels 8 u ..) of tap `tap` in a ring row: each
// (row, tap) is a 128-byte line, its pieces XORed by the tap, so that a
// line's 8 pieces (the copies) and one piece of 8 consecutive taps (the
// transpose's ldmatrix) each fall on distinct banks.
__device__ __forceinline__ uint32_t ring_at(int tap, int u) {
  return (uint32_t)((tap * PM_U + (u ^ (tap & 7))) << 4);
}

// Zero the ring's lines of the taps L .. NB - 1, which no copy writes: the
// transpose carries them into the products, where K6 multiplies them by the
// zeros of h.
template <int NH>
__device__ __forceinline__ void zero_ring_pad(uint8_t* ring, int L) {
  using G = PmGeom<NH>;
  const int pad = (G::NB - L) * PM_U;  // pieces a row
  for (int i = threadIdx.x; i < G::NST * PM_SR * pad; i += PM_NT)
    *reinterpret_cast<uint4*>(ring + (i / pad) * G::RING_ROWB + L * PM_U * 16 + (i % pad) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
}

// threadIdx.x, with kOpaque through an empty asm: the stage loop then
// recomputes the offsets that derive from it at each use instead of holding
// them, loop-invariant, in registers. Above 16 taps (K5's sums take 96
// registers, K6's h 64) the kernels spilled without it; at L <= 16 the
// recomputation costs time (K6 at L = 10: 0.452 -> 0.609 ms on an H100).
template <bool kOpaque>
__device__ __forceinline__ int stage_tid() {
  int t = threadIdx.x;
  if (kOpaque) asm volatile("" : "+r"(t));
  return t;
}

// Start the copies of rows [row0, row0 + SR) of the L taps into the ring
// stage at `dst`. Thread tid copies piece u = tid % 8 (channels c0 + 8 u ..)
// of row (tid / 8) % SR of the taps tid / 64 + 8 k, so 8 lanes fetch a (row,
// tap)'s whole 128-byte line. Rows at or past t_end and channels at or past
// c_len are zero-filled (from the stage's first row and channel c0, which
// exist).
template <int NH, bool kOpaque>
__device__ __forceinline__ void load_stage(uint32_t dst, const TapPtrs& taps, int L, long row0,
                                           long t_end, long base, int c_len, int c0) {
  using G = PmGeom<NH>;
  const int tid = stage_tid<kOpaque>();
  const int u = tid % PM_U, row = tid / PM_U % PM_SR, tap0 = tid / (PM_U * PM_SR);
  const long t = row0 + row;
  const bool in = t < t_end && c0 + 8 * u < c_len;
  const long off = ((base + (in ? t : row0)) * c_len + c0 + (in ? 8 * u : 0)) * 2;
  const uint32_t at = dst + row * G::RING_ROWB + ring_at(tap0, u);
#pragma unroll
  for (int k = 0; k < 4; ++k)  // ring_at(tap0 + 8 k, u) = ring_at(tap0, u) + 1024 k
    if (tap0 + 8 * k < L)
      cp_async16(at + 1024 * k, static_cast<const char*>(taps.p[tap0 + 8 * k]) + off, in ? 16 : 0);
}

// The 8 x 8 blocks (8 taps x 8 channels of one row) of pieces u0 .. u0 + UC - 1
// of the ring stage at `src`, transposed into `dst` (channel 8 (u - u0) + i):
// ldmatrix.trans reads a block's 8 pieces as its rows, stmatrix writes each
// channel's 8 taps as a row. Four blocks a warp and instruction.
template <int NH, int UC>
__device__ __forceinline__ void transpose_stage(uint32_t src, uint32_t dst, int u0, int warp,
                                                int lane) {
  using G = PmGeom<NH>;
  const int i = lane & 7;
#pragma unroll
  for (int m0 = warp * 4; m0 < PM_SR * UC * G::NJ; m0 += PM_NT / 8) {
    const int m = m0 + (lane >> 3);
    const int j = m % G::NJ, u = (m / G::NJ) % UC, r = m / (G::NJ * UC);
    uint32_t v[4];
    ldmatrix4_trans(v, src + r * G::RING_ROWB + ring_at(8 * j + i, u0 + u));
    stmatrix4(dst + tr_at<G::NJ>(8 * u + i, r, j), v);
  }
}

// R[c NJ + j]: chunk j (taps 8 j + g) of rows 2 t, 2 t + 1 of channel ch0 + c of
// the transposed stage at `buf`, NC channels (ldmatrix.trans: the A and B
// fragments of K5), or rows g of taps 8 j + 2 t, + 1 (ldmatrix: K6's B).
template <int NJ, int NC, bool kTrans>
__device__ __forceinline__ void load_chunks(uint32_t (&R)[NC * NJ], uint32_t buf, int ch0,
                                            int lane) {
#pragma unroll
  for (int p = 0; p < NC * NJ / 4; ++p) {
    const int k = 4 * p + (lane >> 3);
    uint32_t v[4];
    const uint32_t at = buf + tr_at<NJ>(ch0 + k / NJ, lane & 7, k % NJ);
    if (kTrans)
      ldmatrix4_trans(v, at);
    else
      ldmatrix4(v, at);
#pragma unroll
    for (int e = 0; e < 4; ++e) R[4 * p + e] = v[e];
  }
}

// Tile k of the upper triangle of (16-tap half mi, 8-tap block nj) tiles,
// nj >= 2 mi: (0, 0), (0, 1), (0, 2), (0, 3), (1, 2), (1, 3). K5 computes
// the first 2 (NH = 1) or all 6 (NH = 2).
__device__ __forceinline__ constexpr int pm_tile_mi(int k) { return k < 4 ? 0 : 1; }
__device__ __forceinline__ constexpr int pm_tile_nj(int k) { return k < 4 ? k : k - 2; }

// K5's products of one transposed stage (8 rows) for the warp's CPW channels
// from ch0: A = E^T (16 taps x 8 rows), B = E (8 rows x 8 taps), both
// fragments of one ldmatrix.trans, on mma.sync.m16n8k8. Each stage's sums
// are added into `sum`, rounded to nearest: the tensor cores' accumulation
// cuts low bits.
template <int NH, int CPW>
__device__ __forceinline__ void pair_fwd_products(float (&sum)[CPW][NH == 1 ? 2 : 6][4],
                                                  uint32_t buf, int ch0, int L, int lane) {
  // CS channels' chunks a load group: all four at NH = 1, one at NH = 2 (registers).
  constexpr int NT = NH == 1 ? 2 : 6, NJ = 2 * NH, CS = NH == 1 ? CPW : 4 / NJ;
#pragma unroll
  for (int q = 0; q < CPW / CS; ++q) {
    uint32_t R[CS * NJ];
    load_chunks<NJ, CS, true>(R, buf, ch0 + CS * q, lane);
#pragma unroll
    for (int c = 0; c < CS; ++c)
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        const int mi = pm_tile_mi(k), nj = pm_tile_nj(k);
        if (8 * nj < L) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          mma1688(acc, R[c * NJ + 2 * mi], R[c * NJ + 2 * mi + 1], R[c * NJ + nj]);
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[CS * q + c][k][e] += acc[e];
        }
      }
  }
}

// Grid (ceil(C / 64), chunks, B): block x owns channels 64 x .. + 64, 4 a
// warp. partial: [B, chunks, L (L + 1) / 2, C]. One barrier a stage:
// between two, the block transposes stage s and each warp multiplies stage
// s - 1, in buffers of their own.
template <int NH>
__global__ void __launch_bounds__(PM_NT, 1)
gram_fwd_mma_kernel(const __grid_constant__ TapPtrs taps, int L, int t_len, int c_len, int chunk,
                    float* __restrict__ partial) {
  using G = PmGeom<NH>;
  constexpr int NT = NH == 1 ? 2 : 6, CPW = 64 / (PM_NT / 32);
  constexpr int TRB = 64 * PM_SR * G::NJ * 16;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sbase = smem_addr(smem), tr = sbase + G::TR_AT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * 64, n = blockIdx.z;
  const long t0 = (long)blockIdx.y * chunk;
  const long t1 = min(t0 + (long)chunk, (long)t_len);
  const int n_stages = (int)((t1 - t0 + PM_SR - 1) / PM_SR);
  zero_ring_pad<NH>(smem, L);
  auto load = [&](int s) {
    if (s < n_stages)
      load_stage<NH, NH == 2>(sbase + (s % G::NST) * G::RING_STAGEB, taps, L,
                              t0 + (long)s * PM_SR, t1, (long)n * t_len, c_len, c0);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < G::NST - 1; ++s) load(s);

  float sum[CPW][NT][4];
#pragma unroll
  for (int c = 0; c < CPW; ++c)
#pragma unroll
    for (int k = 0; k < NT; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[c][k][e] = 0.f;
  for (int s = 0; s <= n_stages; ++s) {
    cp_async_wait<G::NST - 2>();  // stage s has landed (this thread's part)
    __syncthreads();              // everyone's; stage s - 1's ring slot and s - 2's buffer are free
    load(s + G::NST - 1);
    const int tid = stage_tid<NH == 2>();
    if (s > 0)
      pair_fwd_products<NH, CPW>(sum, tr + ((s - 1) & 1) * TRB, tid / 32 * CPW, L, tid % 32);
    if (s < n_stages)
      transpose_stage<NH, PM_U>(sbase + (s % G::NST) * G::RING_STAGEB, tr + (s & 1) * TRB, 0,
                                tid / 32, tid % 32);
  }
  cp_async_wait<0>();
  // Accumulator tile k: taps a = 16 mi + g (+ 8) by b = 8 nj + 2 t (+ 1).
  const int g = lane >> 2, t = lane & 3;
  const int n_pairs = L * (L + 1) / 2;
  float* dst = partial + ((long)n * gridDim.y + blockIdx.y) * n_pairs * c_len;
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
    const int ch = c0 + warp * CPW + c;
    if (ch >= c_len) break;  // the masked channels of a last, narrower group
#pragma unroll
    for (int k = 0; k < NT; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int a = 16 * pm_tile_mi(k) + g + 8 * (e >> 1);
        const int b = 8 * pm_tile_nj(k) + 2 * t + (e & 1);
        if (a <= b && b < L)
          dst[(long)(a * L - a * (a - 1) / 2 + b - a) * c_len + ch] = sum[c][k][e];
      }
  }
}

// K6's products of one transposed stage (8 rows) for the warp's CPW channels
// from ch0, in place: dE^T = h E^T per 16 taps a (m-tile mt), with A = h
// (16 taps a x 16 taps b) in two bf16 parts, hi then lo, from registers, and
// B = E^T (16 taps b x 8 rows) by ldmatrix; the float32 sums are rounded
// once to bf16 and written over the rows read, transposed by stmatrix.trans
// (chunk 2 mt + 1 holds taps a 16 mt + 8 ..). CS = 4 / NJ channels a step:
// one ldmatrix.x4 reads, one stmatrix.x4 writes their NJ chunks.
template <int NH, int CPW>
__device__ __forceinline__ void pair_bwd_products(uint32_t buf, int ch0,
                                                  const uint32_t (&hi)[CPW][NH][NH][4],
                                                  const uint32_t (&lo)[CPW][NH][NH][4], int lane) {
  constexpr int NJ = 2 * NH, CS = 4 / NJ;
#pragma unroll
  for (int q = 0; q < CPW / CS; ++q) {
    uint32_t R[CS * NJ];
    load_chunks<NJ, CS, false>(R, buf, ch0 + CS * q, lane);
    uint32_t v[4];
#pragma unroll
    for (int c = 0; c < CS; ++c)
#pragma unroll
      for (int mt = 0; mt < NH; ++mt) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < NH; ++kk) {
          mma16816(acc, hi[CS * q + c][mt][kk], R[c * NJ + 2 * kk], R[c * NJ + 2 * kk + 1]);
          mma16816(acc, lo[CS * q + c][mt][kk], R[c * NJ + 2 * kk], R[c * NJ + 2 * kk + 1]);
        }
        // acc: taps a 16 mt + g (+ 8) by rows 2 t, + 1; stmatrix.trans stores
        // the 8 x 8 blocks' columns, rows of 8 taps a.
        v[c * NJ + 2 * mt] = pack2(acc[0], acc[1]);
        v[c * NJ + 2 * mt + 1] = pack2(acc[2], acc[3]);
      }
    const int k = lane >> 3;
    stmatrix4_trans(buf + tr_at<NJ>(ch0 + CS * q + k / NJ, lane & 7, k % NJ), v);
  }
}

// The cotangents of rows [row0, row0 + SR) out of the transposed stage at
// `buf` (generic pointer, UC pieces of channels): thread (row r, chunk oj,
// piece u, word w) reads word w (taps a 8 oj + 2 w, + 1) of the 8 channels
// 8 u + i, swaps the two axes with byte permutes and stores the two taps'
// 16-byte pieces at channel c0 + 8 u. A warp (w, u, and 32 / (4 UC) rows)
// loads from 32 banks; UC lanes write a tap's UC pieces side by side.
template <int NH, int UC>
__device__ __forceinline__ void pair_store_stage(const OutPtrs& outs, const uint8_t* buf, int L,
                                                 long row0, long t_end, long base, int c_len,
                                                 int c0) {
  constexpr int NJ = 2 * NH;
  const int tid = stage_tid<NH == 2>();
  const int w = tid & 3, u = (tid >> 2) % UC, rest = tid / (4 * UC);
  const int r = rest % PM_SR, oj = rest / PM_SR, a = 8 * oj + 2 * w;
  const long t = row0 + r;
  if (t >= t_end || c0 + 8 * u >= c_len || a >= L) return;
  uint32_t x[8];  // channel 8 u + i: tap a in the low half, a + 1 in the high
#pragma unroll
  for (int i = 0; i < 8; ++i)
    x[i] = *reinterpret_cast<const uint32_t*>(buf + tr_at<NJ>(8 * u + i, r, oj) + 4 * w);
  const long off = (base + t) * c_len + c0 + 8 * u;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (a + k >= L) break;
    const uint32_t sel = k ? 0x7632u : 0x5410u;
    *reinterpret_cast<uint4*>(static_cast<bf16*>(outs.p[a + k]) + off) =
        make_uint4(__byte_perm(x[0], x[1], sel), __byte_perm(x[2], x[3], sel),
                   __byte_perm(x[4], x[5], sel), __byte_perm(x[6], x[7], sel));
  }
}

// Grid (ceil(C / 64) NH, ceil(T / rows), B). Block x loads the whole lines of
// channel group x / NH and, at NH = 2, computes its half x % 2 of them (32
// channels, 2 a warp, whose h fills 64 registers), the sibling reading the
// same lines from L2; at NH = 1 all 64 (4 a warp). One barrier a stage:
// between two, the block transposes its channels of stage s, each warp
// multiplies stage s - 1 in place and every thread stores its part of stage
// s - 2, in three buffers that rotate.
template <int NH>
__global__ void __launch_bounds__(PM_NT, 1)
gram_bwd_mma_kernel(const __grid_constant__ TapPtrs taps, const __grid_constant__ OutPtrs outs,
                    const float* __restrict__ h, int L, int t_len, int c_len, int rows) {
  using G = PmGeom<NH>;
  constexpr int NJ = G::NJ, TC = 64 / NH, UC = TC / 8, CPW = TC / (PM_NT / 32);
  constexpr int TRB = TC * PM_SR * NJ * 16;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sbase = smem_addr(smem), tr = sbase + G::TR_AT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.x / NH * 64, u0 = blockIdx.x % NH * UC, n = blockIdx.z;
  const long t_begin = (long)blockIdx.y * rows;
  const long t_end = min(t_begin + (long)rows, (long)t_len);
  const int n_stages = (int)((t_end - t_begin + PM_SR - 1) / PM_SR);
  const long base = (long)n * t_len;
  zero_ring_pad<NH>(smem, L);
  auto load = [&](int s) {
    if (s < n_stages)
      load_stage<NH, NH == 2>(sbase + (s % G::NST) * G::RING_STAGEB, taps, L,
                              t_begin + (long)s * PM_SR, t_end, base, c_len, c0);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < G::NST - 1; ++s) load(s);

  // A[m][k] = h[n, a, b, c] for a = 16 mt + m, b = 16 kk + k, of the warp's
  // channels: a0..a3 hold (a g, b 2 t, + 1), (a g + 8, ...), (a g, b 2 t + 8,
  // + 9), (a g + 8, ...); hi = bf16(h), lo = bf16(h - hi), so hi + lo is
  // within 2^-18 of h.
  uint32_t hi[CPW][NH][NH][4], lo[CPW][NH][NH][4];
  {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int c = 0; c < CPW; ++c) {
      const int ch = c0 + 8 * u0 + warp * CPW + c;
      const float* hc = h + (long)n * L * L * c_len + ch;
#pragma unroll
      for (int mt = 0; mt < NH; ++mt)
#pragma unroll
        for (int kk = 0; kk < NH; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int a = 16 * mt + g + 8 * (e & 1), b = 16 * kk + 2 * t + 8 * (e >> 1);
            const bool in = ch < c_len && a < L;
            const float v0 = in && b < L ? hc[((long)a * L + b) * c_len] : 0.f;
            const float v1 = in && b + 1 < L ? hc[((long)a * L + b + 1) * c_len] : 0.f;
            hi[c][mt][kk][e] = pack2(v0, v1);
            lo[c][mt][kk][e] = pack2(v0 - bf_lo(hi[c][mt][kk][e]), v1 - bf_hi(hi[c][mt][kk][e]));
          }
    }
  }
  for (int s = 0; s < n_stages + 2; ++s) {
    cp_async_wait<G::NST - 2>();  // stage s has landed (this thread's part)
    __syncthreads();  // everyone's; the ring slot of s - 1 and the buffer of s - 3 are free
    load(s + G::NST - 1);
    if (s >= 2)
      pair_store_stage<NH, UC>(outs, smem + G::TR_AT + ((s - 2) % 3) * TRB, L,
                               t_begin + (long)(s - 2) * PM_SR, t_end, base, c_len, c0 + 8 * u0);
    const int tid = stage_tid<NH == 2>();
    if (s >= 1 && s <= n_stages)
      pair_bwd_products<NH, CPW>(tr + ((s - 1) % 3) * TRB, tid / 32 * CPW, hi, lo, tid % 32);
    if (s < n_stages)
      transpose_stage<NH, UC>(sbase + (s % G::NST) * G::RING_STAGEB, tr + (s % 3) * TRB, u0,
                              tid / 32, tid % 32);
  }
  cp_async_wait<0>();
}

template <int NH>
cudaError_t launch_gram_fwd_mma(const TapPtrs& taps, int L, int B, int t_len, int c_len,
                                int chunk, float* partial, cudaStream_t s) {
  using G = PmGeom<NH>;
  constexpr int smem = G::TR_AT + 2 * 64 * PM_SR * G::NJ * 16;
  cudaError_t e = cudaFuncSetAttribute(gram_fwd_mma_kernel<NH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((c_len + 63) / 64, (t_len + chunk - 1) / chunk, B);
  gram_fwd_mma_kernel<NH><<<grid, PM_NT, smem, s>>>(taps, L, t_len, c_len, chunk, partial);
  return cudaGetLastError();
}

template <int NH>
cudaError_t launch_gram_bwd_mma(const TapPtrs& taps, const OutPtrs& outs, const float* h, int L,
                                int B, int t_len, int c_len, int rows, cudaStream_t s) {
  using G = PmGeom<NH>;
  constexpr int smem = G::TR_AT + 3 * (64 / NH) * PM_SR * G::NJ * 16;
  cudaError_t e = cudaFuncSetAttribute(gram_bwd_mma_kernel<NH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((c_len + 63) / 64 * NH, (t_len + rows - 1) / rows, B);
  gram_bwd_mma_kernel<NH><<<grid, PM_NT, smem, s>>>(taps, outs, h, L, t_len, c_len, rows);
  return cudaGetLastError();
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

// K5. taps: host array of L device pointers ([B, T, C], one dtype, 16-byte
// aligned): float32 runs gram_fwd_kernel, bf16 (is_bf16) gram_fwd_mma_kernel.
// chunk: time rows per block. partial: [B, ceil(T / chunk), L (L + 1) / 2, C]
// float32 scratch; out: [B, L, L, C] float32. Returns cudaGetLastError().
int ast_pair_gram(const void* const* taps, int L, int B, int t_len, int c_len, int chunk,
                  int is_bf16, void* partial, void* out, void* stream) {
  if (L < 1 || L > MAXL || B < 1 || t_len < 1 || c_len % FW_CB != 0 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  TapPtrs ptrs = {};
  for (int i = 0; i < L; ++i) ptrs.p[i] = taps[i];
  float* pp = (float*)partial;
  cudaError_t e =
      !is_bf16  ? dispatch_gram_fwd<float>(ptrs, L, B, t_len, c_len, chunk, pp, s)
      : L <= 16 ? launch_gram_fwd_mma<1>(ptrs, L, B, t_len, c_len, chunk, pp, s)
                : launch_gram_fwd_mma<2>(ptrs, L, B, t_len, c_len, chunk, pp, s);
  if (e != cudaSuccess) return (int)e;
  const long total = (long)B * L * L * c_len;
  gram_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      pp, (float*)out, B, L, c_len, (t_len + chunk - 1) / chunk);
  return (int)cudaGetLastError();
}

// K6. taps / outs: host arrays of L device pointers ([B, T, C], one dtype,
// 16-byte aligned): float32 runs gram_bwd_kernel, bf16 (is_bf16)
// gram_bwd_mma_kernel. h: [B, L, L, C] float32; rows: time rows per block, a
// multiple of 32. Returns cudaGetLastError().
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
      !is_bf16  ? dispatch_gram_bwd<float>(in, out, hp, L, B, t_len, c_len, rows, s)
      : L <= 16 ? launch_gram_bwd_mma<1>(in, out, hp, L, B, t_len, c_len, rows, s)
                : launch_gram_bwd_mma<2>(in, out, hp, L, B, t_len, c_len, rows, s);
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
