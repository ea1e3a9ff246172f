// Encoder trunk kernels for bfloat16 on the tensor cores: one residual block
// per launch, forward (K1, and K7f without the mask bytes) and the waveform
// backward (K2 from mask bytes, K7b with the gate recomputed from x; two
// phases each). trunk.cu holds the float32 path of the same functions and
// the arithmetic notes; this file computes the same sums with bf16 inputs
// and f32 accumulation, so no cast point moves.
//
// Replaces, for bfloat16 tensors:
// audio_style_transfer_tpu/ops/pallas_chain.py::_fwd_group_kernel (K1) and
// ::_bwd_group_kernel (K2); audio_style_transfer_tpu/ops/pallas_encoder.py::
// _fwd_kernel (K7f) and ::_bwd_kernel (K7b).
//
//   K1:  out = x + round(relu_r(conv3_d(relu x) + bd) @ Wr + br), mask bytes
//        bit 0 = (out > 0), bit 1 = (y > 0); optionally inmask = (x > 0)
//   K7f: the same out, no mask bytes (kMasks = false)
//   K2 phase 1:  dy = round((g @ Wr^T) * gate),  g = round(dxn + dtap)
//   K7b phase 1: y = conv3_d(relu x) + bd recomputed as K1 computes it,
//                dy = round((g @ Wr^T) * [y > 0]),  g the block's output cotangent
//   phase 2 (both):  dx = g + round((dy[t+d] W0^T + dy[t] W1^T + dy[t-d] W2^T) * inrelu),
//                inrelu = bit 0 of the input mask (K2) or x > 0 (K7b, kGateFromX)
// Rows outside their clip read as zero (SAME padding). With a valid window
// [lo, hi) of in-clip rows (the TPU kernels' `windowed` branch; trunk.cu has
// the semantics) the forwards zero out on the other rows before bit 0 is
// taken, and both backward phases zero g there: one predicate per row, in
// the epilogues and on phase 1's A fragments, beside the clip-edge predicate.
//
// What bounds it on the H100 (C=128): per row a layer moves 640 B (K1), 512
// (K7f), 832-1088 (K2, its two phases counted as one) or 768 (K7b) against
// 131 kFLOP (K7b: 229), so at the tensor cores' peak the bytes decide (237 568
// rows: K1 45 us of HBM against 31 us of products). Run as two launches, K2
// moves 2 KB a row (dy out and back, dxn and dtap read by both phases): 145
// us at 237 568 rows, which its phases come within 1.3x of. K1 is bound by
// its loads' and stores' latency more than by either rate.
//
// Design of K1, K7f, K2 and K7b's phase 2 (the persistent kernels):
//  - Persistent and weight-stationary: min(row tiles / 2, SMs) blocks of two
//    warpgroups; the block stages the layer's weights into shared memory once
//    (K1 4 x 32 KB, phase 2 3 x 32 KB, phase 1 32 KB) and each warpgroup walks
//    its own tiles of 64 rows (warpgroup w of block b: tiles w G + b, then
//    every 2 G; G blocks), so at any time the tiles in flight lie within 2 G
//    tiles of each other and a halo row or a neighbour's tile comes from L2:
//    HBM reads stay near one pass over the input.
//  - Pipelined: each warpgroup has its own stage (K1, phase 2: 48 KB, a window
//    of 64 + 2d rows or three 64-row tiles; phase 1: two stages of dxn, dtap
//    and the mask bytes, 40 KB each) and its own named barrier, so one
//    warpgroup's loads and stores overlap the other's products. The next
//    tile's rows are requested (16-byte cp.async, one commit group per tap
//    position) as soon as the warpgroup is done with its stage; phase 1
//    requests tile i + 1 before it computes tile i. The first tile's rows ride
//    in the weights' commit groups, so tap 0 starts once W0 has landed.
//  - The products are wgmma.m64n128k16, one a k-chunk for the warpgroup's 64
//    rows: A (relu'd and clip-zeroed in registers) from ldmatrix, B through
//    a shared-memory descriptor (the weights staged with the 128-byte
//    swizzle; the forward's W[k][n] in wgmma's transposed form), f32
//    accumulators in registers, each warp 16 rows by 128 columns. The
//    per-element sequence is mma.sync's (taps 0, 1, 2, k-chunks of 16 in
//    order, float32 accumulators from 0, one rounding), and on the card
//    wgmma's sums are mma.sync's bit for bit (1.6 M random elements of wide
//    range, both B orientations), so K2-wf and K7b's phase 1, which keep
//    mma.sync, still share K1/K2's bits. A tap's 8 products run while the next
//    tap's fragments load (two register sets).
//  - A tile whose every row reads all three taps inside its clip (the rule;
//    warp-uniform) skips the clip-edge zeroing; relu is two instructions a
//    register (prmt). K1's v = round(relu(y + bd)) stays in registers as the
//    A operand of v @ Wr (accumulator tiles 2 k, 2 k + 1 are k-chunk k), and
//    its gate bits y > 0 are packed into one 32-bit word per 32 columns of a
//    row (1 KB a tile), OR-ed across the quad by shuffles.
//  - Epilogues are warp-private: a warp stages its rounded 16 x 128 product
//    into rows only tap 0 read and finishes them in a pass of 16 columns a
//    thread (16-byte loads and stores). Phase 2's g, dtap and inrelu come from
//    device memory, prefetched into L2 when the tile's rows are requested,
//    and loaded all before the first store.
//  - Clip edges and the array's end are applied to the A fragments in
//    registers (a row whose shifted source lies outside its clip is zeroed),
//    so a tile may hold rows of several clips and any rows / clip_rows / d.
//    Activation rows are 256 B with the 16-byte chunk c of row r at c ^ (r & 7).
//  - Measured on the card and dropped: mma.sync with 32 x 64 warp tiles (K1
//    133 us: issue-bound, some 3 500 instructions a warp around its 512
//    products); the warpgroups taking turns on the tensor cores; requesting
//    a tile's rows before the previous tile's epilogue (slower: the early
//    loads contend with the epilogue's).
//
// K7b phase 1 keeps the one-tile-per-block design (128 rows, 8 warps of 16 x
// 128 on mma.sync, 224 KB): its gate stays in registers and g's rows stream
// into tap 0's weight slot. The fragment, staging and epilogue helpers are in
// mma_tiles.h, shared with the grouped backward K2-wf (trunk_wf_mma.cu).

#include "mma_tiles.h"

namespace {

// -------------------------------------------------------------------------
// The persistent kernels: K1, K7f, K2's two phases, K7b's phase 2.
// -------------------------------------------------------------------------

constexpr int PM = 64;                      // rows per tile: one wgmma's m64
constexpr int WG = 128;                     // threads per warpgroup: 4 warps of 16 rows
constexpr int PNT = 2 * WG;                 // threads per block
constexpr int STAGE = 3 * PM * ROWB;        // three tap positions: 48 KB
constexpr int DY_STAGE = 2 * PM * ROWB + PM * MROWB;  // dxn, dtap, mask bytes: 40 KB
constexpr int WARP_STAGE = 16 * ROWB;       // a warp's 16 x 128 bf16 staging: 4 KB
constexpr int GATE_WORDS = PM * 4;          // a tile's gate bits: 4 words a row

__device__ __forceinline__ void bar_block() {
  asm volatile("bar.sync 0, %0;\n" ::"n"(PNT) : "memory");
}
__device__ __forceinline__ void bar_wg(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(WG) : "memory");
}
// The weights arrive by cp.async (the generic proxy) and wgmma reads them
// through the async proxy: each thread fences its own copies before the
// barrier that publishes them.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A warpgroup without a tile: its share of the weights lands at the block
// barriers that the other warpgroup passes with its first tile.
__device__ __forceinline__ void join_weight_barriers(int n) {
  cp_async_wait(0);
  proxy_fence();
  for (int i = 0; i < n; ++i) bar_block();
}

// The thread's place: warpgroup wg, warp w of it owning the tile's rows
// [16 w, 16 w + 16) by all 128 columns (acc[16][4], mma_tiles.h's layout,
// which is wgmma m64n128's accumulator layout warp by warp).
struct Place {
  int wg, tid, lane, w, g, t;
  __device__ Place()
      : wg(threadIdx.x / WG), tid(threadIdx.x % WG), lane(threadIdx.x & 31),
        w((threadIdx.x % WG) >> 5), g((threadIdx.x & 31) >> 2), t(threadIdx.x & 3) {}
  // The tiles of this warpgroup: first(), then every step().
  __device__ int first() const { return wg * gridDim.x + blockIdx.x; }
  __device__ int step() const { return 2 * gridDim.x; }
};

// Copy rows [g0, g0 + n) of src to buffer rows [w0, w0 + n), by the
// warpgroup's thread tid; a row outside [0, rows) is zero-filled.
__device__ __forceinline__ void stage_rows_wg(uint32_t dst, const bf16* __restrict__ src, int w0,
                                              int n, long g0, int rows, int tid) {
  for (int i = tid; i < n * 16; i += WG) {
    const int w = w0 + (i >> 4), c = i & 15;
    const long g = g0 + (i >> 4);
    const bool in = g >= 0 && g < rows;
    cp_async16(dst + chunk_at(w, c), src + (in ? g : 0) * C + c * 8, in ? 16 : 0);
  }
}

// The stage of a three-tap product. Position p (0, 1, 2) reads the tile's
// rows shifted by (p - 1) d, from buffer row base(p): for d < PM the window
// of rows [row0 - d, row0 + PM + d) at buffer rows [PM - d, 2 PM + d); for
// d >= PM three tiles at 0, PM, 2 PM. Either way position 1 (the tile's own
// rows) is at [PM, 2 PM), rows [0, PM) are read by tap 0 alone and rows
// [2 PM, 3 PM) by tap 2 alone.
struct Span {
  int d, s;
  __device__ explicit Span(int d_) : d(d_), s(d_ < PM ? d_ : PM) {}
  __device__ int base(int p) const { return PM + (p - 1) * s; }
  // Start the copies that position p adds to what positions < p brought.
  __device__ void stage(uint32_t buf, const bf16* __restrict__ src, int p, long row0, int rows,
                        int tid) const {
    if (d < PM) {
      const int w0 = p == 0 ? PM - d : (p == 1 ? 2 * PM - d : 2 * PM);
      stage_rows_wg(buf, src, w0, p == 0 ? PM : d, row0 - PM + w0, rows, tid);
    } else {
      stage_rows_wg(buf, src, p * PM, PM, row0 + (long)(p - 1) * d, rows, tid);
    }
  }
};

// Bring n rows of row_bytes from row row0 of src into L2, by the warpgroup.
__device__ __forceinline__ void prefetch_rows(const void* src, long row0, int n, int row_bytes,
                                              int tid) {
  const char* p = static_cast<const char*>(src) + row0 * row_bytes;
  for (int i = tid; i < n * row_bytes / 128; i += WG)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p + i * 128));
}

// mma_tiles.h::relu2 in two instructions: prmt replicates each half's sign
// bit over the half, and the mask clears the negative halves.
__device__ __forceinline__ uint32_t relu2_prmt(uint32_t v) {
  uint32_t m;
  asm("prmt.b32 %0, %1, %2, 0xBB99;\n" : "=r"(m) : "r"(v), "r"(0));
  return v & ~m;
}

// ---- wgmma: the warpgroup's products ------------------------------------
//
// B is a [C, C] weight in shared memory, read by the tensor cores through a
// descriptor: two halves of 64 columns of W's second index, each 128 rows (W's
// first index) of 128 B with the 16-byte chunk c of row r at c ^ (r & 7), the
// 128-byte swizzle. B[k][n] = W[k][n] (kTransposed false: rows are k, the
// operand MN-major, wgmma's transposed form) or W[n][k] (true: K-major). A is
// the warps' ldmatrix fragments in registers, mma.sync's m16n8k16 layout, and
// the accumulators are mma.sync's too: on the card each element takes the
// same sums in the same order and comes out bit for bit as mma.sync's.

template <int kThreads>
__device__ __forceinline__ void stage_weight_sw(uint32_t dst, const bf16* __restrict__ w) {
  for (int i = threadIdx.x; i < C * 16; i += kThreads) {
    const int r = i >> 4, c = i & 15;
    cp_async16(dst + (c >> 3) * (WBYTES / 2) + r * 128 + (((c & 7) ^ (r & 7)) << 4),
               w + r * C + c * 8, 16);
  }
}

// The descriptor of rows [16 kk, 16 kk + 16) of B: start, leading and stride
// byte offsets (each >> 4), 128-byte swizzle. K-major: a k-chunk is 32 B into
// a half's rows, 8-row groups 1 KB apart; MN-major: 16 rows of k, 8-row
// groups 1 KB apart, the halves 16 KB apart.
template <bool kTransposed>
__device__ __forceinline__ uint64_t b_desc(uint32_t w, int kk) {
  const uint32_t start =
      kTransposed ? w + (kk >> 2) * (WBYTES / 2) + (kk & 3) * 32 : w + kk * 16 * 128;
  const uint32_t lbo = kTransposed ? 16 : WBYTES / 2;
  return (uint64_t)((start & 0x3ffff) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// acc[64 rows of the warpgroup, 128] += A (4 registers a thread) @ B's k-chunk.
template <bool kTransposed>
__device__ __forceinline__ void wgmma(float (&acc)[16][4], const uint32_t (&a)[4],
                                      uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(acc[0][0]), "+f"(acc[0][1]), "+f"(acc[0][2]), "+f"(acc[0][3]), "+f"(acc[1][0]),
        "+f"(acc[1][1]), "+f"(acc[1][2]), "+f"(acc[1][3]), "+f"(acc[2][0]), "+f"(acc[2][1]),
        "+f"(acc[2][2]), "+f"(acc[2][3]), "+f"(acc[3][0]), "+f"(acc[3][1]), "+f"(acc[3][2]),
        "+f"(acc[3][3]), "+f"(acc[4][0]), "+f"(acc[4][1]), "+f"(acc[4][2]), "+f"(acc[4][3]),
        "+f"(acc[5][0]), "+f"(acc[5][1]), "+f"(acc[5][2]), "+f"(acc[5][3]), "+f"(acc[6][0]),
        "+f"(acc[6][1]), "+f"(acc[6][2]), "+f"(acc[6][3]), "+f"(acc[7][0]), "+f"(acc[7][1]),
        "+f"(acc[7][2]), "+f"(acc[7][3]), "+f"(acc[8][0]), "+f"(acc[8][1]), "+f"(acc[8][2]),
        "+f"(acc[8][3]), "+f"(acc[9][0]), "+f"(acc[9][1]), "+f"(acc[9][2]), "+f"(acc[9][3]),
        "+f"(acc[10][0]), "+f"(acc[10][1]), "+f"(acc[10][2]), "+f"(acc[10][3]),
        "+f"(acc[11][0]), "+f"(acc[11][1]), "+f"(acc[11][2]), "+f"(acc[11][3]),
        "+f"(acc[12][0]), "+f"(acc[12][1]), "+f"(acc[12][2]), "+f"(acc[12][3]),
        "+f"(acc[13][0]), "+f"(acc[13][1]), "+f"(acc[13][2]), "+f"(acc[13][3]),
        "+f"(acc[14][0]), "+f"(acc[14][1]), "+f"(acc[14][2]), "+f"(acc[14][3]),
        "+f"(acc[15][0]), "+f"(acc[15][1]), "+f"(acc[15][2]), "+f"(acc[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(kTransposed ? 0 : 1));
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
// Registers that an asynchronous product reads or writes: the compiler keeps
// them, and every access to them, where these fences stand.
__device__ __forceinline__ void reg_fence(float (&acc)[16][4]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(acc[j][i])::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t (&a)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i])::"memory");
}

// Start acc += A @ B over all of k: the 8 k-chunks of one weight, one commit
// group. acc and a stay untouched until a wgmma_wait has retired the group.
template <bool kTransposed>
__device__ __forceinline__ void issue_product(float (&acc)[16][4], uint32_t (&a)[8][4],
                                              uint32_t w) {
  reg_fence(acc);
  reg_fence(a);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma<kTransposed>(acc, a[kk], b_desc<kTransposed>(w, kk));
  wgmma_commit();
}

// The thread's two fragment rows row0 + 16 w + g (+ 8): whether each lies in
// the array, its in-clip position, and whether every row of the warp reads
// all three taps inside its clip (`inner`, warp-uniform: no A row needs
// zeroing).
struct FragRows {
  bool in[2];
  int pos[2];
  bool inner;
  __device__ FragRows(long row0, const Place& pl, int rows, int clip_rows, int d) {
    bool all = true;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long r = row0 + 16 * pl.w + 8 * h + pl.g;
      in[h] = r < rows;
      pos[h] = (int)((unsigned)r % (unsigned)clip_rows);  // r < 2^31 + PM
      all = all && in[h] && pos[h] >= d && (long)pos[h] + d < clip_rows;
    }
    inner = __all_sync(0xffffffffu, all);
  }
  // mma_tiles.h::tap_ok for row h: the row shifted by off stays in its clip.
  __device__ bool tap_ok(int h, long off, int clip_rows) const {
    return in[h] && pos[h] + off >= 0 && pos[h] + off < clip_rows;
  }
};

// A's fragments for one tap: the warp's 16 rows from buffer row arow0, all
// 8 k-chunks; relu (kRelu); rows whose shifted source lies outside their clip
// zeroed, unless no row's does.
template <bool kRelu>
__device__ __forceinline__ void load_tap(uint32_t (&a)[8][4], uint32_t act, int arow0,
                                         const FragRows& fr, long off, int clip_rows,
                                         int lane) {
  const bool ok_lo = fr.inner || fr.tap_ok(0, off, clip_rows);
  const bool ok_hi = fr.inner || fr.tap_ok(1, off, clip_rows);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    load_a_frag(a[kk], act, arow0, kk, lane);
    if (kRelu) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[kk][i] = relu2_prmt(a[kk][i]);
    }
    if (!ok_lo) a[kk][0] = a[kk][2] = 0u;
    if (!ok_hi) a[kk][1] = a[kk][3] = 0u;
  }
}

// The three taps of a tile: acc += A_p @ B_p for p = 0, 1, 2, A from the
// stage at span.base(p), B the weight at w + p WBYTES. Before tap p the
// stage's commit group p has landed (wait_p(p): the cp.async wait and the
// barrier); taps alternate two register sets of A, so a tap's fragments load
// while the previous tap's products run. Returns with every product retired.
template <bool kTransposed, bool kRelu, typename Wait>
__device__ __forceinline__ void three_taps(float (&acc)[16][4], uint32_t st, const Span& span,
                                           uint32_t w, const FragRows& fr, int d,
                                           int clip_rows, const Place& pl, Wait&& wait_p) {
  uint32_t a[2][8][4];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    wait_p(p);
    if (p == 2) {
      wgmma_wait<1>();  // tap 0's products are done with register set 0
      reg_fence(a[0]);
    }
    load_tap<kRelu>(a[p & 1], st, span.base(p) + 16 * pl.w, fr, (long)(p - 1) * d, clip_rows,
                    pl.lane);
    issue_product<kTransposed>(acc, a[p & 1], w + p * WBYTES);
  }
  wgmma_wait<0>();
  reg_fence(acc);
  reg_fence(a[0]);
  reg_fence(a[1]);
}

// One byte per value of r: 1 where the value is > 0 (an ordered bf16x2
// compare: zeros and NaN give 0). A true half reads 1.0, 0x3f80: its low byte
// is 0x80, which prmt gathers and the shift turns into 1.
__device__ __forceinline__ uint4 positive_bytes(const Row16& r) {
  const __nv_bfloat162 zero2 = __float2bfloat162_rn(0.f);
  uint32_t c[8], out[4];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const __nv_bfloat162 h = __hgt2(*reinterpret_cast<const __nv_bfloat162*>(&r.w[e]), zero2);
    c[e] = *reinterpret_cast<const uint32_t*>(&h);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = __byte_perm(c[2 * k], c[2 * k + 1], 0x6420) >> 7;
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// The gate of the two values of register e of a Row16 as a bit mask: 0xffff
// in each half whose mask byte (2 e, 2 e + 1 of the 16 in m) has bit `bit`.
__device__ __forceinline__ uint32_t gate_mask(const uint4& m, int e, int bit) {
  const uint32_t w = (e >> 1) == 0 ? m.x : (e >> 1) == 1 ? m.y : (e >> 1) == 2 ? m.z : m.w;
  const uint32_t two = __byte_perm(w, 0, (e & 1) ? 0x4342 : 0x4140);  // the bytes, one a half
  return ((two >> bit) & 0x00010001u) * 0xffffu;
}

// Bits 0-3 of b, one to a byte.
__device__ __forceinline__ uint32_t bit_bytes(uint32_t b) {
  return (b & 1u) | ((b & 2u) << 7) | ((b & 4u) << 14) | ((b & 8u) << 21);
}

// The warp's pass of 16 columns a thread (mma_tiles.h's staging layout):
// item `it` (0..3) of the lane is row 16 w + (i >> 3) of the tile by the
// column group i & 7 of 16, i = 32 it + lane; its in-clip position.
struct Item {
  int row, cg;
  long grow;
  __device__ Item(int it, const Place& pl, long row0) {
    const int i = it * 32 + pl.lane;
    row = 16 * pl.w + (i >> 3);
    cg = i & 7;
    grow = row0 + row;
  }
  __device__ bool in_window(int clip_rows, int lo, int hi) const {
    const int pos = (int)((unsigned)grow % (unsigned)clip_rows);
    return pos >= lo && pos < hi;
  }
};

// Run body(it) for the thread's four epilogue items, those in the array: a
// tile wholly inside it (the rule) takes no per-item test.
template <typename F>
__device__ __forceinline__ void for_items(long row0, int rows, const Place& pl, F&& body) {
  if (row0 + PM <= rows) {
#pragma unroll
    for (int it = 0; it < 4; ++it) body(Item(it, pl, row0), it);
  } else {
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const Item im(it, pl, row0);
      if (im.grow < rows) body(im, it);
    }
  }
}

// K1: one trunk layer forward with its mask bytes; kMasks = false is K7f,
// the same kernel writing its output only.
template <bool kMasks>
__global__ void __launch_bounds__(PNT, 1)
trunk_fwd_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wd,
                     const float* __restrict__ bd, const bf16* __restrict__ wr,
                     const float* __restrict__ br, bf16* __restrict__ out,
                     uint8_t* __restrict__ mask, uint8_t* __restrict__ inmask, int rows,
                     int clip_rows, int d, int lo, int hi) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const Place pl;
  uint8_t* const st_p = smem + 4 * WBYTES + pl.wg * STAGE;
  uint32_t* const gbits =
      reinterpret_cast<uint32_t*>(smem + 4 * WBYTES + 2 * STAGE) + pl.wg * GATE_WORDS;
  const uint32_t wsm = smem_addr(smem), st = smem_addr(st_p);
  const int tiles = (rows + PM - 1) / PM;
  const Span span(d);
  int tile = pl.first();

  // The weights by the block, one commit group per tap and one for Wr; the
  // warpgroup's first tile in the taps' groups, position by position.
  for (int p = 0; p < 3; ++p) {
    stage_weight_sw<PNT>(wsm + p * WBYTES, wd + (long)p * C * C);
    if (tile < tiles) span.stage(st, x, p, (long)tile * PM, rows, pl.tid);
    cp_async_commit();
  }
  stage_weight_sw<PNT>(wsm + 3 * WBYTES, wr);
  cp_async_commit();
  if (tile >= tiles) {
    join_weight_barriers(4);
    return;
  }

  for (bool first = true; tile < tiles; tile += pl.step(), first = false) {
    const long row0 = (long)tile * PM;
    const FragRows fr(row0, pl, rows, clip_rows, d);
    float acc[16][4];
    zero(acc);
    // Position p of the forward is tap p: relu(x)[t + (p - 1) d] @ wd[p].
    // The first tile waits for the weights too, at block barriers.
    three_taps<false, true>(acc, st, span, wsm, fr, d, clip_rows, pl, [&](int p) {
      cp_async_wait(first ? 3 - p : 2 - p);
      if (first) {
        proxy_fence();
        bar_block();
      } else {
        bar_wg(pl.wg);
      }
    });

    // y = acc + bd in float32; its gate bits y > 0 (bit 8 (j & 3) + 2 t (+ 1)
    // of word j / 4 of the row); v = round(relu y), register for register
    // the A fragments of v @ Wr (accumulator tiles 2 k, 2 k + 1 are k-chunk k).
    uint32_t words[2][4] = {};  // [row g / g + 8][word]
    uint32_t v[8][4];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(bd + j * 8 + 2 * pl.t);
      const float y0 = acc[j][0] + b.x, y1 = acc[j][1] + b.y;
      const float y2 = acc[j][2] + b.x, y3 = acc[j][3] + b.y;
      v[j >> 1][(j & 1) * 2] = pack2(fmaxf(y0, 0.f), fmaxf(y1, 0.f));
      v[j >> 1][(j & 1) * 2 + 1] = pack2(fmaxf(y2, 0.f), fmaxf(y3, 0.f));
      const int sh = (j & 3) * 8 + 2 * pl.t;
      words[0][j >> 2] |= ((y0 > 0.f ? 1u : 0u) | (y1 > 0.f ? 2u : 0u)) << sh;
      words[1][j >> 2] |= ((y2 > 0.f ? 1u : 0u) | (y3 > 0.f ? 2u : 0u)) << sh;
    }
    if (kMasks) {
      // OR the quad's bits; thread t writes word t of both its rows.
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          uint32_t wv = words[h][m];
          wv |= __shfl_xor_sync(0xffffffffu, wv, 1);
          wv |= __shfl_xor_sync(0xffffffffu, wv, 2);
          if (m == pl.t) gbits[(16 * pl.w + 8 * h + pl.g) * 4 + m] = wv;
        }
    }
    zero(acc);
    if (first) {  // Wr has landed
      cp_async_wait(0);
      proxy_fence();
      bar_block();
    }
    issue_product<false>(acc, v, wsm + 3 * WBYTES);
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(v);

    // round(z + br) into the warp's own rows of [0, PM), which only tap 0
    // read; then 16 columns a thread: out = x + z (x is position 1), K1: the
    // mask bytes, the input's relu mask.
    stage_acc(st_p, acc, br, 16 * pl.w, pl.lane);
    __syncwarp();
    for_items(row0, rows, pl, [&](const Item& im, int) {
      const Row16 zr = load16_smem(st_p, im.row, im.cg);
      const Row16 xr = load16_smem(st_p, PM + im.row, im.cg);
      const bool valid = im.in_window(clip_rows, lo, hi);
      Row16 o;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o.w[e] = valid ? pack2(bf_lo(xr.w[e]) + bf_lo(zr.w[e]), bf_hi(xr.w[e]) + bf_hi(zr.w[e]))
                       : 0u;
      const long idx = im.grow * C + im.cg * 16;
      store16_global(out, idx, o);
      if (kMasks) {
        const uint32_t gt = gbits[im.row * 4 + (im.cg >> 1)] >> ((im.cg & 1) * 16);
        uint4 m = positive_bytes(o);
        m.x |= bit_bytes(gt) << 1, m.y |= bit_bytes(gt >> 4) << 1;
        m.z |= bit_bytes(gt >> 8) << 1, m.w |= bit_bytes(gt >> 12) << 1;
        *reinterpret_cast<uint4*>(mask + idx) = m;
        if (inmask) *reinterpret_cast<uint4*>(inmask + idx) = positive_bytes(xr);
      }
    });

    // Every warp is done with the stage: request the next tile's rows.
    bar_wg(pl.wg);
    const int next = tile + pl.step();
    if (next < tiles) {
      for (int p = 0; p < 3; ++p) {
        span.stage(st, x, p, (long)next * PM, rows, pl.tid);
        cp_async_commit();
      }
    }
  }
}

// K2 phase 1: dy = round((g @ Wr^T) * gate), g = round(dxn + dtap).
// Each warpgroup keeps two stages: tile i + 1's rows land while tile i runs.
__global__ void __launch_bounds__(PNT, 1)
trunk_bwd_dy_mma_kernel(const bf16* __restrict__ dxn, const bf16* __restrict__ dtap,
                        const uint8_t* __restrict__ mask, const bf16* __restrict__ wr,
                        bf16* __restrict__ dy, int rows, int clip_rows, int lo, int hi) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const Place pl;
  uint8_t* const st0 = smem + WBYTES + pl.wg * 2 * DY_STAGE;
  uint8_t* const wst = smem + WBYTES + 4 * DY_STAGE + (threadIdx.x >> 5) * WARP_STAGE;
  const uint32_t wsm = smem_addr(smem);
  const int tiles = (rows + PM - 1) / PM;
  int tile = pl.first();

  // dxn's rows at [0, PM), dtap's at [PM, 2 PM), the mask bytes after them.
  auto stage = [&](int s, int tl) {
    const uint32_t buf = smem_addr(st0 + s * DY_STAGE);
    const long row0 = (long)tl * PM;
    stage_rows_wg(buf, dxn, 0, PM, row0, rows, pl.tid);
    if (dtap) stage_rows_wg(buf + PM * ROWB, dtap, 0, PM, row0, rows, pl.tid);
    for (int i = pl.tid; i < PM * 8; i += WG) {
      const long g = row0 + (i >> 3);
      const bool in = g < rows;
      cp_async16(buf + 2 * PM * ROWB + mchunk_at(i >> 3, i & 7),
                 mask + (in ? g : 0) * C + (i & 7) * 16, in ? 16 : 0);
    }
  };

  stage_weight_sw<PNT>(wsm, wr);
  if (tile < tiles) stage(0, tile);
  cp_async_commit();
  if (tile >= tiles) {
    join_weight_barriers(1);
    return;
  }

  for (int k = 0; tile < tiles; ++k, tile += pl.step()) {
    const int next = tile + pl.step();
    if (next < tiles) stage((k + 1) & 1, next);
    cp_async_commit();
    cp_async_wait(1);
    if (k == 0) {
      proxy_fence();
      bar_block();
    } else {
      bar_wg(pl.wg);
    }

    uint8_t* const buf_p = st0 + (k & 1) * DY_STAGE;
    const uint32_t buf = smem_addr(buf_p);
    const long row0 = (long)tile * PM;
    const long r_lo = row0 + 16 * pl.w + pl.g;
    const bool ok_lo = in_window(r_lo, clip_rows, lo, hi);
    const bool ok_hi = in_window(r_lo + 8, clip_rows, lo, hi);
    uint32_t a[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      load_a_frag(a[kk], buf, 16 * pl.w, kk, pl.lane);
      if (dtap) {
        uint32_t b[4];
        load_a_frag(b, buf + PM * ROWB, 16 * pl.w, kk, pl.lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) a[kk][i] = add2(a[kk][i], b[i]);
      }
      if (!ok_lo) a[kk][0] = a[kk][2] = 0u;
      if (!ok_hi) a[kk][1] = a[kk][3] = 0u;
    }
    float acc[16][4];
    zero(acc);
    issue_product<true>(acc, a, wsm);
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(a);

    // The warp's rounded product in its own staging, then 16 columns a
    // thread, gated by bit 1 of the mask bytes.
    stage_acc(wst, acc, nullptr, 0, pl.lane);
    __syncwarp();
    for_items(row0, rows, pl, [&](const Item& im, int) {
      Row16 r = load16_smem(wst, im.row - 16 * pl.w, im.cg);
      const uint4 m = *reinterpret_cast<const uint4*>(buf_p + 2 * PM * ROWB +
                                                      mchunk_at(im.row, im.cg));
#pragma unroll
      for (int e = 0; e < 8; ++e) r.w[e] &= gate_mask(m, e, 1);
      store16_global(dy, im.grow * C + im.cg * 16, r);
    });
    // Every warp is done with this stage: tile i + 2 may land in it.
    bar_wg(pl.wg);
  }
}

// Phase 2 of K2 and K7b: dx = g + round(dr * inrelu),
// dr[t] = dy[t+d] W0^T + dy[t] W1^T + dy[t-d] W2^T, g = round(dxn + dtap).
// inrelu is bit 0 of the input mask bytes (K2) or, with kGateFromX (K7b),
// x > 0 from the block input xin.
template <bool kGateFromX>
__global__ void __launch_bounds__(PNT, 1)
trunk_bwd_dx_mma_kernel(const bf16* __restrict__ dxn, const bf16* __restrict__ dtap,
                        const bf16* __restrict__ dy, const uint8_t* __restrict__ inmask,
                        const bf16* __restrict__ xin, const bf16* __restrict__ wd,
                        bf16* __restrict__ dx, int rows, int clip_rows, int d, int lo, int hi) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const Place pl;
  uint8_t* const st_p = smem + 3 * WBYTES + pl.wg * STAGE;
  const uint32_t wsm = smem_addr(smem), st = smem_addr(st_p);
  const int tiles = (rows + PM - 1) / PM;
  const Span span(d);
  int tile = pl.first();

  // The epilogue's reads from device memory for the tile at row0, into L2.
  auto prefetch = [&](long row0) {
    const int n = (int)min((long)PM, rows - row0);
    prefetch_rows(dxn, row0, n, ROWB, pl.tid);
    if (dtap) prefetch_rows(dtap, row0, n, ROWB, pl.tid);
    if (kGateFromX) prefetch_rows(xin, row0, n, ROWB, pl.tid);
    else prefetch_rows(inmask, row0, n, MROWB, pl.tid);
  };

  // Position p reads dy[t + (p - 1) d], which meets tap 2 - p's weight.
  for (int p = 0; p < 3; ++p) {
    stage_weight_sw<PNT>(wsm + p * WBYTES, wd + (long)(2 - p) * C * C);
    if (tile < tiles) span.stage(st, dy, p, (long)tile * PM, rows, pl.tid);
    cp_async_commit();
  }
  if (tile >= tiles) {
    join_weight_barriers(3);
    return;
  }
  prefetch((long)tile * PM);

  for (bool first = true; tile < tiles; tile += pl.step(), first = false) {
    const long row0 = (long)tile * PM;
    const FragRows fr(row0, pl, rows, clip_rows, d);
    float acc[16][4];
    zero(acc);
    three_taps<true, false>(acc, st, span, wsm, fr, d, clip_rows, pl, [&](int p) {
      cp_async_wait(2 - p);
      if (first) {
        proxy_fence();
        bar_block();
      } else {
        bar_wg(pl.wg);
      }
    });

    // round(dr) into the warp's own rows of [0, PM), which only tap 0 read;
    // then 16 columns a thread, every load before a store.
    stage_acc(st_p, acc, nullptr, 16 * pl.w, pl.lane);
    __syncwarp();
    // inrelu as bytes with bit 0 set: the input mask bytes, or x > 0.
    Row16 gr[4], tp[4];
    uint4 m[4];
    for_items(row0, rows, pl, [&](const Item& im, int it) {
      const long idx = im.grow * C + im.cg * 16;
      gr[it] = load16_global(dxn, idx);
      if (dtap) tp[it] = load16_global(dtap, idx);
      if (kGateFromX) m[it] = positive_bytes(load16_global(xin, idx));
      else m[it] = *reinterpret_cast<const uint4*>(inmask + idx);
    });
    for_items(row0, rows, pl, [&](const Item& im, int it) {
      const Row16 dr = load16_smem(st_p, im.row, im.cg);
      const bool valid = im.in_window(clip_rows, lo, hi);
      Row16 o;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const uint32_t g = !valid ? 0u : dtap ? add2(gr[it].w[e], tp[it].w[e]) : gr[it].w[e];
        const uint32_t r = dr.w[e] & gate_mask(m[it], e, 0);
        o.w[e] = pack2(bf_lo(g) + bf_lo(r), bf_hi(g) + bf_hi(r));
      }
      store16_global(dx, im.grow * C + im.cg * 16, o);
    });

    // Every warp is done with the stage: request the next tile's rows.
    bar_wg(pl.wg);
    const int next = tile + pl.step();
    if (next < tiles) {
      for (int p = 0; p < 3; ++p) {
        span.stage(st, dy, p, (long)next * PM, rows, pl.tid);
        cp_async_commit();
      }
      prefetch((long)next * PM);
    }
  }
}

// -------------------------------------------------------------------------
// K7b phase 1: one tile of 128 rows per block, 8 warps of 16 x 128.
// -------------------------------------------------------------------------

constexpr int TM = 128;           // rows per block
constexpr int NT = 256;           // threads per block: 8 warps of 16 rows
constexpr int ACT_ROWS = 3 * TM;  // activation buffer: a window or three tiles

// Copy rows [g0, g0 + n) of src to buffer rows [w0, w0 + n); a row outside
// [0, rows) is zero-filled.
__device__ __forceinline__ void stage_rows(uint32_t dst, const bf16* __restrict__ src, int w0,
                                           int n, long g0, int rows) {
  for (int i = threadIdx.x; i < n * 16; i += NT) {
    const int w = w0 + (i >> 4), c = i & 15;
    const long g = g0 + (i >> 4);
    const bool in = g >= 0 && g < rows;
    cp_async16(dst + chunk_at(w, c), src + (in ? g : 0) * C + c * 8, in ? 16 : 0);
  }
}

// The activation buffer of a three-tap product. Tap position p (0, 1, 2)
// reads the tile's rows shifted by (p - 1) d. For d < TM the buffer is the
// window of rows [row0 - d, row0 + TM + d) and position p starts at buffer
// row p d; for d >= TM it is three tiles and position p starts at p TM.
struct Window {
  int d, stride;
  __device__ explicit Window(int d_) : d(d_), stride(d_ < TM ? d_ : TM) {}
  __device__ int base(int p) const { return p * stride; }
  // Start the copies that position p adds to what positions < p brought.
  __device__ void stage(uint32_t act, const bf16* __restrict__ src, int p, long row0,
                        int rows) const {
    if (d < TM) {
      const int w0 = p == 0 ? 0 : TM + (p - 1) * d;
      stage_rows(act, src, w0, p == 0 ? TM : d, row0 - d + w0, rows);
    } else {
      stage_rows(act, src, p * TM, TM, row0 + (long)(p - 1) * d, rows);
    }
  }
};

// y = acc + bd on accumulator tile j (rows g, g + 8 by columns 2t, 2t + 1),
// in float32, with its four gate bits y > 0 set in gate (4 bits a tile).
__device__ __forceinline__ void bias_gate(const float (&a)[4], const float* __restrict__ bd,
                                          int j, int t, uint32_t (&gate)[2]) {
  const float2 b = *reinterpret_cast<const float2*>(bd + j * 8 + 2 * t);
  const uint32_t bits = (a[0] + b.x > 0.f ? 1u : 0u) | (a[1] + b.y > 0.f ? 2u : 0u) |
                        (a[2] + b.x > 0.f ? 4u : 0u) | (a[3] + b.y > 0.f ? 8u : 0u);
  gate[j >> 3] |= bits << ((j & 7) * 4);
}

// The four gate bits of accumulator tile j, in the order of its registers.
__device__ __forceinline__ uint32_t gate_of(const uint32_t (&gate)[2], int j) {
  return (gate[j >> 3] >> ((j & 7) * 4)) & 0xfu;
}

// K7b phase 1: y = conv3_d(relu x) + bd recomputed on the block's rows as
// K1 computes it, then dy = round((g @ Wr^T) * [y > 0]).
__global__ void __launch_bounds__(NT, 1)
encoder_bwd_dy_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                          const bf16* __restrict__ wd, const float* __restrict__ bd,
                          const bf16* __restrict__ wr, bf16* __restrict__ dy, int rows,
                          int clip_rows, int d, int lo, int hi) {
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* const dyst = smem + WBYTES;
  const uint32_t wsm = smem_addr(smem), act = wsm + 4 * WBYTES;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const long row0 = (long)blockIdx.x * TM;
  const Window win(d);

  // K1's loads: commit groups 0-2 the taps, 3 the residual weight.
  for (int p = 0; p < 3; ++p) {
    stage_weight<NT>(wsm + p * WBYTES, wd + (long)p * C * C);
    win.stage(act, x, p, row0, rows);
    cp_async_commit();
  }
  stage_weight<NT>(wsm + 3 * WBYTES, wr);
  cp_async_commit();

  float acc[16][4];
  zero(acc);
  const long r_lo = row0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    // p = 0 waits for group 0; p = 1 for group 1, then every warp is past
    // tap 0's product and its weight slot takes g's tile (group 4); p = 2
    // waits for group 2 with groups 3 and 4 still in flight.
    cp_async_wait(p == 0 ? 3 : 2);
    __syncthreads();
    if (p == 1) {
      stage_rows(wsm, g, 0, TM, row0, rows);
      cp_async_commit();
    }
    const long off = (long)(p - 1) * d;
    tap_product<false, true>(acc, act, win.base(p) + warp * 16, wsm + p * WBYTES,
                             tap_ok(r_lo, off, rows, clip_rows),
                             tap_ok(r_lo + 8, off, rows, clip_rows), lane);
  }

  // The gate y > 0 (y in float32 with bd added in float32), as K1 takes it.
  uint32_t gate[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j) bias_gate(acc[j], bd, j, t, gate);
  zero(acc);

  // g and Wr have landed; every warp is past the conv.
  cp_async_wait(0);
  __syncthreads();
  const bool ok_lo = in_window(r_lo, clip_rows, lo, hi);
  const bool ok_hi = in_window(r_lo + 8, clip_rows, lo, hi);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t a[4];
    load_a_frag(a, wsm, warp * 16, kk, lane);
    if (!ok_lo) a[0] = a[2] = 0u;
    if (!ok_hi) a[1] = a[3] = 0u;
    mma_kstep<true>(acc, a, wsm + 3 * WBYTES, kk, lane);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint32_t bits = gate_of(gate, j);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (!((bits >> i) & 1u)) acc[j][i] = 0.f;
  }

  // Stage round(dy) in tap 1's weight slot (rows private to the warp), then
  // 16 columns a thread.
  stage_acc(dyst, acc, nullptr, warp * 16, lane);
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int i = it * 32 + lane;
    const int row = warp * 16 + (i >> 3), cg = i & 7;
    const long grow = row0 + row;
    if (grow >= rows) continue;
    store16_global(dy, grow * C + cg * 16, load16_smem(dyst, row, cg));
  }
}

constexpr int FWD_SMEM = 4 * WBYTES + 2 * STAGE + 2 * GATE_WORDS * 4;  // 231424 (K1, K7f)
constexpr int DY_SMEM = WBYTES + 4 * DY_STAGE + 8 * WARP_STAGE;           // 229376
constexpr int DX_SMEM = 3 * WBYTES + 2 * STAGE;                          // 196608
constexpr int ENC_DY_SMEM = 4 * WBYTES + ACT_ROWS * ROWB;                // 229376 (K7b phase 1)

template <typename K>
cudaError_t prepare(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The persistent kernels' grid: two tiles of PM rows a block at least, at
// most one block an SM. 0 for no rows (nothing to launch).
int persistent_blocks(int rows) {
  static int sms[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) dev = 0;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  const int pairs = ((rows + PM - 1) / PM + 1) / 2;
  return pairs < sms[dev] ? pairs : sms[dev];
}

int n_blocks(int rows) { return (rows + TM - 1) / TM; }

template <bool kMasks>
int launch_fwd(const void* x, const void* wd, const void* bd, const void* wr, const void* br,
               void* out, void* mask, void* inmask, int rows, int clip_rows, int d, int lo,
               int hi, void* stream) {
  const cudaError_t e = prepare(trunk_fwd_mma_kernel<kMasks>, FWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int blocks = persistent_blocks(rows);
  if (blocks == 0) return 0;
  trunk_fwd_mma_kernel<kMasks><<<blocks, PNT, FWD_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)wd, (const float*)bd, (const bf16*)wr, (const float*)br,
      (bf16*)out, (uint8_t*)mask, (uint8_t*)inmask, rows, clip_rows, d, lo, hi);
  return (int)cudaGetLastError();
}

template <bool kGateFromX>
int launch_dx(const void* dxn, const void* dtap, const void* dy, const void* inmask,
              const void* xin, const void* wd, void* dx, int rows, int clip_rows, int d, int lo,
              int hi, void* stream) {
  const cudaError_t e = prepare(trunk_bwd_dx_mma_kernel<kGateFromX>, DX_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int blocks = persistent_blocks(rows);
  if (blocks == 0) return 0;
  trunk_bwd_dx_mma_kernel<kGateFromX><<<blocks, PNT, DX_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)dxn, (const bf16*)dtap, (const bf16*)dy, (const uint8_t*)inmask,
      (const bf16*)xin, (const bf16*)wd, (bf16*)dx, rows, clip_rows, d, lo, hi);
  return (int)cudaGetLastError();
}

// K2 phase 1: writes dy.
int trunk_bwd_dy(const void* dxn, const void* dtap, const void* mask, const void* wr, void* dy,
                 int rows, int clip_rows, int lo, int hi, void* stream) {
  const cudaError_t e = prepare(trunk_bwd_dy_mma_kernel, DY_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int blocks = persistent_blocks(rows);
  if (blocks == 0) return 0;
  trunk_bwd_dy_mma_kernel<<<blocks, PNT, DY_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)dxn, (const bf16*)dtap, (const uint8_t*)mask, (const bf16*)wr, (bf16*)dy,
      rows, clip_rows, lo, hi);
  return (int)cudaGetLastError();
}

// K7b phase 1: dy from x (the gate recomputed) and g.
int encoder_bwd_dy(const void* x, const void* g, const void* wd, const void* bd, const void* wr,
                   void* dy, int rows, int clip_rows, int d, int lo, int hi, void* stream) {
  const cudaError_t e = prepare(encoder_bwd_dy_mma_kernel, ENC_DY_SMEM);
  if (e != cudaSuccess) return (int)e;
  if (rows == 0) return 0;
  encoder_bwd_dy_mma_kernel<<<n_blocks(rows), NT, ENC_DY_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)g, (const bf16*)wd, (const float*)bd, (const bf16*)wr,
      (bf16*)dy, rows, clip_rows, d, lo, hi);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry returns cudaGetLastError() after its launches (0 on success).
// All tensors are bfloat16 except the float32 biases and the mask bytes.
// [lo, hi) is the valid window in in-clip rows, [0, clip_rows) for none.

// K1 (bf16): one trunk layer forward with its mask bytes.
int ast_trunk_fwd_mma(const void* x, const void* wd, const void* bd, const void* wr,
                      const void* br, void* out, void* mask, void* inmask, int rows,
                      int clip_rows, int d, int lo, int hi, void* stream) {
  return launch_fwd<true>(x, wd, bd, wr, br, out, mask, inmask, rows, clip_rows, d, lo, hi,
                          stream);
}

// K2 (bf16): both backward phases for one layer; `dy` is caller-allocated scratch.
int ast_trunk_bwd_mma(const void* dxn, const void* dtap, const void* mask,
                      const void* inmask, const void* wd, const void* wr, void* dy, void* dx,
                      int rows, int clip_rows, int d, int lo, int hi, void* stream) {
  const int e = trunk_bwd_dy(dxn, dtap, mask, wr, dy, rows, clip_rows, lo, hi, stream);
  if (e != 0) return e;
  return launch_dx<false>(dxn, dtap, dy, inmask, nullptr, wd, dx, rows, clip_rows, d, lo, hi,
                          stream);
}

// K7f (bf16): one encoder block forward, output only.
int ast_encoder_fwd_mma(const void* x, const void* wd, const void* bd, const void* wr,
                        const void* br, void* out, int rows, int clip_rows, int d, int lo,
                        int hi, void* stream) {
  return launch_fwd<false>(x, wd, bd, wr, br, out, nullptr, nullptr, rows, clip_rows, d, lo,
                           hi, stream);
}

// K7b (bf16): the block's dx from its input x and output cotangent g; `dy`
// is caller-allocated scratch. Phase 2 gates by x > 0.
int ast_encoder_bwd_mma(const void* x, const void* g, const void* wd, const void* bd,
                        const void* wr, void* dy, void* dx, int rows, int clip_rows, int d,
                        int lo, int hi, void* stream) {
  const int e = encoder_bwd_dy(x, g, wd, bd, wr, dy, rows, clip_rows, d, lo, hi, stream);
  if (e != 0) return e;
  return launch_dx<true>(g, nullptr, dy, nullptr, x, wd, dx, rows, clip_rows, d, lo, hi, stream);
}

}  // extern "C"
