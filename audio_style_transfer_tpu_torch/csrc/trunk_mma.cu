// Encoder trunk kernels for bfloat16 on the tensor cores: one residual block
// per launch, forward (K1) and the mask-only waveform backward (K2, two
// phases). trunk.cu holds the float32 path of the same functions and the
// arithmetic notes; this file computes the same sums with bf16 inputs and
// f32 accumulation, so no cast point moves.
//
// Replaces: audio_style_transfer_tpu/ops/pallas_chain.py::_fwd_group_kernel
// (K1) and ::_bwd_group_kernel (K2) for bfloat16 tensors.
//
//   K1:  out = x + round(relu_r(conv3_d(relu x) + bd) @ Wr + br), mask bytes
//        bit 0 = (out > 0), bit 1 = (y > 0); optionally inmask = (x > 0)
//   K2 phase 1:  dy = round((g @ Wr^T) * gate),  g = round(dxn + dtap)
//   K2 phase 2:  dx = g + round((dy[t+d] W0^T + dy[t] W1^T + dy[t-d] W2^T) * inrelu)
// Rows outside their clip read as zero (SAME padding). With a valid window
// [lo, hi) of in-clip rows (the TPU kernels' `windowed` branch; trunk.cu has
// the semantics) K1 zeroes out on the other rows before bit 0 is taken, and
// both phases of K2 zero g there: one predicate per row, in the epilogues
// and on phase 1's A fragments, beside the clip-edge predicate.
//
// What bounds it on the H100 (T=16384, C=128): a layer moves 10.6 MB (K1) or
// 14.1 MB (K2) against 2.15 GFLOP, so at tensor-core rates the bytes (3-4 us)
// and the launch decide, not the products.
//
// Design:
//  - A block of 256 threads owns 128 rows and loads the layer's weights once
//    (T=16384: 128 blocks, one wave on 132 SMs). Each of its 8 warps owns 16
//    rows by all 128 columns: 16 accumulator tiles of mma.sync.m16n8k16
//    (bf16 in, f32 out), 64 accumulator registers a thread.
//  - mma.sync with ldmatrix, not wgmma: wgmma reads B through a shared-memory
//    descriptor whose swizzle and strides cannot be checked without the card,
//    and its forward B (W[k][n], n contiguous) needs the transposing
//    descriptor form; ldmatrix(.trans) reads either weight orientation from
//    one staging layout with fragment layouts that are fixed by the PTX
//    manual. The cost is known: every warp reads the whole weight from shared
//    memory (8 x 32 KB per product and block), which bounds a layer at about
//    5 us of shared-memory reads; a warpgroup's wgmma would read it twice.
//  - All of a block's loads are started up front with 16-byte cp.async, one
//    commit group per tap (that tap's weight and the activation rows it
//    adds), then the residual weight; products of tap p start when group p
//    has landed. Rows past the array are zero-filled (src-size 0).
//  - Shared memory is unpadded (K1: 4 weights of 32 KB + 384 activation rows
//    of 256 B = 224 KB of the 227 KB); the 16-byte chunk c of row r sits at
//    position c ^ (r & 7), so ldmatrix's eight rows fall in eight different
//    bank groups. For d < 128 the activation buffer is one window of
//    128 + 2d rows; for d >= 128 three separate 128-row tiles.
//  - Clip edges and the array's end are applied to the A fragments in
//    registers (a row whose shifted source lies outside its clip is zeroed),
//    so a tile may hold rows of several clips and any rows / clip_rows / d.
//  - relu (K1) and g = dxn + dtap (K2) are applied to the A fragments in
//    registers; K1's v = relu(y + bd) never leaves registers: the accumulator
//    tiles 2k and 2k+1 are, register for register, the A fragment of k-chunk
//    k of the second product.
//  - Epilogues stage the rounded product through shared memory (rows private
//    to the warp) and finish in a pass of 16 columns a thread: 16-byte loads
//    of the residual, cotangents and mask bytes, 16-byte stores.

#include "ast_io.h"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int C = 128;            // trunk width
constexpr int TM = 128;           // rows per block
constexpr int NT = 256;           // threads per block: 8 warps of 16 rows
constexpr int ROWB = C * 2;       // bytes of one bf16 row
constexpr int WBYTES = C * ROWB;  // one [C, C] weight in shared memory
constexpr int ACT_ROWS = 3 * TM;  // activation buffer: a window or three tiles
constexpr int MROWB = C;          // bytes of one row of staged mask bytes

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` (0..3) of this thread's commit groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c[16x8] += a[16x16] b[16x8], bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 values in one register: the lower column in the low half.
__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// round(a + b) per half, the sum taken in float32 as torch and XLA take it.
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  return pack2(bf_lo(a) + bf_lo(b), bf_hi(a) + bf_hi(b));
}
// relu per half: a half with its sign bit set becomes zero.
__device__ __forceinline__ uint32_t relu2(uint32_t v) {
  return v & ~(((v >> 15) & 0x00010001u) * 0xffffu);
}

// Byte offset of the 16-byte chunk `c` of row `r` in a buffer of 256-byte rows.
__device__ __forceinline__ uint32_t chunk_at(int r, int c) {
  return (uint32_t)(r * ROWB + ((c ^ (r & 7)) << 4));
}
// The same for staged mask bytes: 128-byte rows of 8 chunks.
__device__ __forceinline__ uint32_t mchunk_at(int r, int c) {
  return (uint32_t)(r * MROWB + ((c ^ (r & 7)) << 4));
}

// Copy a [C, C] bf16 weight to shared memory, row by row as it lies in device
// memory (W[a][b], b contiguous), chunks swizzled. The products read it in
// either orientation (mma_kstep).
__device__ __forceinline__ void stage_weight(uint32_t dst, const bf16* __restrict__ w) {
  for (int i = threadIdx.x; i < C * 16; i += NT) {
    const int r = i >> 4, c = i & 15;
    cp_async16(dst + chunk_at(r, c), w + r * C + c * 8, 16);
  }
}

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

// Whether row `row` shifted by `off` stays inside its clip and the array.
__device__ __forceinline__ bool tap_ok(long row, long off, int rows, int clip_rows) {
  if (row >= rows) return false;
  const long pos = row % clip_rows + off;
  return pos >= 0 && pos < clip_rows;
}

// acc[16 rows, 128 cols] += a (the warp's 16 rows by k-chunk kk of 16) times
// rows [16 kk, 16 kk + 16) of B, where B[k][n] = W[k][n] (kTransposed false)
// or W[n][k] (true) and W is staged at `wsm` by stage_weight.
template <bool kTransposed>
__device__ __forceinline__ void mma_kstep(float (&acc)[16][4], const uint32_t (&a)[4],
                                          uint32_t wsm, int kk, int lane) {
  const int r = lane & 7, mat = lane >> 3;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {  // column tiles 2 jj and 2 jj + 1
    uint32_t b[4];
    if (!kTransposed) {
      // Shared rows are k: matrices (k lo, n lo), (k hi, n lo), (k lo, n hi),
      // (k hi, n hi), transposed on load into the B fragment.
      ldmatrix4_trans(b, wsm + chunk_at(kk * 16 + r + (mat & 1) * 8, jj * 2 + (mat >> 1)));
    } else {
      // Shared rows are n: matrices (n lo, k lo), (n lo, k hi), (n hi, k lo),
      // (n hi, k hi).
      ldmatrix4(b, wsm + chunk_at(jj * 16 + r + (mat >> 1) * 8, kk * 2 + (mat & 1)));
    }
    mma16816(acc[2 * jj], a, b[0], b[1]);
    mma16816(acc[2 * jj + 1], a, b[2], b[3]);
  }
}

// The A fragment of buffer rows [arow0, arow0 + 16), k-chunk kk.
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], uint32_t act, int arow0, int kk,
                                            int lane) {
  const int row = arow0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  ldmatrix4(a, act + chunk_at(row, kk * 2 + (lane >> 4)));
}

// acc += A[buffer rows arow0 .. +16] @ B over all of k, with A's row g (ok_lo)
// and row g + 8 (ok_hi) zeroed when their shifted source is outside the clip.
template <bool kTransposed, bool kRelu>
__device__ __forceinline__ void tap_product(float (&acc)[16][4], uint32_t act, int arow0,
                                            uint32_t wsm, bool ok_lo, bool ok_hi, int lane) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t a[4];
    load_a_frag(a, act, arow0, kk, lane);
    if (kRelu) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = relu2(a[i]);
    }
    if (!ok_lo) a[0] = a[2] = 0u;
    if (!ok_hi) a[1] = a[3] = 0u;
    mma_kstep<kTransposed>(acc, a, wsm, kk, lane);
  }
}

__device__ __forceinline__ void zero(float (&acc)[16][4]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
}

// Write the warp's accumulators (plus `bias` by column, may be null) rounded
// to bf16 into rows [16 warp, 16 warp + 16) of the staging tile at `stage`.
__device__ __forceinline__ void stage_acc(uint8_t* stage, const float (&acc)[16][4],
                                          const float* __restrict__ bias, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int row = warp * 16 + g;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float2 b = make_float2(0.f, 0.f);
    if (bias) b = *reinterpret_cast<const float2*>(bias + j * 8 + 2 * t);
    *reinterpret_cast<uint32_t*>(stage + chunk_at(row, j) + t * 4) =
        pack2(acc[j][0] + b.x, acc[j][1] + b.y);
    *reinterpret_cast<uint32_t*>(stage + chunk_at(row + 8, j) + t * 4) =
        pack2(acc[j][2] + b.x, acc[j][3] + b.y);
  }
}

// 16 consecutive bf16 values as eight registers.
struct Row16 {
  uint32_t w[8];
};

__device__ __forceinline__ Row16 load16(const uint8_t* lo, const uint8_t* hi) {
  Row16 r;
  const uint4 a = *reinterpret_cast<const uint4*>(lo);
  const uint4 b = *reinterpret_cast<const uint4*>(hi);
  r.w[0] = a.x, r.w[1] = a.y, r.w[2] = a.z, r.w[3] = a.w;
  r.w[4] = b.x, r.w[5] = b.y, r.w[6] = b.z, r.w[7] = b.w;
  return r;
}

// 16 columns of a staged row: chunks 2 cg and 2 cg + 1 of buffer row `row`.
__device__ __forceinline__ Row16 load16_smem(const uint8_t* buf, int row, int cg) {
  return load16(buf + chunk_at(row, 2 * cg), buf + chunk_at(row, 2 * cg + 1));
}

__device__ __forceinline__ Row16 load16_global(const bf16* __restrict__ p, long idx) {
  const uint8_t* q = reinterpret_cast<const uint8_t*>(p + idx);
  return load16(q, q + 16);
}

__device__ __forceinline__ void store16_global(bf16* __restrict__ p, long idx, const Row16& r) {
  uint4* q = reinterpret_cast<uint4*>(p + idx);
  q[0] = make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
  q[1] = make_uint4(r.w[4], r.w[5], r.w[6], r.w[7]);
}

// Byte 2 e (lo) / 2 e + 1 (hi) of 16 mask bytes held as four registers.
__device__ __forceinline__ uint32_t mask_byte(const uint4& m, int e, bool hi) {
  const uint32_t w = (e >> 1) == 0 ? m.x : (e >> 1) == 1 ? m.y : (e >> 1) == 2 ? m.z : m.w;
  return (w >> (((e & 1) * 2 + (hi ? 1 : 0)) * 8)) & 0xffu;
}

// One byte per value of r: 1 where the value is > 0.
__device__ __forceinline__ uint4 positive_bytes(const Row16& r) {
  uint32_t out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const uint32_t lo = bf_lo(r.w[e]) > 0.f ? 1u : 0u, hi = bf_hi(r.w[e]) > 0.f ? 1u : 0u;
    out[e >> 1] |= (lo | (hi << 8)) << ((e & 1) * 16);
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// K1: one trunk layer forward with its mask bytes.
__global__ void __launch_bounds__(NT, 1)
trunk_fwd_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wd,
                     const float* __restrict__ bd, const bf16* __restrict__ wr,
                     const float* __restrict__ br, bf16* __restrict__ out,
                     uint8_t* __restrict__ mask, uint8_t* __restrict__ inmask, int rows,
                     int clip_rows, int d, int lo, int hi) {
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* const act_p = smem + 4 * WBYTES;
  const uint32_t wsm = smem_addr(smem), act = smem_addr(act_p);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long row0 = (long)blockIdx.x * TM;
  const Window win(d);

  // Position p of the forward is tap p: relu(x)[t + (p - 1) d] @ wd[p].
  for (int p = 0; p < 3; ++p) {
    stage_weight(wsm + p * WBYTES, wd + (long)p * C * C);
    win.stage(act, x, p, row0, rows);
    cp_async_commit();
  }
  stage_weight(wsm + 3 * WBYTES, wr);
  cp_async_commit();

  float acc[16][4];
  zero(acc);
  const long r_lo = row0 + warp * 16 + g;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    cp_async_wait(3 - p);
    __syncthreads();
    const long off = (long)(p - 1) * d;
    tap_product<false, true>(acc, act, win.base(p) + warp * 16, wsm + p * WBYTES,
                             tap_ok(r_lo, off, rows, clip_rows),
                             tap_ok(r_lo + 8, off, rows, clip_rows), lane);
  }

  // y = acc + bd; the gate bits (4 per column tile: rows g, g + 8 by columns
  // 2t, 2t + 1); v = round(relu y) packed as the A fragments of v @ Wr.
  uint32_t gate[2] = {0u, 0u};
  uint32_t v[8][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bd + j * 8 + 2 * t);
    const float y0 = acc[j][0] + b.x, y1 = acc[j][1] + b.y;
    const float y2 = acc[j][2] + b.x, y3 = acc[j][3] + b.y;
    const uint32_t bits = (y0 > 0.f ? 1u : 0u) | (y1 > 0.f ? 2u : 0u) | (y2 > 0.f ? 4u : 0u) |
                          (y3 > 0.f ? 8u : 0u);
    gate[j >> 3] |= bits << ((j & 7) * 4);
    v[j >> 1][(j & 1) * 2] = pack2(fmaxf(y0, 0.f), fmaxf(y1, 0.f));
    v[j >> 1][(j & 1) * 2 + 1] = pack2(fmaxf(y2, 0.f), fmaxf(y3, 0.f));
  }
  zero(acc);

  // Wr has landed; every warp is past the conv, so wd's buffers are free.
  cp_async_wait(0);
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) mma_kstep<false>(acc, v[kk], wsm + 3 * WBYTES, kk, lane);

  // Stage round(z + br) in wd[0]'s buffer and the gate bits, one byte each,
  // in wd[1]'s; rows private to the warp.
  uint8_t* const zst = smem;
  uint8_t* const gst = smem + WBYTES;
  stage_acc(zst, acc, br, warp, lane);
  {
    const int row = warp * 16 + g;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t bits = (gate[j >> 3] >> ((j & 7) * 4)) & 0xfu;
      const uint32_t off = (j & 1) * 8 + 2 * t;
      *reinterpret_cast<uint16_t*>(gst + mchunk_at(row, j >> 1) + off) =
          (uint16_t)((bits & 1u) | ((bits & 2u) << 7));
      *reinterpret_cast<uint16_t*>(gst + mchunk_at(row + 8, j >> 1) + off) =
          (uint16_t)(((bits >> 2) & 1u) | ((bits & 8u) << 5));
    }
  }
  __syncwarp();

  // 16 columns a thread: out = x + z, the mask bytes, the input's relu mask.
  const int xbase = win.base(1);
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int i = it * 32 + lane;
    const int row = warp * 16 + (i >> 3), cg = i & 7;
    const long grow = row0 + row;
    if (grow >= rows) continue;
    const Row16 zr = load16_smem(zst, row, cg);
    const Row16 xr = load16_smem(act_p, xbase + row, cg);
    const uint4 gt = *reinterpret_cast<const uint4*>(gst + mchunk_at(row, cg));
    const bool valid = in_window(grow, clip_rows, lo, hi);
    Row16 o;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o.w[e] = valid ? pack2(bf_lo(xr.w[e]) + bf_lo(zr.w[e]), bf_hi(xr.w[e]) + bf_hi(zr.w[e]))
                     : 0u;
    const long idx = grow * C + cg * 16;
    store16_global(out, idx, o);
    uint4 m = positive_bytes(o);
    m.x |= gt.x << 1, m.y |= gt.y << 1, m.z |= gt.z << 1, m.w |= gt.w << 1;
    *reinterpret_cast<uint4*>(mask + idx) = m;
    if (inmask) *reinterpret_cast<uint4*>(inmask + idx) = positive_bytes(xr);
  }
}

// K2 phase 1: dy = round((g @ Wr^T) * gate), g = round(dxn + dtap).
__global__ void __launch_bounds__(NT, 1)
trunk_bwd_dy_mma_kernel(const bf16* __restrict__ dxn, const bf16* __restrict__ dtap,
                        const uint8_t* __restrict__ mask, const bf16* __restrict__ wr,
                        bf16* __restrict__ dy, int rows, int clip_rows, int lo, int hi) {
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* const a1_p = smem + WBYTES;
  const uint32_t wsm = smem_addr(smem), a1 = smem_addr(a1_p), a2 = a1 + TM * ROWB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long row0 = (long)blockIdx.x * TM;
  // The thread's fragment rows g and g + 8 of the warp's 16.
  const long r_lo = row0 + warp * 16 + (lane >> 2);
  const bool ok_lo = in_window(r_lo, clip_rows, lo, hi);
  const bool ok_hi = in_window(r_lo + 8, clip_rows, lo, hi);

  stage_weight(wsm, wr);
  stage_rows(a1, dxn, 0, TM, row0, rows);
  if (dtap) stage_rows(a2, dtap, 0, TM, row0, rows);
  cp_async_commit();
  cp_async_wait(0);
  __syncthreads();

  float acc[16][4];
  zero(acc);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t a[4];
    load_a_frag(a, a1, warp * 16, kk, lane);
    if (dtap) {
      uint32_t b[4];
      load_a_frag(b, a2, warp * 16, kk, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = add2(a[i], b[i]);
    }
    if (!ok_lo) a[0] = a[2] = 0u;
    if (!ok_hi) a[1] = a[3] = 0u;
    mma_kstep<true>(acc, a, wsm, kk, lane);
  }

  // The warp's own rows of dxn's tile become the staging rows.
  __syncwarp();
  stage_acc(a1_p, acc, nullptr, warp, lane);
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int i = it * 32 + lane;
    const int row = warp * 16 + (i >> 3), cg = i & 7;
    const long grow = row0 + row;
    if (grow >= rows) continue;
    const long idx = grow * C + cg * 16;
    Row16 r = load16_smem(a1_p, row, cg);
    const uint4 m = *reinterpret_cast<const uint4*>(mask + idx);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (!(mask_byte(m, e, false) & 2u)) r.w[e] &= 0xffff0000u;
      if (!(mask_byte(m, e, true) & 2u)) r.w[e] &= 0x0000ffffu;
    }
    store16_global(dy, idx, r);
  }
}

// K2 phase 2: dx = g + round(dr * inrelu),
// dr[t] = dy[t+d] W0^T + dy[t] W1^T + dy[t-d] W2^T, g = round(dxn + dtap).
__global__ void __launch_bounds__(NT, 1)
trunk_bwd_dx_mma_kernel(const bf16* __restrict__ dxn, const bf16* __restrict__ dtap,
                        const bf16* __restrict__ dy, const uint8_t* __restrict__ inmask,
                        const bf16* __restrict__ wd, bf16* __restrict__ dx, int rows,
                        int clip_rows, int d, int lo, int hi) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t wsm = smem_addr(smem), act = wsm + 3 * WBYTES;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const long row0 = (long)blockIdx.x * TM;
  const Window win(d);

  // Position p reads dy[t + (p - 1) d], which meets tap 2 - p's weight.
  for (int p = 0; p < 3; ++p) {
    stage_weight(wsm + p * WBYTES, wd + (long)(2 - p) * C * C);
    win.stage(act, dy, p, row0, rows);
    cp_async_commit();
  }

  float acc[16][4];
  zero(acc);
  const long r_lo = row0 + warp * 16 + g;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    cp_async_wait(2 - p);
    __syncthreads();
    const long off = (long)(p - 1) * d;
    tap_product<true, false>(acc, act, win.base(p) + warp * 16, wsm + p * WBYTES,
                             tap_ok(r_lo, off, rows, clip_rows),
                             tap_ok(r_lo + 8, off, rows, clip_rows), lane);
  }

  // Every warp is past its products: the first weight's buffer stages dr.
  __syncthreads();
  stage_acc(smem, acc, nullptr, warp, lane);
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int i = it * 32 + lane;
    const int row = warp * 16 + (i >> 3), cg = i & 7;
    const long grow = row0 + row;
    if (grow >= rows) continue;
    const long idx = grow * C + cg * 16;
    const Row16 dr = load16_smem(smem, row, cg);
    Row16 gr = load16_global(dxn, idx);
    if (dtap) {
      const Row16 tp = load16_global(dtap, idx);
#pragma unroll
      for (int e = 0; e < 8; ++e) gr.w[e] = add2(gr.w[e], tp.w[e]);
    }
    if (!in_window(grow, clip_rows, lo, hi)) {
#pragma unroll
      for (int e = 0; e < 8; ++e) gr.w[e] = 0u;
    }
    const uint4 m = *reinterpret_cast<const uint4*>(inmask + idx);
    Row16 o;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float lo = (mask_byte(m, e, false) & 1u) ? bf_lo(dr.w[e]) : 0.f;
      const float hi = (mask_byte(m, e, true) & 1u) ? bf_hi(dr.w[e]) : 0.f;
      o.w[e] = pack2(bf_lo(gr.w[e]) + lo, bf_hi(gr.w[e]) + hi);
    }
    store16_global(dx, idx, o);
  }
}

// One product alone, for testing the staging and fragment code:
// out[rows, C] (float32) = a[rows, C] @ (w or w^T).
template <bool kTransposed>
__global__ void __launch_bounds__(NT, 1)
product_mma_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                   float* __restrict__ out, int rows) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t wsm = smem_addr(smem), act = wsm + WBYTES;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long row0 = (long)blockIdx.x * TM;
  stage_weight(wsm, w);
  stage_rows(act, a, 0, TM, row0, rows);
  cp_async_commit();
  cp_async_wait(0);
  __syncthreads();
  float acc[16][4];
  zero(acc);
  tap_product<kTransposed, false>(acc, act, warp * 16, wsm, true, true, lane);
  const long r_lo = row0 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = j * 8 + 2 * t;
    if (r_lo < rows)
      *reinterpret_cast<float2*>(out + r_lo * C + col) = make_float2(acc[j][0], acc[j][1]);
    if (r_lo + 8 < rows)
      *reinterpret_cast<float2*>(out + (r_lo + 8) * C + col) = make_float2(acc[j][2], acc[j][3]);
  }
}

constexpr int FWD_SMEM = 4 * WBYTES + ACT_ROWS * ROWB;  // 229376
constexpr int DY_SMEM = WBYTES + 2 * TM * ROWB;         // 98304
constexpr int DX_SMEM = 3 * WBYTES + ACT_ROWS * ROWB;   // 196608
constexpr int PRODUCT_SMEM = WBYTES + TM * ROWB;        // 65536

template <typename K>
cudaError_t prepare(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int n_blocks(int rows) { return (rows + TM - 1) / TM; }

}  // namespace

extern "C" {

// Each entry returns cudaGetLastError() after its launches (0 on success).
// All tensors are bfloat16 except the float32 biases and the mask bytes.
// [lo, hi) is the valid window in in-clip rows, [0, clip_rows) for none.

// K1 (bf16): one trunk layer forward with its mask bytes.
int ast_trunk_fwd_mma(const void* x, const void* wd, const void* bd, const void* wr,
                      const void* br, void* out, void* mask, void* inmask, int rows,
                      int clip_rows, int d, int lo, int hi, void* stream) {
  const cudaError_t e = prepare(trunk_fwd_mma_kernel, FWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  trunk_fwd_mma_kernel<<<n_blocks(rows), NT, FWD_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)wd, (const float*)bd, (const bf16*)wr, (const float*)br,
      (bf16*)out, (uint8_t*)mask, (uint8_t*)inmask, rows, clip_rows, d, lo, hi);
  return (int)cudaGetLastError();
}

// K2 (bf16) phase 1 alone: writes dy.
int ast_trunk_bwd_dy_mma(const void* dxn, const void* dtap, const void* mask, const void* wr,
                         void* dy, int rows, int clip_rows, int lo, int hi, void* stream) {
  const cudaError_t e = prepare(trunk_bwd_dy_mma_kernel, DY_SMEM);
  if (e != cudaSuccess) return (int)e;
  trunk_bwd_dy_mma_kernel<<<n_blocks(rows), NT, DY_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)dxn, (const bf16*)dtap, (const uint8_t*)mask, (const bf16*)wr, (bf16*)dy,
      rows, clip_rows, lo, hi);
  return (int)cudaGetLastError();
}

// K2 (bf16) phase 2 alone: reads the dy phase 1 wrote.
int ast_trunk_bwd_dx_mma(const void* dxn, const void* dtap, const void* dy,
                         const void* inmask, const void* wd, void* dx, int rows, int clip_rows,
                         int d, int lo, int hi, void* stream) {
  const cudaError_t e = prepare(trunk_bwd_dx_mma_kernel, DX_SMEM);
  if (e != cudaSuccess) return (int)e;
  trunk_bwd_dx_mma_kernel<<<n_blocks(rows), NT, DX_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)dxn, (const bf16*)dtap, (const bf16*)dy, (const uint8_t*)inmask,
      (const bf16*)wd, (bf16*)dx, rows, clip_rows, d, lo, hi);
  return (int)cudaGetLastError();
}

// K2 (bf16): both backward phases for one layer; `dy` is caller-allocated scratch.
int ast_trunk_bwd_mma(const void* dxn, const void* dtap, const void* mask,
                      const void* inmask, const void* wd, const void* wr, void* dy, void* dx,
                      int rows, int clip_rows, int d, int lo, int hi, void* stream) {
  const int e = ast_trunk_bwd_dy_mma(dxn, dtap, mask, wr, dy, rows, clip_rows, lo, hi, stream);
  if (e != 0) return e;
  return ast_trunk_bwd_dx_mma(dxn, dtap, dy, inmask, wd, dx, rows, clip_rows, d, lo, hi,
                              stream);
}

// One product through the kernels' staging and fragment code:
// out (float32) = a @ w, or a @ w^T when `transposed`.
int ast_product_mma(const void* a, const void* w, void* out, int rows, int transposed,
                    void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (transposed) {
    const cudaError_t e = prepare(product_mma_kernel<true>, PRODUCT_SMEM);
    if (e != cudaSuccess) return (int)e;
    product_mma_kernel<true><<<n_blocks(rows), NT, PRODUCT_SMEM, s>>>(
        (const bf16*)a, (const bf16*)w, (float*)out, rows);
  } else {
    const cudaError_t e = prepare(product_mma_kernel<false>, PRODUCT_SMEM);
    if (e != cudaSuccess) return (int)e;
    product_mma_kernel<false><<<n_blocks(rows), NT, PRODUCT_SMEM, s>>>(
        (const bf16*)a, (const bf16*)w, (float*)out, rows);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
