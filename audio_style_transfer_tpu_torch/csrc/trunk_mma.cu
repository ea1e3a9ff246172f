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
// What bounds it on the H100 (T=16384, C=128): a layer moves 10.6 MB (K1),
// 8.5 MB (K7f), 14.1 MB (K2) or 12.7 MB (K7b) against 2.15 GFLOP (K7b: 3.76,
// the conv again for the gate), so at tensor-core rates the bytes (3-4 us)
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
//  - Shared memory is unpadded (K1, K7f, K7b phase 1: 4 weights of 32 KB +
//    384 activation rows of 256 B = 224 KB of the 227 KB); the 16-byte chunk
//    c of row r sits at position c ^ (r & 7), so ldmatrix's eight rows fall
//    in eight different bank groups. For d < 128 the activation buffer is one
//    window of 128 + 2d rows; for d >= 128 three separate 128-row tiles.
//  - Clip edges and the array's end are applied to the A fragments in
//    registers (a row whose shifted source lies outside its clip is zeroed),
//    so a tile may hold rows of several clips and any rows / clip_rows / d.
//  - relu (K1) and g = dxn + dtap (K2) are applied to the A fragments in
//    registers; K1's v = relu(y + bd) never leaves registers: the accumulator
//    tiles 2k and 2k+1 are, register for register, the A fragment of k-chunk
//    k of the second product.
//  - K7b phase 1 has no room for a fifth 32 KB tile: g's 128 rows land in tap
//    0's weight slot, their own commit group, started once every warp is past
//    tap 0's product (the barrier before tap 1's), so they stream in under
//    taps 1 and 2. y's gate stays in registers: its 16 accumulator tiles and
//    those of g @ Wr^T have one fragment layout, so 64 gate bits a thread in
//    two registers select the second product's accumulators element for
//    element. The conv is K1's code in K1's order, so the gate is bit 1 of
//    K1's mask bytes, bit for bit.
//  - Epilogues stage the rounded product through shared memory (rows private
//    to the warp) and finish in a pass of 16 columns a thread: 16-byte loads
//    of the residual, cotangents and mask bytes, 16-byte stores.
//  - The fragment, staging and epilogue helpers are in mma_tiles.h, shared
//    with the grouped backward K2-wf (trunk_wf_mma.cu), which runs K2's
//    products in K2's order.

#include "mma_tiles.h"

namespace {

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

// y = acc + bd on accumulator tile j (rows g, g + 8 by columns 2t, 2t + 1),
// in float32, with its four gate bits y > 0 set in gate (4 bits a tile).
__device__ __forceinline__ float4 bias_gate(const float (&a)[4], const float* __restrict__ bd,
                                            int j, int t, uint32_t (&gate)[2]) {
  const float2 b = *reinterpret_cast<const float2*>(bd + j * 8 + 2 * t);
  const float4 y = make_float4(a[0] + b.x, a[1] + b.y, a[2] + b.x, a[3] + b.y);
  const uint32_t bits = (y.x > 0.f ? 1u : 0u) | (y.y > 0.f ? 2u : 0u) | (y.z > 0.f ? 4u : 0u) |
                        (y.w > 0.f ? 8u : 0u);
  gate[j >> 3] |= bits << ((j & 7) * 4);
  return y;
}

// The four gate bits of accumulator tile j, in the order of its registers.
__device__ __forceinline__ uint32_t gate_of(const uint32_t (&gate)[2], int j) {
  return (gate[j >> 3] >> ((j & 7) * 4)) & 0xfu;
}

// K1: one trunk layer forward with its mask bytes; kMasks = false is K7f,
// the same block writing its output only.
template <bool kMasks>
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
    stage_weight<NT>(wsm + p * WBYTES, wd + (long)p * C * C);
    win.stage(act, x, p, row0, rows);
    cp_async_commit();
  }
  stage_weight<NT>(wsm + 3 * WBYTES, wr);
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
    const float4 y = bias_gate(acc[j], bd, j, t, gate);
    v[j >> 1][(j & 1) * 2] = pack2(fmaxf(y.x, 0.f), fmaxf(y.y, 0.f));
    v[j >> 1][(j & 1) * 2 + 1] = pack2(fmaxf(y.z, 0.f), fmaxf(y.w, 0.f));
  }
  zero(acc);

  // Wr has landed; every warp is past the conv, so wd's buffers are free.
  cp_async_wait(0);
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) mma_kstep<false>(acc, v[kk], wsm + 3 * WBYTES, kk, lane);

  // Stage round(z + br) in wd[0]'s buffer and (K1) the gate bits, one byte
  // each, in wd[1]'s; rows private to the warp.
  uint8_t* const zst = smem;
  uint8_t* const gst = smem + WBYTES;
  stage_acc(zst, acc, br, warp * 16, lane);
  if (kMasks) {
    const int row = warp * 16 + g;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t bits = gate_of(gate, j);
      const uint32_t off = (j & 1) * 8 + 2 * t;
      *reinterpret_cast<uint16_t*>(gst + mchunk_at(row, j >> 1) + off) =
          (uint16_t)((bits & 1u) | ((bits & 2u) << 7));
      *reinterpret_cast<uint16_t*>(gst + mchunk_at(row + 8, j >> 1) + off) =
          (uint16_t)(((bits >> 2) & 1u) | ((bits & 8u) << 5));
    }
  }
  __syncwarp();

  // 16 columns a thread: out = x + z; K1: the mask bytes, the input's relu mask.
  const int xbase = win.base(1);
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int i = it * 32 + lane;
    const int row = warp * 16 + (i >> 3), cg = i & 7;
    const long grow = row0 + row;
    if (grow >= rows) continue;
    const Row16 zr = load16_smem(zst, row, cg);
    const Row16 xr = load16_smem(act_p, xbase + row, cg);
    const bool valid = in_window(grow, clip_rows, lo, hi);
    Row16 o;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o.w[e] = valid ? pack2(bf_lo(xr.w[e]) + bf_lo(zr.w[e]), bf_hi(xr.w[e]) + bf_hi(zr.w[e]))
                     : 0u;
    const long idx = grow * C + cg * 16;
    store16_global(out, idx, o);
    if (kMasks) {
      const uint4 gt = *reinterpret_cast<const uint4*>(gst + mchunk_at(row, cg));
      uint4 m = positive_bytes(o);
      m.x |= gt.x << 1, m.y |= gt.y << 1, m.z |= gt.z << 1, m.w |= gt.w << 1;
      *reinterpret_cast<uint4*>(mask + idx) = m;
      if (inmask) *reinterpret_cast<uint4*>(inmask + idx) = positive_bytes(xr);
    }
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

  stage_weight<NT>(wsm, wr);
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
  stage_acc(a1_p, acc, nullptr, warp * 16, lane);
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

// Phase 2 of K2 and K7b: dx = g + round(dr * inrelu),
// dr[t] = dy[t+d] W0^T + dy[t] W1^T + dy[t-d] W2^T, g = round(dxn + dtap).
// inrelu is bit 0 of the input mask bytes (K2) or, with kGateFromX (K7b),
// x > 0 from the block input xin.
template <bool kGateFromX>
__global__ void __launch_bounds__(NT, 1)
trunk_bwd_dx_mma_kernel(const bf16* __restrict__ dxn, const bf16* __restrict__ dtap,
                        const bf16* __restrict__ dy, const uint8_t* __restrict__ inmask,
                        const bf16* __restrict__ xin, const bf16* __restrict__ wd,
                        bf16* __restrict__ dx, int rows, int clip_rows, int d, int lo, int hi) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t wsm = smem_addr(smem), act = wsm + 3 * WBYTES;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const long row0 = (long)blockIdx.x * TM;
  const Window win(d);

  // Position p reads dy[t + (p - 1) d], which meets tap 2 - p's weight.
  for (int p = 0; p < 3; ++p) {
    stage_weight<NT>(wsm + p * WBYTES, wd + (long)(2 - p) * C * C);
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
  stage_acc(smem, acc, nullptr, warp * 16, lane);
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
    bool on[16];
    if (kGateFromX) {
      const Row16 xr = load16_global(xin, idx);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        on[2 * e] = bf_lo(xr.w[e]) > 0.f, on[2 * e + 1] = bf_hi(xr.w[e]) > 0.f;
    } else {
      const uint4 m = *reinterpret_cast<const uint4*>(inmask + idx);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        on[2 * e] = mask_byte(m, e, false) & 1u, on[2 * e + 1] = mask_byte(m, e, true) & 1u;
    }
    Row16 o;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float r0 = on[2 * e] ? bf_lo(dr.w[e]) : 0.f;
      const float r1 = on[2 * e + 1] ? bf_hi(dr.w[e]) : 0.f;
      o.w[e] = pack2(bf_lo(gr.w[e]) + r0, bf_hi(gr.w[e]) + r1);
    }
    store16_global(dx, idx, o);
  }
}

constexpr int FWD_SMEM = 4 * WBYTES + ACT_ROWS * ROWB;  // 229376 (K1, K7f, K7b phase 1)
constexpr int DY_SMEM = WBYTES + 2 * TM * ROWB;         // 98304
constexpr int DX_SMEM = 3 * WBYTES + ACT_ROWS * ROWB;   // 196608

template <typename K>
cudaError_t prepare(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int n_blocks(int rows) { return (rows + TM - 1) / TM; }

template <bool kMasks>
int launch_fwd(const void* x, const void* wd, const void* bd, const void* wr, const void* br,
               void* out, void* mask, void* inmask, int rows, int clip_rows, int d, int lo,
               int hi, void* stream) {
  const cudaError_t e = prepare(trunk_fwd_mma_kernel<kMasks>, FWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  trunk_fwd_mma_kernel<kMasks><<<n_blocks(rows), NT, FWD_SMEM, (cudaStream_t)stream>>>(
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
  trunk_bwd_dx_mma_kernel<kGateFromX><<<n_blocks(rows), NT, DX_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)dxn, (const bf16*)dtap, (const bf16*)dy, (const uint8_t*)inmask,
      (const bf16*)xin, (const bf16*)wd, (bf16*)dx, rows, clip_rows, d, lo, hi);
  return (int)cudaGetLastError();
}

// K2 phase 1: writes dy.
int trunk_bwd_dy(const void* dxn, const void* dtap, const void* mask, const void* wr, void* dy,
                 int rows, int clip_rows, int lo, int hi, void* stream) {
  const cudaError_t e = prepare(trunk_bwd_dy_mma_kernel, DY_SMEM);
  if (e != cudaSuccess) return (int)e;
  trunk_bwd_dy_mma_kernel<<<n_blocks(rows), NT, DY_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)dxn, (const bf16*)dtap, (const uint8_t*)mask, (const bf16*)wr, (bf16*)dy,
      rows, clip_rows, lo, hi);
  return (int)cudaGetLastError();
}

// K7b phase 1: dy from x (the gate recomputed) and g.
int encoder_bwd_dy(const void* x, const void* g, const void* wd, const void* bd, const void* wr,
                   void* dy, int rows, int clip_rows, int d, int lo, int hi, void* stream) {
  const cudaError_t e = prepare(encoder_bwd_dy_mma_kernel, FWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  encoder_bwd_dy_mma_kernel<<<n_blocks(rows), NT, FWD_SMEM, (cudaStream_t)stream>>>(
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
