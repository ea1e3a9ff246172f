// Fragment, staging and epilogue code of the bfloat16 tensor-core kernels
// (trunk_mma.cu: K1, K2, K7f, K7b; trunk_wf_mma.cu: K2-wf), so that every
// kernel runs the same products in the same order: mma.sync.m16n8k16 (bf16
// in, f32 accumulate) with ldmatrix operands from shared memory, 16-byte
// cp.async staging of [C, C] weights and 256-byte activation rows whose
// 16-byte chunks are XOR-swizzled by row, and the rounding epilogue. K1, K7f,
// K2 and K7b's phase 2 take their A fragments and epilogues from here and run
// their products as wgmma, which sums each element as mma.sync does.
//
// A warp owns 16 rows by all 128 columns: 16 accumulator tiles of 16 x 8,
// acc[j] holding rows g, g + 8 (g = lane / 4) by columns 8 j + 2 t, + 1
// (t = lane % 4).
#pragma once

#include "ast_io.h"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int C = 128;            // trunk width
constexpr int ROWB = C * 2;       // bytes of one bf16 row
constexpr int WBYTES = C * ROWB;  // one [C, C] weight in shared memory
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
// either orientation (mma_kstep). By the block's kThreads threads.
template <int kThreads>
__device__ __forceinline__ void stage_weight(uint32_t dst, const bf16* __restrict__ w) {
  for (int i = threadIdx.x; i < C * 16; i += kThreads) {
    const int r = i >> 4, c = i & 15;
    cp_async16(dst + chunk_at(r, c), w + r * C + c * 8, 16);
  }
}

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
// to bf16 into rows [row0, row0 + 16) of the staging buffer at `stage`.
__device__ __forceinline__ void stage_acc(uint8_t* stage, const float (&acc)[16][4],
                                          const float* __restrict__ bias, int row0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int row = row0 + g;
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

__device__ __forceinline__ void store16_smem(uint8_t* buf, int row, int cg, const Row16& r) {
  *reinterpret_cast<uint4*>(buf + chunk_at(row, 2 * cg)) =
      make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
  *reinterpret_cast<uint4*>(buf + chunk_at(row, 2 * cg + 1)) =
      make_uint4(r.w[4], r.w[5], r.w[6], r.w[7]);
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

}  // namespace
