// Grouped wavefront trunk backward (K2-wf) for bfloat16 on the tensor cores:
// the waveform cotangent through k <= 4 consecutive trunk layers in one
// launch. trunk_wf.cu holds the float32 FMA kernel of the same function.
//
// Replaces, for bfloat16 tensors:
// audio_style_transfer_tpu/ops/pallas_chain.py::_bwd_group_kernel_wf (the
// wavefront schedule of the mask-only backward, chosen when
// AST_CHAIN_BWD_WAVEFRONT=1 and the group fits the block), its windowed
// branch included.
//
// What it computes: exactly k launches of the tensor-core K2 (trunk_mma.cu,
// phase 1 then phase 2), layer j0+k-1 down to j0:
//   g  = round(dx_{j+1} + dtap_j), zero outside the valid window [lo, hi)
//   dy = round((g @ Wr_j^T) * gate_j)
//   dr = dy[t-d] W2^T + dy[t] W1^T + dy[t+d] W0^T
//   dx_j = round(g + round(dr) * inrelu_j)
// Every sum is row-local and runs K2's fragment code in K2's order (phase 1:
// k-chunks 0..7 against Wr^T; phase 2: taps p = 0, 1, 2 against W_{2-p},
// k-chunks 0..7 each, into one accumulator), with K2's cast points, so the
// result equals the k K2 launches bit for bit. Rows outside their clip read
// as zero (SAME padding per clip); the window and the clip are taken from
// each row's global in-clip position, halo rows included.
//
// Design. The TPU kernel splits every step into two pieces so that its MXU
// and VPU overlap inside one core; on Hopper the warps of a block already run
// side by side, so a step here is serial: phase 1 over its dy rows, a
// barrier, phase 2 over its output rows.
//  - A block owns `tile` rows plus a halo of nk = sum(d) rows each side, in
//    carry rows [0, ext), ext = tile + 2 nk (row nk is the tile's first).
//    Step s (layer j = k-1-s, dilation d) computes dy on [lo - d, hi + d) and
//    dx_j on [lo, hi) = [nk - n_j, nk + tile + n_j), n_j = d_0 + ... +
//    d_{j-1}. Halo rows are recomputed by the neighbouring blocks.
//  - The carry holds g of the current layer and is updated in place: phase
//    1 reads all of its rows before the barrier, and phase 2's epilogue
//    reads and then writes each row in the same thread, writing the next
//    layer's g = round(dx_j + dtap_{j-1}) (zero outside the window and the
//    clip). The last step writes dx to device memory; the cotangents between
//    the layers never leave shared memory.
//  - 10 warps; a warp owns a 16-row fragment by all 128 columns (16
//    accumulator tiles of mma.sync.m16n8k16). Phase 1's fragments go round
//    the warps; phase 2 has one fragment a warp (the group's geometry
//    guarantees at most 10), whose accumulators live through the barrier
//    after which dr is staged in dy's buffer. Fragments start at any carry
//    row: ldmatrix takes a row address per lane, and the chunk swizzle is
//    keyed on the buffer row. Rows past a step's range are computed and
//    dropped; a valid row never reads them.
//  - A layer's four weights are resident (Wr in slot 3, W_{2-p} in slot p),
//    loaded with 16-byte cp.async: the next layer's Wr as soon as phase 1 is
//    done (under phase 2), its taps as soon as phase 2's products are done
//    (under the epilogue and the next phase 1).
//  - Mask bytes (the gate in phase 1, the input relu in the epilogue) and
//    tap cotangents are read from device memory at the row's global index,
//    16 bytes an item, only for rows inside the tile's clip; a thread issues
//    the loads of its 4 items before it uses the first (on an H100 80GB
//    HBM3: 0.058 ms a group, against 0.0650 loading item by item).
//
// Shared memory: 4 weights of 32 KB, and the carry and dy buffers of ext + 16
// rows of 256 B each (fragments run up to 15 rows past a range). Dilations
// (1, 2, 4, 8) at tile 128 (nk = 15, ext = 158): 131,072 + 2 x 44,544 =
// 220,160 B of the 232,448 a block may use: one block an SM, 128 blocks at
// T=16384, one wave on 132 SMs. Rows are computed in 16-row fragments, so the
// halo costs 142 fragment-products a block against the 128 of four K2
// launches (1.11x). Every block reads the group's weights from L2: (rows /
// tile) x k x 128 KB, 64 MB a group at T=16384, as much as the four K2
// launches read.
//
// What bounds it on the H100 (T=16384, C=128, k=4, bf16): 16 [16384,128] x
// [128,128] products, 8.6 GFLOP at 989 TFLOP/s: 8.7 us; bytes (dx in and out,
// the group's tap cotangents, k + 1 mask arrays, the weights): 25-35 MB at
// 3.35 TB/s, 7.5-10.6 us. Bytes and operations are about even.

#include "mma_tiles.h"

namespace {

constexpr int MAXK = 4;      // layers per group
constexpr int NW = 10;       // warps per block
constexpr int NTW = NW * 32;  // threads per block
constexpr int SMEM_BLOCK = 232448;

struct WfMmaArgs {
  const bf16* dxn;
  const bf16* dtap[MAXK];     // tap cotangent per local layer, may be null
  const uint8_t* mask[MAXK];  // mask bytes per local layer
  const uint8_t* inmask;      // bit 0: the group input > 0
  const bf16* wd;             // [k, 3, C, C] of the group
  const bf16* wr;             // [k, C, C]
  bf16* dx;
  int d[MAXK];
  int prefix[MAXK + 1];  // n_j
  int k, tile, rows, clip_rows;
  int lo, hi;  // the valid window in in-clip rows
};

// Layer j's Wr into slot 3, one commit group.
__device__ __forceinline__ void stage_wr(uint32_t wsm, const WfMmaArgs& a, int j) {
  stage_weight<NTW>(wsm + 3 * WBYTES, a.wr + (long)j * C * C);
  cp_async_commit();
}

// Layer j's dilated-conv taps, W_{2-p} into slot p, one commit group.
__device__ __forceinline__ void stage_wd(uint32_t wsm, const WfMmaArgs& a, int j) {
  for (int p = 0; p < 3; ++p)
    stage_weight<NTW>(wsm + p * WBYTES, a.wd + ((long)j * 3 + 2 - p) * C * C);
  cp_async_commit();
}

__device__ __forceinline__ bool in_clip(int pos, int clip_rows) {
  return pos >= 0 && pos < clip_rows;
}

// g = round(x + tap) (x alone without a tap cotangent), zero where `keep` is false.
__device__ __forceinline__ Row16 g_of(Row16 x, const Row16& tap, bool has_tap, bool keep) {
  if (!keep) return Row16{};
  if (has_tap) {
#pragma unroll
    for (int e = 0; e < 8; ++e) x.w[e] = add2(x.w[e], tap.w[e]);
  }
  return x;
}

// The epilogues below take 4 items (a row's 16 columns) a thread and issue
// all their device-memory loads before the first use, so that the loads'
// latencies overlap.
constexpr int ITEMS = 4;

__global__ void __launch_bounds__(NTW, 1) trunk_bwd_wf_mma_kernel(const WfMmaArgs a) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int nk = a.prefix[a.k];
  const int ext = a.tile + 2 * nk;
  uint8_t* const carry = smem + 4 * WBYTES;
  uint8_t* const dyb = carry + (ext + 16) * ROWB;
  const uint32_t wsm = smem_addr(smem), carry_s = smem_addr(carry), dy_s = smem_addr(dyb);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // Carry row c is global row row0 + c - nk, at in-clip position pos0 + c - nk.
  const long row0 = (long)blockIdx.x * a.tile;
  const int pos0 = (int)(row0 % a.clip_rows);

  // Commit groups in order: Wr and the taps of the last layer, then per step
  // the next layer's Wr and taps.
  stage_wr(wsm, a, a.k - 1);
  stage_wd(wsm, a, a.k - 1);

  // g of the last layer on all carry rows, from the group output's cotangent.
  // [lo, hi) lies inside the clip, so a kept row is a row of the array.
  const bf16* const dtap_last = a.dtap[a.k - 1];
  for (int i0 = threadIdx.x; i0 < ext * 8; i0 += ITEMS * NTW) {
    Row16 x[ITEMS], tp[ITEMS];
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int i = i0 + it * NTW, c = i >> 3, pos = pos0 + c - nk;
      const long idx = (row0 + c - nk) * C + (i & 7) * 16;
      x[it] = tp[it] = Row16{};
      if (i < ext * 8 && pos >= a.lo && pos < a.hi) {
        x[it] = load16_global(a.dxn, idx);
        if (dtap_last) tp[it] = load16_global(dtap_last, idx);
      }
    }
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int i = i0 + it * NTW, c = i >> 3, pos = pos0 + c - nk;
      if (i < ext * 8)
        store16_smem(carry, c, i & 7, g_of(x[it], tp[it], dtap_last, pos >= a.lo && pos < a.hi));
    }
  }

  for (int s = 0; s < a.k; ++s) {
    const int j = a.k - 1 - s, d = a.d[j];
    const int lo = nk - a.prefix[j], hi = nk + a.tile + a.prefix[j];
    const int ylo = lo - d, yhi = hi + d;

    // Wr_j has landed (the taps may still be in flight) and the carry holds
    // g_j on [ylo, yhi).
    cp_async_wait(1);
    __syncthreads();

    // Phase 1: dy = round((g @ Wr^T) * gate) on [ylo, yhi), zero outside the clip.
    for (int f = warp; 16 * f < yhi - ylo; f += NW) {
      const int r0 = ylo + 16 * f;
      float acc[16][4];
      zero(acc);
      tap_product<true, false>(acc, carry_s, r0, wsm + 3 * WBYTES, true, true, lane);
      uint4 m[ITEMS];
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        const int i = it * 32 + lane;
        const int c = r0 + (i >> 3), pos = pos0 + c - nk;
        m[it] = make_uint4(0u, 0u, 0u, 0u);
        if (c < yhi && in_clip(pos, a.clip_rows))
          m[it] = *reinterpret_cast<const uint4*>(a.mask[j] + (row0 + c - nk) * C + (i & 7) * 16);
      }
      stage_acc(dyb, acc, nullptr, r0, lane);
      __syncwarp();
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        const int i = it * 32 + lane;
        const int c = r0 + (i >> 3), cg = i & 7, pos = pos0 + c - nk;
        if (c >= yhi) continue;
        Row16 r{};
        if (in_clip(pos, a.clip_rows)) {
          r = load16_smem(dyb, c, cg);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (!(mask_byte(m[it], e, false) & 2u)) r.w[e] &= 0xffff0000u;
            if (!(mask_byte(m[it], e, true) & 2u)) r.w[e] &= 0x0000ffffu;
          }
        }
        store16_smem(dyb, c, cg, r);
      }
    }

    // dy is complete and the taps have landed; every warp is past Wr_j.
    cp_async_wait(0);
    __syncthreads();
    if (j > 0) stage_wr(wsm, a, j - 1);

    // Phase 2: dr on [lo, hi), one fragment a warp.
    const int r0 = lo + 16 * warp;
    const bool mine = r0 < hi;
    float acc[16][4];
    zero(acc);
    if (mine) {
      const int pr = pos0 + r0 + (lane >> 2) - nk;  // the thread's fragment row g
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const int off = (p - 1) * d;
        tap_product<true, false>(acc, dy_s, r0 + off, wsm + p * WBYTES,
                                 in_clip(pr + off, a.clip_rows),
                                 in_clip(pr + 8 + off, a.clip_rows), lane);
      }
    }

    // Every warp is past its products: dy's buffer stages dr, and the tap
    // slots take the next layer's taps.
    __syncthreads();
    if (j > 0) stage_wd(wsm, a, j - 1);
    if (!mine) continue;
    // The input relu mask, and the next layer's tap cotangent.
    const uint8_t* const inmask = j > 0 ? a.mask[j - 1] : a.inmask;
    const bf16* const dtap_next = j > 0 ? a.dtap[j - 1] : nullptr;
    uint4 m[ITEMS];
    Row16 tp[ITEMS];
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int i = it * 32 + lane;
      const int c = r0 + (i >> 3), pos = pos0 + c - nk;
      const long idx = (row0 + c - nk) * C + (i & 7) * 16;
      m[it] = make_uint4(0u, 0u, 0u, 0u);
      tp[it] = Row16{};
      if (c < hi && in_clip(pos, a.clip_rows)) {
        m[it] = *reinterpret_cast<const uint4*>(inmask + idx);
        if (dtap_next) tp[it] = load16_global(dtap_next, idx);
      }
    }
    stage_acc(dyb, acc, nullptr, r0, lane);
    __syncwarp();
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int i = it * 32 + lane;
      const int c = r0 + (i >> 3), cg = i & 7, pos = pos0 + c - nk;
      if (c >= hi) continue;
      const Row16 dr = load16_smem(dyb, c, cg);
      const Row16 gr = load16_smem(carry, c, cg);
      Row16 o;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float r0v = (mask_byte(m[it], e, false) & 1u) ? bf_lo(dr.w[e]) : 0.f;
        const float r1v = (mask_byte(m[it], e, true) & 1u) ? bf_hi(dr.w[e]) : 0.f;
        o.w[e] = pack2(bf_lo(gr.w[e]) + r0v, bf_hi(gr.w[e]) + r1v);
      }
      if (j == 0)
        store16_global(a.dx, (row0 + c - nk) * C + cg * 16, o);
      else
        store16_smem(carry, c, cg, g_of(o, tp[it], dtap_next, pos >= a.lo && pos < a.hi));
    }
  }
}

size_t smem_bytes(const WfMmaArgs& a) {
  return 4UL * WBYTES + 2UL * (a.tile + 2 * a.prefix[a.k] + 16) * ROWB;
}

// The geometry ops/chain.py::plan_bwd_groups plans for this kernel; a launch
// outside it is refused.
bool feasible(const WfMmaArgs& a) {
  if (a.k < 2 || a.k > MAXK || a.tile <= 0 || a.tile % 16 || a.rows <= 0 ||
      a.clip_rows % a.tile || a.rows % a.clip_rows || a.lo < 0 || a.hi > a.clip_rows)
    return false;
  for (int j = 0; j < a.k; ++j)
    if (a.d[j] <= 0) return false;
  // Phase 2 of the first step has the most rows: one fragment a warp.
  if (a.tile + 2 * a.prefix[a.k - 1] > 16 * NW) return false;
  return smem_bytes(a) <= (size_t)SMEM_BLOCK;
}

}  // namespace

extern "C" {

// K2-wf (bf16, tensor cores): dx of the group's input from dxn, the
// cotangent of its output. The arguments of ast_trunk_bwd_group less the
// splits (this kernel does not split a step) and the type flag (bf16 only):
// dtaps and masks are host arrays of k device pointers (a dtap may be null),
// dils a host array of k ints. Returns cudaGetLastError() after the launch,
// cudaErrorInvalidValue for a geometry the kernel does not take. [lo, hi) is
// the valid window in in-clip rows, [0, clip_rows) for none.
int ast_trunk_bwd_group_mma(const void* dxn, const void* const* dtaps, const void* const* masks,
                            const void* inmask, const void* wd, const void* wr, void* dx,
                            const int* dils, int k, int tile, int rows, int clip_rows, int lo,
                            int hi, void* stream) {
  if (k < 2 || k > MAXK) return (int)cudaErrorInvalidValue;
  WfMmaArgs a;
  a.dxn = (const bf16*)dxn;
  a.inmask = (const uint8_t*)inmask;
  a.wd = (const bf16*)wd;
  a.wr = (const bf16*)wr;
  a.dx = (bf16*)dx;
  a.k = k;
  a.tile = tile;
  a.rows = rows;
  a.clip_rows = clip_rows;
  a.lo = lo;
  a.hi = hi;
  a.prefix[0] = 0;
  for (int j = 0; j < MAXK; ++j) {
    a.dtap[j] = j < k ? (const bf16*)dtaps[j] : nullptr;
    a.mask[j] = j < k ? (const uint8_t*)masks[j] : nullptr;
    a.d[j] = j < k ? dils[j] : 0;
    a.prefix[j + 1] = a.prefix[j] + a.d[j];
  }
  if (!feasible(a)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a);
  const cudaError_t e = cudaFuncSetAttribute(
      trunk_bwd_wf_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  trunk_bwd_wf_mma_kernel<<<rows / tile, NTW, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
