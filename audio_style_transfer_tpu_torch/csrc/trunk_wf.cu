// Grouped wavefront trunk backward (K2-wf): the waveform cotangent through
// k <= 4 consecutive trunk layers in one launch, as float32 FMAs.
//
// Replaces, for float32 tensors:
// audio_style_transfer_tpu/ops/pallas_chain.py::_bwd_group_kernel_wf (the
// wavefront schedule of the mask-only backward, chosen when
// AST_CHAIN_BWD_WAVEFRONT=1 and the group's split geometry is feasible).
// bfloat16 runs the tensor-core kernel of trunk_wf_mma.cu, so only this
// kernel's float32 build is compiled.
//
// What it computes: exactly k calls of K2 (trunk.cu), layer j0+k-1 down to j0,
//   g  = round(dx_{j+1} + dtap_j)
//   dy = round((g @ Wr_j^T) * gate_j)
//   dr[t] = dy[t+d] W0^T + dy[t] W1^T + dy[t-d] W2^T
//   dx_j = round(g + round(dr * inrelu_j))
// with f32 accumulation and the same cast points, from the group output's
// cotangent, the tap cotangents of the layers inside the group, each layer's
// mask bytes (bit 0: x_{j+1} > 0, bit 1: gate) and the group input's relu
// mask. The cotangents between the layers never go to device memory: one
// read of dx, one write. With a valid window [lo, hi) of in-clip rows (the
// TPU kernel's `windowed` branch, _bwd_group_kernel_wf's multiply of the
// carry plus tap cotangent by _window_mask) g is zeroed on every other row,
// in both phases of every piece, as K2 zeroes it: the predicate takes the
// row's global in-clip position, so a window edge inside a block's halo
// cuts there too. [0, clip_rows) is the unwindowed kernel bit for bit.
//
// Design. The TPU kernel keeps a tile plus halo in a 13 MB VMEM window and
// relies on program order to make neighbouring pieces overlap; a Hopper block
// has 227 KB and its warps really run side by side:
//  - A block owns `tile` rows plus a halo of nk = sum(d) rows each side, in
//    carry coordinates [0, ext), ext = tile + 2 nk (row nk is the tile's
//    first). Step s (layer j = k-1-s) produces dx_j on [nk - n_j,
//    nk + tile + n_j), n_j = d_0 + ... + d_{j-1}. Rows outside the clip read
//    as zero (masks included), so they stay zero through every layer (SAME
//    padding per clip). Halo rows are recomputed by the neighbouring blocks.
//  - Each step is cut at split[s] into a left piece A_s and a right piece
//    B_s. The split recedes by d per step, so A_{s+1} reads only rows A_s
//    wrote. Two warp groups of 8 warps: one walks A_0 .. A_{k-1}, the other
//    B_0 .. B_{k-1}; A_{s+1} and B_s run at the same time. B_s waits for
//    A_{s-1} (it reads up to d rows left of its split) and A_s waits for
//    B_{s-2} (whose reads its writes would overtake), through named barriers
//    that the other group arrives on without waiting.
//  - The carry rotates over three slots in shared memory in the storage
//    type: step s reads slot (s-1) % 3 and writes slot s % 3; dx is loaded
//    into slot 2. The d rows of dy either side of a split are computed by
//    both groups.
//  - A piece is two phases on the group's own staging buffers: dy of its
//    rows plus d each side into a k-major float buffer (one product), then
//    the three transposed-conv products read that buffer shifted. Products
//    are float32 FMAs with trunk.cu's register tiles; 16-row groups a short
//    piece does not have are skipped.
//
// Shared memory: 2 x 53,888 B of staging plus 3 carry slots of
// ext * 128 * 4 B. With dilations (1, 2, 4, 8) (nk = 15): tile 64 would
// take 252,160 B and does not fit, so such a group runs at tile 32
// (203,008 B). The caller picks the tile.
//
// What bounds it on the H100 (T=16384, C=128, k=4, all four tap
// cotangents present): 16 [16384,128]x[128,128] products, 8.6 GFLOP of
// float32 FMA on the CUDA cores (67 TFLOP/s): 128 us; bytes (dx in and out,
// 4 tap cotangents, 5 mask arrays: 60.8 MB at 3.35 TB/s): 18.1 us. Bound by
// operations. The halo and the doubled split margin add to that, the more so
// at tile 32: each block recomputes the same 2 nk halo rows for half the
// output rows a 64-row tile would have.

#include "trunk_tiles.h"

namespace {

constexpr int MAXK = 4;          // layers per group
constexpr int WG = 256;          // threads per warp group
constexpr int NTB = 2 * WG;      // threads per block
constexpr int MT = 64;           // rows per product tile
constexpr int DYROWS = 80;       // dy rows a piece may hold (need + 15 <= DYROWS)
constexpr int DYLD = DYROWS + 1;
constexpr int SMEM_BLOCK = 232448;
// Named barriers (0 is __syncthreads): A_s done, B_s done, one per group.
constexpr int BAR_A_DONE = 1, BAR_B_DONE = 4, BAR_WG = 6;

struct WfArgs {
  const void* dxn;
  const void* dtap[MAXK];      // tap cotangent per local layer, may be null
  const uint8_t* mask[MAXK];   // mask bytes per local layer
  const uint8_t* inmask;       // bit 0: the group input > 0
  const void* wd;              // [k, 3, C, C] of the group
  const void* wr;              // [k, C, C]
  void* dx;
  int d[MAXK];
  int prefix[MAXK + 1];        // n_j
  int split[MAXK];             // by step s
  int k, tile, rows, clip_rows;
  int lo, hi;                  // the valid window in in-clip rows
};

struct Stage {  // one per warp group
  float a[KC][MT + 1];  // left operand chunk, k-major
  float b[KC][C + 1];   // weight chunk
  float dy[C][DYLD];    // the piece's dy, k-major, row 0 = carry row lo - d
};

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void mma_ni(int ni, float (&acc)[4][8], const float* A, int lda,
                                       const float (*B)[C + 1], int tx, int ty) {
  switch (ni) {
    case 1: mma_rows<1>(acc, A, lda, B, tx, ty); break;
    case 2: mma_rows<2>(acc, A, lda, B, tx, ty); break;
    case 3: mma_rows<3>(acc, A, lda, B, tx, ty); break;
    default: mma_rows<4>(acc, A, lda, B, tx, ty); break;
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// dx of step s on carry rows [lo, hi), by the warp group `wg`.
// Carry row c is global row row0 + c - nk, at clip position pos0 + c - nk.
template <typename T>
__device__ void piece(const WfArgs& p, Stage& st, T* carry, int wg, int tid, int s, int lo,
                      int hi, long row0, int pos0, int nk, int ext) {
  const int tx = tid & 15, ty = tid >> 4;
  const int j = p.k - 1 - s, d = p.d[j];
  const T* src = carry + (long)((s + 2) % 3) * ext * C;
  T* dst = carry + (long)(s % 3) * ext * C;
  const T* dtap = (const T*)p.dtap[j];
  const uint8_t* mask = p.mask[j];
  const uint8_t* inmask = j > 0 ? p.mask[j - 1] : p.inmask;
  const T* wr = (const T*)p.wr + (long)j * C * C;
  const T* wd = (const T*)p.wd + (long)j * 3 * C * C;
  const int dylo = lo - d, dyhi = hi + d;
  const bool last = s == p.k - 1;
  float acc[4][8];

  // The rows of src this group's previous piece wrote are visible.
  bar_sync(BAR_WG + wg, WG);

  // Phase 1: dy = round((g @ Wr^T) * gate) on [dylo, dyhi).
  for (int m0 = dylo; m0 < dyhi; m0 += MT) {
    const int nrows = min(MT, dyhi - m0);
    const int ni = (nrows + 15) / 16;
    zero(acc);
    for (int c0 = 0; c0 < C; c0 += KC) {
      for (int e = tid; e < KC * MT; e += WG) {
        const int r = e / KC, kk = e % KC;
        float v = 0.f;
        if (r < nrows) {
          const int c = m0 + r, pos = pos0 + c - nk;
          v = Io<T>::ld(src, (long)c * C + c0 + kk);
          if (dtap && pos >= 0 && pos < p.clip_rows)
            v = Io<T>::rnd(v + Io<T>::ld(dtap, (row0 + c - nk) * C + c0 + kk));
          if (pos < p.lo || pos >= p.hi) v = 0.f;
        }
        st.a[kk][r] = v;
      }
      stage_b<T>(st.b, wr, c0, true, tid, WG);
      bar_sync(BAR_WG + wg, WG);
      mma_ni(ni, acc, &st.a[0][0], MT + 1, st.b, tx, ty);
      bar_sync(BAR_WG + wg, WG);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      if (r >= nrows) continue;
      const int c = m0 + r, pos = pos0 + c - nk;
      const bool in_clip = pos >= 0 && pos < p.clip_rows;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = tx + 16 * jj;
        const float gate =
            in_clip ? (float)((mask[(row0 + c - nk) * C + col] >> 1) & 1) : 0.f;
        st.dy[col][m0 - dylo + r] = Io<T>::rnd(acc[i][jj] * gate);
      }
    }
  }

  // Phase 2: dx = round(g + round(dr * inrelu)) on [lo, hi).
  for (int m0 = lo; m0 < hi; m0 += MT) {
    const int nrows = min(MT, hi - m0);
    const int ni = (nrows + 15) / 16;
    zero(acc);
    for (int tap = 0; tap < 3; ++tap) {
      for (int c0 = 0; c0 < C; c0 += KC) {
        stage_b<T>(st.b, wd + (long)tap * C * C, c0, true, tid, WG);
        bar_sync(BAR_WG + wg, WG);
        mma_ni(ni, acc, &st.dy[c0][m0 - dylo + (1 - tap) * d], DYLD, st.b, tx, ty);
        bar_sync(BAR_WG + wg, WG);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      if (r >= nrows) continue;
      const int c = m0 + r, pos = pos0 + c - nk;
      const bool in_clip = pos >= 0 && pos < p.clip_rows;
      const bool in_win = pos >= p.lo && pos < p.hi;
      const long grow = row0 + c - nk;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = tx + 16 * jj;
        float g = Io<T>::ld(src, (long)c * C + col);
        if (dtap && in_clip) g = Io<T>::rnd(g + Io<T>::ld(dtap, grow * C + col));
        if (!in_win) g = 0.f;
        const float inrelu = in_clip ? (float)(inmask[grow * C + col] & 1) : 0.f;
        const float v = g + Io<T>::rnd(acc[i][jj] * inrelu);
        if (last)
          Io<T>::st((T*)p.dx, grow * C + col, v);
        else
          Io<T>::st(dst, (long)c * C + col, v);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NTB) trunk_bwd_wf_kernel(const WfArgs p) {
  extern __shared__ float smem_raw[];
  Stage* stages = reinterpret_cast<Stage*>(smem_raw);
  T* carry = reinterpret_cast<T*>(stages + 2);
  const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
  const int nk = p.prefix[p.k];
  const int ext = p.tile + 2 * nk;
  const long row0 = (long)blockIdx.x * p.tile;
  const int pos0 = (int)(row0 % p.clip_rows);

  // The group output's cotangent with its halo into slot 2 (= (0 - 1) mod 3).
  T* slot2 = carry + 2L * ext * C;
  for (int e = threadIdx.x; e < ext * C; e += NTB) {
    const int c = e / C, pos = pos0 + c - nk;
    float v = 0.f;
    if (pos >= 0 && pos < p.clip_rows)
      v = Io<T>::ld((const T*)p.dxn, (row0 + c - nk) * C + e % C);
    Io<T>::st(slot2, e, v);
  }
  __syncthreads();

  for (int s = 0; s < p.k; ++s) {
    const int nj = p.prefix[p.k - 1 - s];
    if (wg == 0) {
      if (s >= 2) bar_sync(BAR_B_DONE + s - 2, NTB);
      piece<T>(p, stages[0], carry, 0, tid, s, nk - nj, p.split[s], row0, pos0, nk, ext);
      if (s + 1 < p.k) bar_arrive(BAR_A_DONE + s, NTB);
    } else {
      if (s >= 1) bar_sync(BAR_A_DONE + s - 1, NTB);
      piece<T>(p, stages[1], carry, 1, tid, s, p.split[s], nk + p.tile + nj, row0, pos0, nk,
               ext);
      if (s + 2 < p.k) bar_arrive(BAR_B_DONE + s, NTB);
    }
  }
}

// The group's geometry as ops/chain.py::wavefront_splits plans it; a launch
// outside it is refused.
bool feasible(const WfArgs& a) {
  if (a.k < 2 || a.k > MAXK || a.tile <= 0 || a.clip_rows % a.tile || a.rows % a.clip_rows)
    return false;
  const int nk = a.prefix[a.k];
  for (int s = 0; s < a.k; ++s) {
    const int j = a.k - 1 - s, d = a.d[j], nj = a.prefix[j];
    const int lo = nk - nj, hi = nk + a.tile + nj, sp = a.split[s];
    if (d <= 0 || sp <= lo || sp >= hi) return false;
    if (sp - lo + 2 * d + 15 > DYROWS || hi - sp + 2 * d + 15 > DYROWS) return false;
    if (s + 1 < a.k && sp != a.split[s + 1] + a.d[j - 1]) return false;
  }
  return true;
}

template <typename T>
cudaError_t launch_wf(const WfArgs& a, cudaStream_t s) {
  const int ext = a.tile + 2 * a.prefix[a.k];
  const size_t smem = 2 * sizeof(Stage) + 3UL * ext * C * sizeof(T);
  if (smem > SMEM_BLOCK) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      trunk_bwd_wf_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  trunk_bwd_wf_kernel<T><<<a.rows / a.tile, NTB, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K2-wf: dx of the group's input from dxn, the cotangent of its output.
// dtaps and masks are host arrays of k device pointers (a dtap may be null),
// dils and splits host arrays of k ints (splits by backward step). Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for a geometry
// the kernel does not take. [lo, hi) is the valid window in in-clip rows,
// [0, clip_rows) for none.
int ast_trunk_bwd_group(const void* dxn, const void* const* dtaps, const void* const* masks,
                        const void* inmask, const void* wd, const void* wr, void* dx,
                        const int* dils, const int* splits, int k, int tile, int rows,
                        int clip_rows, int lo, int hi, void* stream) {
  if (k < 2 || k > MAXK) return (int)cudaErrorInvalidValue;
  WfArgs a;
  a.dxn = dxn;
  a.inmask = (const uint8_t*)inmask;
  a.wd = wd;
  a.wr = wr;
  a.dx = dx;
  a.k = k;
  a.tile = tile;
  a.rows = rows;
  a.clip_rows = clip_rows;
  a.lo = lo;
  a.hi = hi;
  a.prefix[0] = 0;
  for (int j = 0; j < MAXK; ++j) {
    a.dtap[j] = j < k ? dtaps[j] : nullptr;
    a.mask[j] = j < k ? (const uint8_t*)masks[j] : nullptr;
    a.d[j] = j < k ? dils[j] : 0;
    a.split[j] = j < k ? splits[j] : 0;
    a.prefix[j + 1] = a.prefix[j] + a.d[j];
  }
  if (!feasible(a)) return (int)cudaErrorInvalidValue;
  return (int)launch_wf<float>(a, (cudaStream_t)stream);
}

}  // extern "C"
