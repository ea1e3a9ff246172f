// Encoder trunk kernels with float32 FMA products: one residual block per
// launch, forward (K1) and the mask-only waveform backward (K2).
//
// This file is the float32 path of K1, K2 and the per-layer encoder blocks
// K7f and K7b (TF32 would not keep float32's digits, so float32 products stay
// on the CUDA cores), and (through trunk_tiles.h) what the float32 grouped
// backward K2-wf is built on. For bfloat16 tensors K1, K2, K7f and K7b run on
// the tensor cores instead (trunk_mma.cu), so only the float32 build of these
// kernels is compiled; they stay templates on the storage type, which keeps
// their names (the trace readers sort kernels by name).
//
// Replaces: audio_style_transfer_tpu/ops/pallas_chain.py::_fwd_group_kernel
// (K1) and ::_bwd_group_kernel (K2). The TPU kernels chain groups of up to
// four layers in a 13 MB VMEM window; a Hopper block has 227 KB of shared
// memory, so this port runs one layer per launch and reads the three conv
// taps as three shifted [64, C] row slices of the layer input.
//
// Block:  x_{j+1} = x_j + relu(conv3_d(relu x_j) + bd) @ Wr + br   on [rows, 128]
// Masks:  one byte per element, bit 0 = (x_{j+1} > 0), bit 1 = (y_j > 0);
//         the first layer also writes the trunk input's relu mask (x_0 > 0).
// Backward (reads masks and cotangents, never activations), per layer:
//   g  = dx_{j+1} + dtap_j
//   dy = (g @ Wr^T) * gate                                   (phase 1)
//   dr[t] = dy[t+d] W0^T + dy[t] W1^T + dy[t-d] W2^T
//   dx_j = g + dr * inrelu                                   (phase 2)
// Rows outside their clip [0, T) read as zero (SAME padding).
//
// Valid window (the `windowed` branch of the TPU kernels, _window_mask): K1
// and K2 take in-clip rows [lo, hi), already clamped to the clip. K1 zeroes
// its output on every other row before the output's mask bit is taken and
// the tap is stored (the gate bit is unaffected); K2 zeroes g on those rows
// in both phases, so dy and the pass-through term vanish there. One
// predicate per row; the full range [0, clip_rows) is the unwindowed kernel
// bit for bit.
//
// Cast points mirror the JAX kernels so bf16 agrees: y accumulates in f32 and
// bd is added in f32; v = relu(y) is rounded to the storage type; z = v@Wr+br
// in f32; out = x + round(z); in the backward dy is rounded before the
// transposed conv, and dx_j = g + round(dr * inrelu).
//
// What bounds it on the H100 (T=16384, C=128, bf16): each layer does four
// [16384,128]x[128,128] products, 2.1 GFLOP, and moves about 10 MB (x in,
// out and mask out; the shifted re-reads hit L2). The products run as float32
// FMAs on the CUDA cores (67 TFLOP/s peak), so the kernel is compute-bound at
// roughly 32 us per layer and direction at best, against about 3 us for the
// bytes. This version keeps the arithmetic exact and simple (f32 FMA
// register tiles of 4x8 per thread, 64-row blocks, 16-deep K chunks staged in
// shared memory); the bfloat16 products of K1 and K2 run on the tensor cores
// in trunk_mma.cu. Chaining the small dilations of the backward in one launch
// is K2-wf (trunk_wf.cu).
//
// The per-layer encoder block (K7f forward, K7b backward) replaces
// audio_style_transfer_tpu/ops/pallas_encoder.py::_fwd_kernel and
// ::_bwd_kernel. It is the same residual block with no stashed masks:
//   K7f is K1's kernel with the mask writes compiled out (kMasks = false);
//   K7b recomputes the gate from x, as the TPU kernel does: its phase 1
//   (encoder_bwd_dy_kernel) runs K1's dilated conv on x to get y, then
//   dy = round((g @ Wr^T) * [y > 0]); its phase 2 is K2's phase 2 with the
//   input relu gate read as x > 0 (kGateFromX) instead of a mask byte.
// Both take the valid window as K1 and K2 do (JAX's masked(enc + d) on the
// per-layer path): K7f zeroes out, K7b zeroes g in both phases.
// The TPU kernel needs x with a 2d halo to recompute y on the rows its
// transposed conv reads; here phase 1 writes dy for every row to scratch and
// phase 2 reads it shifted, so no halo is held. K7b does seven products per
// layer against K2's four (3.76 GFLOP); bytes (x, g in; dy out and in; dx
// out) stay near 21 MB.

#include "trunk_tiles.h"

namespace {

constexpr int TM = 64;   // rows per block
constexpr int NT = 256;  // threads per block
// Thread (tx, ty), tx = tid % 16, ty = tid / 16, owns rows ty + 16 i (i < 4)
// and columns tx + 16 j (j < 8) of the block's [64, 128] output tile.

struct Smem {
  float a[KC][TM + 1];  // A chunk, k-major (padded against bank conflicts)
  float b[KC][C + 1];   // B chunk
  float v[C][TM + 1];   // forward: relu(y) of the tile, k-major
};

// Stage rows [row0, row0 + TM) shifted by `off` of src's channels
// [c0, c0 + KC) into sm.a, optionally through relu; zero outside the clip
// and past `rows`. `src2` (may be null) is added first, rounded to T. A
// source row whose in-clip position lies outside [lo, hi) reads as zero too
// (the valid window on g; [0, clip_rows) elsewhere).
template <typename T>
__device__ __forceinline__ void load_a(Smem& sm, const T* __restrict__ src,
                                       const T* __restrict__ src2, long row0, int off,
                                       int c0, int rows, int clip_rows, bool relu,
                                       int lo, int hi) {
  for (int e = threadIdx.x; e < KC * TM; e += NT) {
    const int r = e / KC, k = e % KC;
    const long row = row0 + r;
    float v = 0.f;
    if (row < rows) {
      const long pos = row % clip_rows + off;
      if (pos >= lo && pos < hi) {
        const long idx = (row + off) * C + c0 + k;
        v = Io<T>::ld(src, idx);
        if (src2) v = Io<T>::rnd(v + Io<T>::ld(src2, idx));
        if (relu) v = fmaxf(v, 0.f);
      }
    }
    sm.a[k][r] = v;
  }
}

// Stage a KC-deep chunk of a [C, C] weight into sm.b (see stage_b).
template <typename T>
__device__ __forceinline__ void load_b(Smem& sm, const T* __restrict__ w, int c0,
                                       bool transposed) {
  stage_b<T>(sm.b, w, c0, transposed, threadIdx.x, NT);
}

// acc += relu(x)[t-d] W0 + relu(x)[t] W1 + relu(x)[t+d] W2 over the block's
// rows (zero outside the clip).
template <typename T>
__device__ __forceinline__ void dilated_conv(float (&acc)[4][8], Smem& sm,
                                             const T* __restrict__ x,
                                             const T* __restrict__ wd, long row0, int rows,
                                             int clip_rows, int d, int tx, int ty) {
  for (int tap = 0; tap < 3; ++tap) {
    for (int c0 = 0; c0 < C; c0 += KC) {
      load_a<T>(sm, x, nullptr, row0, (tap - 1) * d, c0, rows, clip_rows, true, 0,
                clip_rows);
      load_b<T>(sm, wd + (long)tap * C * C, c0, false);
      __syncthreads();
      mma_chunk(acc, &sm.a[0][0], TM + 1, sm.b, tx, ty);
      __syncthreads();
    }
  }
}

// kMasks = false is K7f: the same block, writing the output only.
template <typename T, bool kMasks>
__global__ void __launch_bounds__(NT)
trunk_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wd,
                 const float* __restrict__ bd, const T* __restrict__ wr,
                 const float* __restrict__ br, T* __restrict__ out,
                 uint8_t* __restrict__ mask, uint8_t* __restrict__ inmask, int rows,
                 int clip_rows, int d, int lo, int hi) {
  extern __shared__ float smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long row0 = (long)blockIdx.x * TM;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  dilated_conv<T>(acc, sm, x, wd, row0, rows, clip_rows, d, tx, ty);

  uint32_t gate = 0;  // bit 8 i + j: y > 0
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx + 16 * j;
      const float y = acc[i][j] + bd[col];
      gate |= (y > 0.f ? 1u : 0u) << (8 * i + j);
      sm.v[col][ty + 16 * i] = Io<T>::rnd(fmaxf(y, 0.f));
      acc[i][j] = 0.f;
    }
  }
  __syncthreads();

  // z = v @ Wr
  for (int c0 = 0; c0 < C; c0 += KC) {
    load_b<T>(sm, wr, c0, false);
    __syncthreads();
    mma_chunk(acc, &sm.v[c0][0], TM + 1, sm.b, tx, ty);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long row = row0 + ty + 16 * i;
    if (row >= rows) continue;
    const bool valid = in_window(row, clip_rows, lo, hi);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx + 16 * j;
      const long idx = row * C + col;
      const float xv = Io<T>::ld(x, idx);
      const float o = valid ? Io<T>::rnd(xv + Io<T>::rnd(acc[i][j] + br[col])) : 0.f;
      Io<T>::st(out, idx, o);
      if (kMasks) {
        mask[idx] = (uint8_t)((o > 0.f ? 1 : 0) | (((gate >> (8 * i + j)) & 1u) << 1));
        if (inmask) inmask[idx] = (uint8_t)(xv > 0.f ? 1 : 0);
      }
    }
  }
}

// Phase 1: dy = round((g @ Wr^T) * gate), g = round(dx_next + dtap).
template <typename T>
__global__ void __launch_bounds__(NT)
trunk_bwd_dy_kernel(const T* __restrict__ dxn, const T* __restrict__ dtap,
                    const uint8_t* __restrict__ mask, const T* __restrict__ wr,
                    T* __restrict__ dy, int rows, int clip_rows, int lo, int hi) {
  extern __shared__ float smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long row0 = (long)blockIdx.x * TM;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += KC) {
    load_a<T>(sm, dxn, dtap, row0, 0, c0, rows, clip_rows, false, lo, hi);
    load_b<T>(sm, wr, c0, true);
    __syncthreads();
    mma_chunk(acc, &sm.a[0][0], TM + 1, sm.b, tx, ty);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long row = row0 + ty + 16 * i;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long idx = row * C + tx + 16 * j;
      const float gate = (float)((mask[idx] >> 1) & 1);
      Io<T>::st(dy, idx, acc[i][j] * gate);
    }
  }
}

// K7b phase 1: recompute y = conv3_d(relu x) + bd over the block's rows
// (no stashed masks), then dy = round((g @ Wr^T) * [y > 0]).
template <typename T>
__global__ void __launch_bounds__(NT)
encoder_bwd_dy_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      const T* __restrict__ wd, const float* __restrict__ bd,
                      const T* __restrict__ wr, T* __restrict__ dy, int rows, int clip_rows,
                      int d, int lo, int hi) {
  extern __shared__ float smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long row0 = (long)blockIdx.x * TM;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  dilated_conv<T>(acc, sm, x, wd, row0, rows, clip_rows, d, tx, ty);

  uint32_t gate = 0;  // bit 8 i + j: y > 0
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      gate |= (acc[i][j] + bd[tx + 16 * j] > 0.f ? 1u : 0u) << (8 * i + j);
      acc[i][j] = 0.f;
    }
  }

  for (int c0 = 0; c0 < C; c0 += KC) {
    load_a<T>(sm, g, nullptr, row0, 0, c0, rows, clip_rows, false, lo, hi);
    load_b<T>(sm, wr, c0, true);
    __syncthreads();
    mma_chunk(acc, &sm.a[0][0], TM + 1, sm.b, tx, ty);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long row = row0 + ty + 16 * i;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float on = (float)((gate >> (8 * i + j)) & 1u);
      Io<T>::st(dy, row * C + tx + 16 * j, acc[i][j] * on);
    }
  }
}

// Phase 2: dx = round(g + round(dr * inrelu)),
// dr[t] = dy[t+d] W0^T + dy[t] W1^T + dy[t-d] W2^T. inrelu is bit 0 of the
// input mask (K2) or, with kGateFromX (K7b), x > 0 from the block input.
template <typename T, bool kGateFromX>
__global__ void __launch_bounds__(NT)
trunk_bwd_dx_kernel(const T* __restrict__ dxn, const T* __restrict__ dtap,
                    const T* __restrict__ dy, const uint8_t* __restrict__ inmask,
                    const T* __restrict__ xin, const T* __restrict__ wd, T* __restrict__ dx,
                    int rows, int clip_rows, int d, int lo, int hi) {
  extern __shared__ float smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long row0 = (long)blockIdx.x * TM;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 3; ++tap) {
    for (int c0 = 0; c0 < C; c0 += KC) {
      load_a<T>(sm, dy, (const T*)nullptr, row0, (1 - tap) * d, c0, rows, clip_rows, false, 0,
                clip_rows);
      load_b<T>(sm, wd + (long)tap * C * C, c0, true);
      __syncthreads();
      mma_chunk(acc, &sm.a[0][0], TM + 1, sm.b, tx, ty);
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long row = row0 + ty + 16 * i;
    if (row >= rows) continue;
    const bool valid = in_window(row, clip_rows, lo, hi);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long idx = row * C + tx + 16 * j;
      float g = Io<T>::ld(dxn, idx);
      if (dtap) g = Io<T>::rnd(g + Io<T>::ld(dtap, idx));
      if (!valid) g = 0.f;
      const float inrelu = kGateFromX ? (Io<T>::ld(xin, idx) > 0.f ? 1.f : 0.f)
                                      : (float)(inmask[idx] & 1);
      Io<T>::st(dx, idx, g + Io<T>::rnd(acc[i][j] * inrelu));
    }
  }
}

template <typename K>
cudaError_t prepare(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sizeof(Smem));
}

int n_blocks(int rows) { return (rows + TM - 1) / TM; }

template <typename T, bool kMasks>
cudaError_t launch_fwd(const void* x, const void* wd, const void* bd, const void* wr,
                       const void* br, void* out, void* mask, void* inmask, int rows,
                       int clip_rows, int d, int lo, int hi, cudaStream_t s) {
  const cudaError_t e = prepare(trunk_fwd_kernel<T, kMasks>);
  if (e != cudaSuccess) return e;
  trunk_fwd_kernel<T, kMasks><<<n_blocks(rows), NT, sizeof(Smem), s>>>(
      (const T*)x, (const T*)wd, (const float*)bd, (const T*)wr, (const float*)br, (T*)out,
      (uint8_t*)mask, (uint8_t*)inmask, rows, clip_rows, d, lo, hi);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_trunk_bwd(const void* dxn, const void* dtap, const void* mask,
                             const void* inmask, const void* wd, const void* wr, void* dy,
                             void* dx, int rows, int clip_rows, int d, int lo, int hi,
                             cudaStream_t s) {
  cudaError_t e = prepare(trunk_bwd_dy_kernel<T>);
  if (e == cudaSuccess) e = prepare(trunk_bwd_dx_kernel<T, false>);
  if (e != cudaSuccess) return e;
  trunk_bwd_dy_kernel<T><<<n_blocks(rows), NT, sizeof(Smem), s>>>(
      (const T*)dxn, (const T*)dtap, (const uint8_t*)mask, (const T*)wr, (T*)dy, rows,
      clip_rows, lo, hi);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  trunk_bwd_dx_kernel<T, false><<<n_blocks(rows), NT, sizeof(Smem), s>>>(
      (const T*)dxn, (const T*)dtap, (const T*)dy, (const uint8_t*)inmask, nullptr,
      (const T*)wd, (T*)dx, rows, clip_rows, d, lo, hi);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_encoder_bwd(const void* x, const void* g, const void* wd, const void* bd,
                               const void* wr, void* dy, void* dx, int rows, int clip_rows,
                               int d, int lo, int hi, cudaStream_t s) {
  cudaError_t e = prepare(encoder_bwd_dy_kernel<T>);
  if (e == cudaSuccess) e = prepare(trunk_bwd_dx_kernel<T, true>);
  if (e != cudaSuccess) return e;
  encoder_bwd_dy_kernel<T><<<n_blocks(rows), NT, sizeof(Smem), s>>>(
      (const T*)x, (const T*)g, (const T*)wd, (const float*)bd, (const T*)wr, (T*)dy, rows,
      clip_rows, d, lo, hi);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  trunk_bwd_dx_kernel<T, true><<<n_blocks(rows), NT, sizeof(Smem), s>>>(
      (const T*)g, nullptr, (const T*)dy, nullptr, (const T*)x, (const T*)wd, (T*)dx, rows,
      clip_rows, d, lo, hi);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ast_error_string(int status) { return cudaGetErrorString((cudaError_t)status); }

// Each entry returns cudaGetLastError() after its launches (0 on success).

// K1: one trunk layer forward with its mask bytes; [lo, hi) is the valid
// window in in-clip rows, [0, clip_rows) for none. All tensors are float32
// except the mask bytes.
int ast_trunk_fwd(const void* x, const void* wd, const void* bd, const void* wr,
                  const void* br, void* out, void* mask, void* inmask, int rows,
                  int clip_rows, int d, int lo, int hi, void* stream) {
  return (int)launch_fwd<float, true>(x, wd, bd, wr, br, out, mask, inmask, rows, clip_rows, d,
                                      lo, hi, (cudaStream_t)stream);
}

// K2: both backward phases for one layer; `dy` is caller-allocated scratch;
// [lo, hi) as in ast_trunk_fwd.
int ast_trunk_bwd(const void* dxn, const void* dtap, const void* mask,
                  const void* inmask, const void* wd, const void* wr, void* dy, void* dx,
                  int rows, int clip_rows, int d, int lo, int hi, void* stream) {
  return (int)launch_trunk_bwd<float>(dxn, dtap, mask, inmask, wd, wr, dy, dx, rows, clip_rows,
                                      d, lo, hi, (cudaStream_t)stream);
}

// K7f: one encoder block forward, output only; [lo, hi) as in ast_trunk_fwd.
int ast_encoder_fwd(const void* x, const void* wd, const void* bd, const void* wr,
                    const void* br, void* out, int rows, int clip_rows, int d, int lo, int hi,
                    void* stream) {
  return (int)launch_fwd<float, false>(x, wd, bd, wr, br, out, nullptr, nullptr, rows,
                                       clip_rows, d, lo, hi, (cudaStream_t)stream);
}

// K7b: the block's dx from its input x and output cotangent g, recomputing
// the gate; `dy` is caller-allocated scratch; [lo, hi) as in ast_trunk_bwd.
int ast_encoder_bwd(const void* x, const void* g, const void* wd, const void* bd,
                    const void* wr, void* dy, void* dx, int rows, int clip_rows, int d, int lo,
                    int hi, void* stream) {
  return (int)launch_encoder_bwd<float>(x, g, wd, bd, wr, dy, dx, rows, clip_rows, d, lo, hi,
                                        (cudaStream_t)stream);
}

}  // extern "C"
