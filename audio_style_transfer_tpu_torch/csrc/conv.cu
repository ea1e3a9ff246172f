// The merged-taps operand of the bf16 dilated convolutions (ops/conv.py::_MergedTapsConv):
// out [B, T, F*C] from x [B, T, C], in one pass,
//   out[b, t, k*C + c] = x[b, t + o_k, c]   if 0 <= t + o_k < T, else 0,
// with o_k = o_0 + k * step: the forward's taps (ops/conv.py::_offsets), or their negations
// for the gradient of the input. cuBLAS then runs the whole convolution, or that gradient, as
// one product over the taps side by side. Every figure in this note is for one NVIDIA H100
// 80GB HBM3 at a 700 W power limit: 132 SMs, 3.35 TB/s.
//
// This replaces no TPU kernel: the JAX package leaves the convolution to XLA, whose conv
// reads the taps in place. The port built the operand with a `F.pad` of the whole input and a
// `torch.cat` of the F shifted views, which moved the data three times (the pad's copy, the
// cat's read of F strided views, its write) at about a third of the memory rate: about 176 ms
// of a 424 ms training step at 32 x 6144 rows, 149 packs a step (the 30 decoder blocks'
// forward, remat re-forward and input gradient, 90; the trunk's weight recompute, 59).
//
// What bounds it: bytes; it does no arithmetic. The least a pack moves is one read of x and
// one write of out: 0.201 GB + 0.604 GB for x [32, 6144, 512] at F=3 (0.240 ms), 0.403 GB +
// 1.208 GB for the cotangent [32, 6144, 1024] (0.481 ms), 28.8 ms for the decoder's 90 packs.
// The design:
//   - a thread owns one 16-byte piece (8 channels) of one output row's taps: it loads that piece
//     of the F input rows the taps read (F independent 16-byte loads), then stores the F; an
//     edge tap stores zeros and reads nothing. Neighbouring threads own neighbouring pieces of
//     a row, so each load and each store of a warp is a run of whole 32-byte sectors;
//   - the blocks walk the rows in order, so the F rows a row's taps read (at most
//     (F - 1) * dilation rows apart) are read again by rows a few megabytes of traffic later:
//     the re-reads hit the 50 MB L2, and device memory sees each input byte about once;
//   - no padded copy, no intermediate, no shared memory: the pack is a copy at the rate of
//     the memory, whatever F, the dilation or the direction of the offsets.
// Its time beside the bound and beside the old route: PERF.md (kernel table, row TP).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int VEC = 8;     // bf16 channels in a thread's 16-byte piece
constexpr int NT = 256;    // threads a block
constexpr int BATCH = 4;   // taps a thread has in flight before it stores them

// units = rows * cv pieces, rows = batch * t_len, cv = C / 8 pieces a row.
__global__ void __launch_bounds__(NT)
    taps_pack_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, int units, int t_len,
                     int cv, int f, int o0, int step) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= units) return;
  const int row = i / cv;
  const int v = i - row * cv;
  const int t = row % t_len;
  uint4* dst = out + (long)row * f * cv + v;
  for (int k0 = 0; k0 < f; k0 += BATCH) {
    uint4 piece[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int o = o0 + (k0 + j) * step;
      const bool inside = k0 + j < f && t + o >= 0 && t + o < t_len;
      piece[j] = inside ? x[(long)(row + o) * cv + v] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j)
      if (k0 + j < f) dst[(long)(k0 + j) * cv] = piece[j];
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). x [batch, t_len, c] and
// out [batch, t_len, f * c], bf16, contiguous and 16-byte aligned; c a multiple of 8, f >= 2,
// batch * t_len * c / 8 below 2^31. Tap k of row t reads x[t + o0 + k * step] of its clip.
int ast_taps_pack(const void* x, void* out, int batch, int t_len, int c, int f, int o0,
                  int step, void* stream) {
  if (batch < 1 || t_len < 1 || c < VEC || c % VEC || f < 2) return (int)cudaErrorInvalidValue;
  const long units = (long)batch * t_len * (c / VEC);
  if (units > INT_MAX - NT) return (int)cudaErrorInvalidValue;
  taps_pack_kernel<<<(unsigned)((units + NT - 1) / NT), NT, 0, (cudaStream_t)stream>>>(
      (const uint4*)x, (uint4*)out, (int)units, t_len, c / VEC, f, o0, step);
  return (int)cudaGetLastError();
}

}  // extern "C"
