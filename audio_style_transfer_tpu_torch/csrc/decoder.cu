// The WaveNet decoder block's elementwise epilogues (models/wavenet_ae.py::_decoder_block),
// forward and backward: float32 or bf16 storage, float32 arithmetic. Every figure in this
// note is for one NVIDIA H100 80GB HBM3 at a 700 W power limit: 132 SMs, 3.35 TB/s.
//
// These replace no TPU kernel: the JAX package leaves the decoder to XLA, which fuses these
// elementwise ops into the neighbouring convolutions by itself. Eager PyTorch ran each as a
// pass of its own over [rows, 1024] tensors (two bias adds, the conditioning add, sigmoid and
// tanh over strided halves, their product, two more bias adds and the residual and skip adds;
// in the backward each op's gradient, the halves put back together, three bias sums), about
// 14 GB of traffic a block at the training shape, most of it intermediates.
//
// A block, with the products on cuBLAS and without their biases (ops/conv.py):
//   y = conv(l, W_dil) [rows, 2m], c = conv(encoding, W_cond) [frames, 2m],
//   r = gated @ W_res [rows, m], k = gated @ W_skip [rows, skip]; frame(row) = row / hop.
//   decoder_gate_fwd_kernel:     z = (y + b_dil) + (c + b_cond)[frame(row)],
//                                gated = sigmoid(z[:, :m]) * tanh(z[:, m:])
//   decoder_gate_bwd_kernel:     dz [rows, 2m] from y, c, the biases and dgated, and in the
//                                same pass dc[frame] = the sum of dz over the frame's rows
//                                (float32); both biases' gradients are dc's column sums
//   decoder_residual_fwd_kernel: l' = l + (r + b_res), s' = s + (k + b_skip), one launch
//   decoder_residual_bwd_kernel: the column sums of dl' and ds' (the gradients of b_res and
//                                b_skip) in float32, one launch; dl' and ds' themselves flow
//                                on to l, r, s and k unchanged, with no copy
//
// What bounds them: bytes. At the training shape (rows = 32 x 6144 = 196 608, m 512, skip 256,
// bf16) the gate forward reads y (403 MB) and writes gated (201 MB): 180 us at 3.35 TB/s; the
// gate backward reads y and dgated and writes dz (1007 MB): 301 us; the residual forward reads
// l, r, s, k and writes l', s' (906 MB): 270 us; the residual backward reads dl', ds' (302 MB):
// 90 us. c and the biases (1.5 MB) stay in L2. The sigmoid and tanh must be the accurate ones
// (expf, tanhf, an IEEE division) to equal the eager path: with the roundings that is on the
// order of a hundred instructions an element, so in bf16 the gate kernels are bound by their
// instruction rate rather than by bytes (in float32, twice the bytes for the same
// instructions, by bytes).
// The design:
//   - a thread owns 8 channels of a row (one 16-byte bf16 piece, two float32 ones) and, in the
//     gate, both halves of them: both 16-byte loads of y in one thread, so z, the activations
//     and their product live in registers and neither z nor a half is ever written. Neighbouring
//     threads own neighbouring pieces, so a warp reads whole 128-byte lines;
//   - rounding to the storage type where the eager bf16 path rounds (after each bias add, the
//     conditioning add, each activation, the product; in the backward after each product with
//     dgated and each activation's gradient), in registers at no cost, so the forward equals
//     eager PyTorch on the card bit for bit. sigmoid is 1 / (1 + expf(-z)) and tanh is tanhf,
//     in the order PyTorch's CUDA kernels compute them; the backward's formulas are those of
//     its sigmoid_backward and tanh_backward;
//   - both gate kernels' grid is (hop frame, channel slice of 64): a block owns a whole frame
//     for its slice (8 threads across the slice, 32 rows in flight), so a thread loads the
//     frame's c and the biases once, adds and rounds c + b_cond once, and walks its rows with
//     no division. The accurate sigmoid and tanh make these kernels instruction-bound in
//     bf16, so what a row does not have to redo counts. In the backward dc is summed in
//     float32 inside the block, rows in ascending order within a thread, then the 32 row
//     lanes in order through shared memory: no atomics, the same bits every run;
//   - the residual backward's blocks each sum a run of rows of a 64-column slice into a float32
//     partial sum; the last block of a slice to finish (a counter per slice, zeroed by the entry
//     point) adds the partials in order. One launch, deterministic.
//
// Registers a thread (nvcc -Xptxas -v, sm_90a; tools/kernel_resources.py) and the times are in
// PERF.md.

#include "ast_io.h"

namespace {

constexpr int VEC = 8;                 // channels a thread owns
constexpr int SLICE = 64;              // channels a block owns in the backward kernels
constexpr int LANES = SLICE / VEC;     // threads across a slice
constexpr int NT = 256;                // threads a block
constexpr int ROW_LANES = NT / LANES;  // rows in flight in a backward block

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static __device__ __forceinline__ void ld(const float* p, float (&v)[VEC]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
  static __device__ __forceinline__ void st(float* p, const float (&v)[VEC]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  // A bf16 is the upper half of its float32: widening is a shift.
  static __device__ __forceinline__ void ld(const __nv_bfloat16* p, float (&v)[VEC]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  // Rounds to nearest even, as torch does.
  static __device__ __forceinline__ void st(__nv_bfloat16* p, const float (&v)[VEC]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// torch's CUDA sigmoid: 1 / (1 + exp(-z)) in float32.
__device__ __forceinline__ float sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }

// z = (y + b_dil) + (c + b_cond), each add rounded as the eager path rounds it.
template <typename T>
__device__ __forceinline__ float pre(float y, float b, float cb) {
  return Io<T>::rnd(Io<T>::rnd(y + b) + cb);
}

// A thread's constants for its 8 channels of both halves over one frame: b_dil and
// c + b_cond, the latter rounded as the eager path rounds it.
template <typename T>
struct FrameConsts {
  float da[VEC], db[VEC], ca[VEC], cb[VEC];
  __device__ __forceinline__ void load(const T* c_row, const T* b_dil, const T* b_cond, int m,
                                       int j) {
    float ea[VEC], eb[VEC];
    Vec<T>::ld(c_row + j, ca);
    Vec<T>::ld(c_row + m + j, cb);
    Vec<T>::ld(b_dil + j, da);
    Vec<T>::ld(b_dil + m + j, db);
    Vec<T>::ld(b_cond + j, ea);
    Vec<T>::ld(b_cond + m + j, eb);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      ca[e] = Io<T>::rnd(ca[e] + ea[e]);
      cb[e] = Io<T>::rnd(cb[e] + eb[e]);
    }
  }
};

// Grid (frame, 64-channel slice): the block walks the frame's rows, 32 at a time, with the
// frame's constants in registers.
template <typename T>
__global__ void __launch_bounds__(NT)
    decoder_gate_fwd_kernel(const T* __restrict__ y, const T* __restrict__ c,
                            const T* __restrict__ b_dil, const T* __restrict__ b_cond,
                            T* __restrict__ gated, int m, int hop) {
  const int lane = threadIdx.x % LANES, rl = threadIdx.x / LANES;
  const int j = blockIdx.y * SLICE + lane * VEC;
  if (j >= m) return;
  const long frame = blockIdx.x;
  const long width = 2L * m;
  FrameConsts<T> k;
  k.load(c + frame * width, b_dil, b_cond, m, j);
  for (int t = rl; t < hop; t += ROW_LANES) {
    const long row = frame * hop + t;
    float ya[VEC], yb[VEC], g[VEC];
    Vec<T>::ld(y + row * width + j, ya);
    Vec<T>::ld(y + row * width + m + j, yb);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float s = Io<T>::rnd(sigmoid(pre<T>(ya[e], k.da[e], k.ca[e])));
      const float th = Io<T>::rnd(tanhf(pre<T>(yb[e], k.db[e], k.cb[e])));
      g[e] = s * th;
    }
    Vec<T>::st(gated + row * m + j, g);
  }
}

// The same grid; dc's column sums over the frame finish inside the block.
template <typename T>
__global__ void __launch_bounds__(NT)
    decoder_gate_bwd_kernel(const T* __restrict__ y, const T* __restrict__ c,
                            const T* __restrict__ b_dil, const T* __restrict__ b_cond,
                            const T* __restrict__ dgated, T* __restrict__ dz,
                            float* __restrict__ dc, int m, int hop) {
  __shared__ float part[ROW_LANES][2 * SLICE + 1];
  const int lane = threadIdx.x % LANES, rl = threadIdx.x / LANES;
  const int j = blockIdx.y * SLICE + lane * VEC;
  const long frame = blockIdx.x;
  const long width = 2L * m;
  float acc_a[VEC] = {}, acc_b[VEC] = {};
  if (j < m) {
    FrameConsts<T> k;
    k.load(c + frame * width, b_dil, b_cond, m, j);
    for (int t = rl; t < hop; t += ROW_LANES) {
      const long row = frame * hop + t;
      float ya[VEC], yb[VEC], g[VEC], za[VEC], zb[VEC];
      Vec<T>::ld(y + row * width + j, ya);
      Vec<T>::ld(y + row * width + m + j, yb);
      Vec<T>::ld(dgated + row * m + j, g);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float s = Io<T>::rnd(sigmoid(pre<T>(ya[e], k.da[e], k.ca[e])));
        const float th = Io<T>::rnd(tanhf(pre<T>(yb[e], k.db[e], k.cb[e])));
        // d(s * th): g * th to the sigmoid, g * s to the tanh; then torch's
        // sigmoid_backward a * (1 - s) * s and tanh_backward a * (1 - th * th).
        za[e] = Io<T>::rnd(Io<T>::rnd(g[e] * th) * (1.0f - s) * s);
        zb[e] = Io<T>::rnd(Io<T>::rnd(g[e] * s) * (1.0f - th * th));
        acc_a[e] += za[e];
        acc_b[e] += zb[e];
      }
      Vec<T>::st(dz + row * width + j, za);
      Vec<T>::st(dz + row * width + m + j, zb);
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    part[rl][lane * VEC + e] = acc_a[e];
    part[rl][SLICE + lane * VEC + e] = acc_b[e];
  }
  __syncthreads();
  if (threadIdx.x < 2 * SLICE) {
    const int half = threadIdx.x / SLICE;
    const int ch = blockIdx.y * SLICE + threadIdx.x % SLICE;
    if (ch < m) {
      float sum = 0.0f;
      for (int q = 0; q < ROW_LANES; ++q) sum += part[q][threadIdx.x];
      dc[frame * width + half * m + ch] = sum;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
    decoder_residual_fwd_kernel(const T* __restrict__ l, const T* __restrict__ r,
                                const T* __restrict__ b_res, T* __restrict__ l_out, int cl,
                                const T* __restrict__ s, const T* __restrict__ k,
                                const T* __restrict__ b_skip, T* __restrict__ s_out, int cs,
                                long rows) {
  long i = (long)blockIdx.x * NT + threadIdx.x;
  const long n_l = rows * (cl / VEC);
  const T *x = l, *p = r, *b = b_res;
  T* o = l_out;
  int width = cl;
  if (i >= n_l) {
    i -= n_l;
    if (i >= rows * (cs / VEC)) return;
    x = s, p = k, b = b_skip, o = s_out, width = cs;
  }
  const int groups = width / VEC;
  const long row = i / groups;
  const int j = (int)(i - row * groups) * VEC;
  float xv[VEC], pv[VEC], bv[VEC];
  Vec<T>::ld(x + row * width + j, xv);
  Vec<T>::ld(p + row * width + j, pv);
  Vec<T>::ld(b + j, bv);
#pragma unroll
  for (int e = 0; e < VEC; ++e) xv[e] += Io<T>::rnd(pv[e] + bv[e]);
  Vec<T>::st(o + row * width + j, xv);
}

// Grid (slices of dl' then of ds', row chunks). partial: [chunks, cl + cs]; done: a counter
// per slice, zero at launch; out: [cl + cs].
template <typename T>
__global__ void __launch_bounds__(NT)
    decoder_residual_bwd_kernel(const T* __restrict__ dl, int cl, const T* __restrict__ ds,
                                int cs, long rows, int chunk, float* __restrict__ partial,
                                unsigned* __restrict__ done, float* __restrict__ out) {
  __shared__ float part[ROW_LANES][SLICE + 1];
  __shared__ bool last;
  const int slices_l = (cl + SLICE - 1) / SLICE;
  const bool is_l = (int)blockIdx.x < slices_l;
  const T* g = is_l ? dl : ds;
  const int width = is_l ? cl : cs;
  const int c0 = (is_l ? blockIdx.x : blockIdx.x - slices_l) * SLICE;
  const int col = (is_l ? 0 : cl) + c0;  // the slice's first column in partial and out
  const int total = cl + cs;
  const int lane = threadIdx.x % LANES, rl = threadIdx.x / LANES;
  const int j = c0 + lane * VEC;
  float acc[VEC] = {};
  if (j < width) {
    const long end = (long)(blockIdx.y + 1) * chunk, r1 = end < rows ? end : rows;
    for (long row = (long)blockIdx.y * chunk + rl; row < r1; row += ROW_LANES) {
      float v[VEC];
      Vec<T>::ld(g + row * width + j, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += v[e];
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) part[rl][lane * VEC + e] = acc[e];
  __syncthreads();
  const bool mine = threadIdx.x < SLICE && c0 + (int)threadIdx.x < width;
  if (mine) {
    float sum = 0.0f;
    for (int q = 0; q < ROW_LANES; ++q) sum += part[q][threadIdx.x];
    partial[(long)blockIdx.y * total + col + threadIdx.x] = sum;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last || !mine) return;
  float sum = 0.0f;
  for (unsigned q = 0; q < gridDim.y; ++q)
    sum += __ldcg(partial + (long)q * total + col + threadIdx.x);
  out[col + threadIdx.x] = sum;
}

unsigned n_blocks(long items) { return (unsigned)((items + NT - 1) / NT); }

dim3 gate_grid(int rows, int m, int hop) {
  return dim3((unsigned)(rows / hop), (unsigned)((m + SLICE - 1) / SLICE));
}

template <typename T>
cudaError_t launch_gate_fwd(const void* y, const void* c, const void* b_dil, const void* b_cond,
                            void* gated, int rows, int m, int hop, cudaStream_t s) {
  decoder_gate_fwd_kernel<T><<<gate_grid(rows, m, hop), NT, 0, s>>>(
      (const T*)y, (const T*)c, (const T*)b_dil, (const T*)b_cond, (T*)gated, m, hop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gate_bwd(const void* y, const void* c, const void* b_dil, const void* b_cond,
                            const void* dgated, void* dz, void* dc, int rows, int m, int hop,
                            cudaStream_t s) {
  decoder_gate_bwd_kernel<T><<<gate_grid(rows, m, hop), NT, 0, s>>>(
      (const T*)y, (const T*)c, (const T*)b_dil, (const T*)b_cond, (const T*)dgated, (T*)dz,
      (float*)dc, m, hop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_residual_fwd(const void* l, const void* r, const void* b_res, void* l_out,
                                int cl, const void* sk, const void* k, const void* b_skip,
                                void* s_out, int cs, int rows, cudaStream_t s) {
  decoder_residual_fwd_kernel<T><<<n_blocks((long)rows * ((cl + cs) / VEC)), NT, 0, s>>>(
      (const T*)l, (const T*)r, (const T*)b_res, (T*)l_out, cl, (const T*)sk, (const T*)k,
      (const T*)b_skip, (T*)s_out, cs, rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_residual_bwd(const void* dl, int cl, const void* ds, int cs, int rows,
                                int chunk, float* partial, unsigned* done, float* out,
                                int slices, cudaStream_t s) {
  const dim3 grid((unsigned)slices, (unsigned)((rows + chunk - 1) / chunk));
  decoder_residual_bwd_kernel<T><<<grid, NT, 0, s>>>((const T*)dl, cl, (const T*)ds, cs, rows,
                                                     chunk, partial, done, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry returns cudaGetLastError() after its launch (0 on success). Tensors are
// contiguous and 16-byte aligned; m, cl and cs are multiples of 8; rows is a multiple of hop.

// y [rows, 2m], c [rows / hop, 2m], b_dil and b_cond [2m]; gated [rows, m].
int ast_decoder_gate_fwd(const void* y, const void* c, const void* b_dil, const void* b_cond,
                         void* gated, int rows, int m, int hop, int is_bf16, void* stream) {
  if (rows < 1 || m < VEC || m % VEC || hop < 1 || rows % hop) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_bf16 ? launch_gate_fwd<__nv_bfloat16>(y, c, b_dil, b_cond, gated, rows, m, hop, s)
                       : launch_gate_fwd<float>(y, c, b_dil, b_cond, gated, rows, m, hop, s));
}

// As above, with dgated [rows, m]; dz [rows, 2m] in the tensors' type, dc [rows / hop, 2m]
// float32.
int ast_decoder_gate_bwd(const void* y, const void* c, const void* b_dil, const void* b_cond,
                         const void* dgated, void* dz, void* dc, int rows, int m, int hop,
                         int is_bf16, void* stream) {
  if (rows < 1 || m < VEC || m % VEC || hop < 1 || rows % hop) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_bf16 ? launch_gate_bwd<__nv_bfloat16>(y, c, b_dil, b_cond, dgated, dz, dc,
                                                        rows, m, hop, s)
                       : launch_gate_bwd<float>(y, c, b_dil, b_cond, dgated, dz, dc, rows, m,
                                                hop, s));
}

// l, r, l_out [rows, cl]; s, k, s_out [rows, cs]; b_res [cl], b_skip [cs].
int ast_decoder_residual_fwd(const void* l, const void* r, const void* b_res, void* l_out, int cl,
                             const void* s, const void* k, const void* b_skip, void* s_out,
                             int cs, int rows, int is_bf16, void* stream) {
  if (rows < 1 || cl < 0 || cs < 0 || cl % VEC || cs % VEC || cl + cs == 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_bf16 ? launch_residual_fwd<__nv_bfloat16>(l, r, b_res, l_out, cl, s, k, b_skip,
                                                            s_out, cs, rows, st)
                       : launch_residual_fwd<float>(l, r, b_res, l_out, cl, s, k, b_skip, s_out,
                                                    cs, rows, st));
}

// dl [rows, cl] and ds [rows, cs] (either width may be 0, its pointer then unread); chunk:
// rows a block sums. scratch: float32, ceil(rows / chunk) * (cl + cs) partial sums, then one
// 4-byte counter per 64-column slice; out: [cl + cs] float32, the column sums of dl then ds.
int ast_decoder_residual_bwd(const void* dl, int cl, const void* ds, int cs, int rows, int chunk,
                             void* scratch, void* out, int is_bf16, void* stream) {
  const long chunks = rows < 1 || chunk < 1 ? 0 : (rows + (long)chunk - 1) / chunk;
  if (chunks < 1 || chunks > 65535 || cl < 0 || cs < 0 || cl % VEC || cs % VEC || cl + cs == 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int slices = (cl + SLICE - 1) / SLICE + (cs + SLICE - 1) / SLICE;
  float* partial = (float*)scratch;
  unsigned* done = (unsigned*)(partial + chunks * (cl + cs));
  cudaError_t e = cudaMemsetAsync(done, 0, slices * sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  return (int)(is_bf16 ? launch_residual_bwd<__nv_bfloat16>(dl, cl, ds, cs, rows, chunk, partial,
                                                            done, (float*)out, slices, s)
                       : launch_residual_bwd<float>(dl, cl, ds, cs, rows, chunk, partial, done,
                                                    (float*)out, slices, s));
}

}  // extern "C"
