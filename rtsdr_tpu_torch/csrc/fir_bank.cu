// FIR bank: F equal-length FIRs over one (C, N) float32 input at output
// stride s, with an optional elementwise pre-op and the overlap-save state.
//
//   y[f][c][m] = sum_k h[f][k] * xext[c][m*s + taps-1-k],  xext = [zi | pre(x)]
//   pre: 0 none, 1 square (x*x), 2 mul2 (2*x*x2)
//   zi_out[c]  = last taps-1 samples of xext (already in the pre-op domain)
//
// Replaces the Pallas kernel rtsdr_tpu/ops/pallas_fir.py::_fir_kernel
// (reached from fir_bank / fir_bank_carried / fir_block_pre).  That kernel
// contracts bf16 windows against a banded Toeplitz matrix on the matrix
// unit and adds the carried tail outside; here each output is the plain
// float32 dot product over the taps, and zi is read directly for indices
// before the block.
//
// Bound on an H100: operations.  Per output and filter 2*taps FLOP against
// 4/s input bytes and 4 output bytes, i.e. ~30-60 FLOP per byte at 151 taps
// — well above the ~20 FLOP/byte where the float32 CUDA-core rate (67
// TFLOP/s) meets the memory rate (3.35 TB/s).  Design: one block per
// (channel, tile of outputs); the input tile (T*s + taps-1 samples) goes to
// shared memory once with the pre-op applied at load, the taps of all F
// filters sit beside it, and each thread produces its output index for all
// F filters, so one shared-memory read of x feeds F multiply-adds.  Ragged
// edges (any C, any N) are masked in the kernel.  This first version is
// limited by shared-memory reads (one x read and F broadcast tap reads per
// F multiply-adds), not yet by the arithmetic units.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int PRE>
__device__ __forceinline__ float pre_op(const float* __restrict__ x,
                                        const float* __restrict__ x2,
                                        size_t i) {
  float v = x[i];
  if (PRE == 1) return v * v;
  if (PRE == 2) return 2.0f * v * x2[i];
  return v;
}

// xext[c][t1 + g] for g in [-t1, N): zi for g < 0 (zero when zi is NULL)
template <int PRE>
__device__ __forceinline__ float xext_at(const float* __restrict__ x,
                                         const float* __restrict__ x2,
                                         const float* __restrict__ zi,
                                         int c, int g, int n, int t1) {
  if (g < 0) return zi ? zi[(size_t)c * t1 + (t1 + g)] : 0.0f;
  if (g >= n) return 0.0f;
  return pre_op<PRE>(x, x2, (size_t)c * n + g);
}

template <int F, int PRE>
__global__ void __launch_bounds__(kThreads)
fir_bank_kernel(const float* __restrict__ x, const float* __restrict__ x2,
                const float* __restrict__ zi, const float* __restrict__ h,
                float* __restrict__ y, float* __restrict__ zi_out,
                int n_ch, int n, int m_out, int taps, int stride, int tile,
                int n_tiles) {
  extern __shared__ float smem[];
  float* sh = smem;                 // (F, taps)
  float* sx = smem + F * taps;      // tile*stride + taps-1 input samples
  const int c = blockIdx.x / n_tiles;
  const int o0 = (blockIdx.x % n_tiles) * tile;
  const int t1 = taps - 1;
  const int span = (tile - 1) * stride + taps;
  const int g0 = o0 * stride - t1;  // x index held by sx[0]

  for (int i = threadIdx.x; i < F * taps; i += kThreads) sh[i] = h[i];
  for (int j = threadIdx.x; j < span; j += kThreads)
    sx[j] = xext_at<PRE>(x, x2, zi, c, g0 + j, n, t1);
  __syncthreads();

  for (int o = threadIdx.x; o < tile; o += kThreads) {
    const int m = o0 + o;
    if (m >= m_out) break;
    const float* xs = sx + o * stride + t1;   // xs[-k] is tap k's sample
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < taps; ++k) {
      const float xv = xs[-k];
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = fmaf(sh[f * taps + k], xv, acc[f]);
    }
#pragma unroll
    for (int f = 0; f < F; ++f)
      y[((size_t)f * n_ch + c) * m_out + m] = acc[f];
  }

  // the block of the last tile also writes the carried tail
  if (zi_out != nullptr && (blockIdx.x % n_tiles) == n_tiles - 1) {
    for (int j = threadIdx.x; j < t1; j += kThreads)
      zi_out[(size_t)c * t1 + j] =
          xext_at<PRE>(x, x2, zi, c, n - t1 + j, n, t1);
  }
}

template <int F, int PRE>
cudaError_t launch(const float* x, const float* x2, const float* zi,
                   const float* h, float* y, float* zi_out, int n_ch, int n,
                   int m_out, int taps, int stride, cudaStream_t stream) {
  // outputs per block: wide tiles at stride 1 keep the taps-1 look-back a
  // small share of the loaded span; decimating tiles load tile*stride
  const int tile = stride == 1 ? 4 * kThreads : kThreads;
  const int n_tiles = (m_out + tile - 1) / tile;
  const size_t smem =
      sizeof(float) * ((size_t)F * taps + (size_t)(tile - 1) * stride + taps);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fir_bank_kernel<F, PRE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  fir_bank_kernel<F, PRE><<<(unsigned)(n_ch * n_tiles), kThreads, smem,
                            stream>>>(x, x2, zi, h, y, zi_out, n_ch, n, m_out,
                                      taps, stride, tile, n_tiles);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_pre(int pre, const float* x, const float* x2,
                       const float* zi, const float* h, float* y,
                       float* zi_out, int n_ch, int n, int m_out, int taps,
                       int stride, cudaStream_t stream) {
  switch (pre) {
    case 0: return launch<F, 0>(x, x2, zi, h, y, zi_out, n_ch, n, m_out, taps, stride, stream);
    case 1: return launch<F, 1>(x, x2, zi, h, y, zi_out, n_ch, n, m_out, taps, stride, stream);
    case 2: return launch<F, 2>(x, x2, zi, h, y, zi_out, n_ch, n, m_out, taps, stride, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x, x2 (NULL unless pre == 2): (C, N); zi (NULL = zero state): (C, taps-1);
// h: (F, taps); y: (F, C, M), M = ceil(N / stride); zi_out (or NULL):
// (C, taps-1).  F in 1..3.  Returns cudaGetLastError().
extern "C" int rtsdr_fir_bank(const float* x, const float* x2, const float* zi,
                              const float* h, float* y, float* zi_out,
                              int n_ch, int n, int m_out, int taps, int n_f,
                              int stride, int pre, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_ch <= 0 || n <= 0 || m_out <= 0 || taps < 1 || stride < 1 ||
      (pre == 2 && x2 == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (n_f) {
    case 1: return (int)launch_pre<1>(pre, x, x2, zi, h, y, zi_out, n_ch, n, m_out, taps, stride, s);
    case 2: return (int)launch_pre<2>(pre, x, x2, zi, h, y, zi_out, n_ch, n, m_out, taps, stride, s);
    case 3: return (int)launch_pre<3>(pre, x, x2, zi, h, y, zi_out, n_ch, n, m_out, taps, stride, s);
  }
  return (int)cudaErrorInvalidValue;
}
