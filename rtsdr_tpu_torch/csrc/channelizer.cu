// Composed channelizer: K-slot polyphase channelizer and per-station RF
// low-pass + decimator as ONE complex decimating FIR bank, straight from the
// raw interleaved uint8 I/Q of a wideband capture:
//
//   y[b][ch][0][p] + j y[b][ch][1][p] = sum_t g[ch][t] * X[b][d*p - t]
//   X[b][n] = ((I[n] - 128) + j (Q[n] - 128)) / 128,   d = decim * K
//
// for t in [0, L); samples before the block (n < 0) come from the carried
// byte tail zi (the last L-1 complex samples of the previous block, 128 = 0).
// With ext = [zi | raw] (complex index e = n + L-1) output p reads the L
// samples ext[d*p .. d*p + L-1]; tap t meets ext[d*p + L-1 - t].
// zi_out = the last 2(L-1) bytes of ext.
//
// Replaces the Pallas kernel rtsdr_tpu/ops/channelizer.py::_composed_kernel
// (reached from _pallas_composed via _try_pallas_composed).  That kernel
// assembles an im2col operand of byte windows with sublane rolls, converts
// it to bf16 and contracts it against a banded (span, K*2*block) weight
// matrix that stays resident in fast memory.  Nothing of that is carried
// over: here each output is the plain float32 complex dot product over its
// L taps, the taps are dense (no banded matrix of zeros), and the bytes are
// converted exactly.
//
// Bound on an H100: operations.  8 FLOP per tap and output: at K = 16,
// L = 2,656, 8 captures of 4,915,200 bytes that is 41.8 GFLOP (0.62 ms at
// 67 TFLOP/s float32) against 39 MB read and 16 MB written (0.017 ms).
// Design: one block per (capture, tile of TP outputs, tile of up to 16
// stations).  The tile's byte window goes to shared memory once, converted
// to float2 (I-128, Q-128) with an exact integer-to-float bit trick (the
// 1/128 is folded into the taps by the wrapper, exactly).  A thread owns
// one station and R outputs p (R = 4 where the window fits): per tap it
// reads the station's complex tap once (taps lie tap-major, (L, K, 2), so
// the stations of a half-warp read 128 contiguous bytes, the same for every
// block: they stay in L1/L2) and R window samples (all threads of a
// half-warp share p, so each read is a broadcast), and does 4 R multiply-
// adds.  Long filters or wide strides are cut into chunks of taps so that
// the window always fits shared memory: any K, L and P are taken.  This
// first version is limited by load instructions (1 + R loads per 4 R
// multiply-adds), not by arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChanLanes = 16;     // stations per block
constexpr int kWindowCap = 13312;     // complex samples of shared memory (104 KB)
constexpr int kMinChunk = 256;        // least taps per chunk worth staging

struct Args {
  const uint8_t *raw, *zi;
  const float2* g;        // (L, K) complex taps, already scaled by 1/128
  float* y;               // (B, K, 2, P)
  uint8_t* zi_out;        // (B, 2(L-1))
  int n_cap, n, k, taps, d;
  int p_out, chan_lanes, p_lanes, tile_p, n_ptiles, chunk;
};

// exact uint8 -> float of (b - 128): 0x4B000000 | b is the float 2^23 + b
__device__ __forceinline__ float centred(unsigned b) {
  return __uint_as_float(0x4B000000u | b) - 8388736.0f;
}

// byte pair (I, Q) of complex sample e of ext = [zi | raw]; zero level
// beyond the end
__device__ __forceinline__ unsigned ext_pair(const uint8_t* zi_row,
                                             const uint8_t* raw_row, int e,
                                             int t1, int n) {
  if (e < t1)
    return *reinterpret_cast<const unsigned short*>(zi_row + 2 * (size_t)e);
  if (e < t1 + n)
    return *reinterpret_cast<const unsigned short*>(raw_row +
                                                    2 * (size_t)(e - t1));
  return 0x8080u;
}

template <int R>
__global__ void __launch_bounds__(kThreads) composed_kernel(Args a) {
  extern __shared__ float2 sx[];
  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.n_ptiles;
  const int p0 = (blockIdx.x % a.n_ptiles) * a.tile_p;
  const int t1 = a.taps - 1;
  const uint8_t* raw_row = a.raw + (size_t)b * 2 * a.n;
  const uint8_t* zi_row = a.zi + (size_t)b * 2 * t1;

  const int cl = tid % a.chan_lanes;
  const int pl = tid / a.chan_lanes;
  const int ch = blockIdx.y * a.chan_lanes + cl;
  const int ch_ld = min(ch, a.k - 1);      // idle lanes read a valid tap
  // outputs of this thread: p0 + pl + p_lanes * r
  const bool lane_on = pl < a.p_lanes;

  float re[R], im[R];
#pragma unroll
  for (int r = 0; r < R; ++r) re[r] = im[r] = 0.0f;

  for (int t0 = 0; t0 < a.taps; t0 += a.chunk) {
    const int tc = min(a.chunk, a.taps - t0);      // taps in this chunk
    // sx[j] = ext[base + j]: the samples taps t0 .. t0+tc-1 meet for the
    // outputs p0 .. p0+tile_p-1
    const int base = a.d * p0 + a.taps - t0 - tc;
    const int len = a.d * (a.tile_p - 1) + tc;
    __syncthreads();                               // the last chunk is read
#pragma unroll 4
    for (int j = tid; j < len; j += kThreads) {
      const unsigned iq = ext_pair(zi_row, raw_row, base + j, t1, a.n);
      sx[j] = make_float2(centred(iq & 0xffu), centred(iq >> 8));
    }
    __syncthreads();
    if (lane_on) {
      // tap t0 + tt of output p0 + q meets sx[d*q + tc-1 - tt]
      const float2* gp = a.g + (size_t)t0 * a.k + ch_ld;
      const float2* xs = sx + a.d * pl + (tc - 1);
      const int rstep = a.d * a.p_lanes;
#pragma unroll 4
      for (int tt = 0; tt < tc; ++tt) {
        const float2 gv = __ldg(gp + (size_t)tt * a.k);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float2 xv = xs[r * rstep - tt];
          re[r] = fmaf(gv.x, xv.x, re[r]);
          re[r] = fmaf(-gv.y, xv.y, re[r]);
          im[r] = fmaf(gv.y, xv.x, im[r]);
          im[r] = fmaf(gv.x, xv.y, im[r]);
        }
      }
    }
  }

  if (lane_on && ch < a.k) {
    float* yr = a.y + ((size_t)b * a.k + ch) * 2 * a.p_out;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = p0 + pl + a.p_lanes * r;
      if (p < a.p_out) {
        yr[p] = re[r];
        yr[a.p_out + p] = im[r];
      }
    }
  }

  // the capture's first block also writes the new byte tail: the last
  // 2(L-1) bytes of ext, which start at ext byte 2n
  if (blockIdx.x % a.n_ptiles == 0 && blockIdx.y == 0) {
    uint8_t* out = a.zi_out + (size_t)b * 2 * t1;
    for (int j = tid; j < 2 * t1; j += kThreads) {
      const size_t e = 2 * (size_t)a.n + j;
      out[j] = e < 2 * (size_t)t1 ? zi_row[e] : raw_row[e - 2 * (size_t)t1];
    }
  }
}

template <int R>
cudaError_t launch(const Args& a, size_t smem, dim3 grid,
                   cudaStream_t stream) {
  // more than 48 KB of dynamic shared memory needs an opt-in: made once per
  // kernel instance and device, for the largest window any geometry takes
  static unsigned long long opted_in = 0;        // one bit per device
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const unsigned long long bit = 1ull << (dev & 63);
    if (!(opted_in & bit)) {
      e = cudaFuncSetAttribute(
          composed_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)(sizeof(float2) * kWindowCap));
      if (e != cudaSuccess) return e;
      opted_in |= bit;
    }
  }
  composed_kernel<R><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// raw: (B, 2n) u8 and zi, zi_out: (B, 2(taps-1)) u8, rows at even addresses;
// g: (taps, K, 2) float32, scaled by 1/128; y: (B, K, 2, n/d) float32.
// Needs n % d == 0.  Returns cudaGetLastError().
extern "C" int rtsdr_channelize_composed(const uint8_t* raw, const uint8_t* zi,
                                         const float* g, float* y,
                                         uint8_t* zi_out, int n_cap, int n,
                                         int k, int taps, int d,
                                         void* stream) {
  if (n_cap <= 0 || n <= 0 || k <= 0 || taps < 1 || d < 1 || n % d != 0 ||
      ((reinterpret_cast<uintptr_t>(raw) | reinterpret_cast<uintptr_t>(zi)) &
       1) != 0)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.raw = raw; a.zi = zi; a.g = reinterpret_cast<const float2*>(g);
  a.y = y; a.zi_out = zi_out;
  a.n_cap = n_cap; a.n = n; a.k = k; a.taps = taps; a.d = d;
  a.p_out = n / d;
  a.chan_lanes = 1;
  while (a.chan_lanes < k && a.chan_lanes < kMaxChanLanes) a.chan_lanes *= 2;
  a.p_lanes = kThreads / a.chan_lanes;
  // the most outputs per thread (4, 2, 1), then the most output lanes, whose
  // window d*(tile_p-1) leaves room for a worthwhile chunk of taps
  const int min_chunk = taps < kMinChunk ? taps : kMinChunk;
  int r = 4;
  while (r > 1 &&
         (long long)d * (a.p_lanes * r - 1) + min_chunk > kWindowCap)
    r /= 2;
  while (a.p_lanes > 1 &&
         (long long)d * (a.p_lanes * r - 1) + min_chunk > kWindowCap)
    a.p_lanes /= 2;
  a.tile_p = a.p_lanes * r;
  a.n_ptiles = (a.p_out + a.tile_p - 1) / a.tile_p;
  const int room = kWindowCap - d * (a.tile_p - 1);
  a.chunk = taps < room ? taps : room;
  const size_t smem =
      sizeof(float2) * ((size_t)d * (a.tile_p - 1) + a.chunk);
  const dim3 grid((unsigned)(n_cap * a.n_ptiles),
                  (unsigned)((k + a.chan_lanes - 1) / a.chan_lanes));
  cudaStream_t s = (cudaStream_t)stream;
  switch (r) {
    case 4: return (int)launch<4>(a, smem, grid, s);
    case 2: return (int)launch<2>(a, smem, grid, s);
  }
  return (int)launch<1>(a, smem, grid, s);
}
