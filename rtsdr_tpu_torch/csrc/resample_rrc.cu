// RDS mixer + rational resampler (+ RRC matched filter): two kernels over
// one resampler stage.  resample_rrc (K4) does all three:
//
//   mixed_b[i] = 2 * e[i] * n_b[i]                       b in {I, Q}
//   r_b[m]  = gain * sum_k h[k] * uext_b[m*down + t1 - k]
//             uext_b = [zi_b (t1) | zero-stuff(mixed_b, up)],  t1 = taps-1
//   y_b[m]  = sum_k g[k] * rext_b[m + t1r - k],   rext_b = [rrc_zi_b | r_b]
//   rrc_zi_out_b = last t1r samples of rext_b
//
// In the x domain only every up-th tap meets a non-zero sample: with
// pos = m*down, i0 = pos / up, p = pos % up,
//   r_b[m] = gain * ( sum_{j>=0, p+up*j<=t1, j<=i0} h[p + up*j] * mixed_b[i0-j]
//                   + sum_{k=pos+1..t1} h[k] * zi_b[pos + t1 - k] )
// (158 taps per output at x19/80 with 3,001 taps); the second sum exists for
// the first ceil(t1/down) outputs of a row only, and zi is arbitrary floats.
// The carried tail of the zero-stuffed mixed stream (the next zi) is made by
// the wrapper from the last ceil(t1/up) inputs.
//
// Replaces the Pallas kernel rtsdr_tpu/ops/pallas_fir.py::
// _resample_mix_rrc_kernel (_mix_resample_core, _rrc_banded; reached from
// resample_mul2_rrc).  That kernel contracts bf16 windows against a
// phase-banded matrix on the matrix unit, rolls the resampler tail in a
// scratch from one grid step to the next (the grid runs in order there) and
// adds both carried states outside through boundary matmuls.  Here all
// arithmetic is float32, both carried states are read in the kernel, and
// since CUDA blocks run in no order the RRC look-back is recomputed as a
// halo: a block that owns outputs [m0, m0+T) also computes the t1r resampler
// outputs before them (the first tile takes rrc_zi instead).
//
// Bound on an H100: about even.  At 1,024 channels of 15,360 samples:
// 2 * 3,648 * (158 + 151) * 2 FLOP = 4.5 MFLOP and 3 * 61 KB in, 29 KB out,
// 25 KB of states = 0.26 MB per channel, i.e. ~0.07 ms by operations and
// ~0.08 ms by bytes.  Design: one block per (channel, tile of T = 608
// outputs), both branches; the tile's e / nco window is mixed at load into
// shared memory (the mixed streams never exist in device memory), all taps
// sit beside it; each thread produces one resampler output for BOTH
// branches (one tap read feeds two multiply-adds), and neighbouring threads
// of a warp work `lane_stride` outputs apart so that their walks through the
// window fall on different banks; the resampler outputs stay in shared
// memory, where the RRC reads them.  The halo costs t1r / T extra resampler
// work (25 %).  The dense zi terms are summed by whole warps with coalesced
// reads (four in flight) and a shuffle reduction.  This first version is limited by
// shared-memory reads (three per two multiply-adds), not by arithmetic.
//
// resample_mix (K6) is the same resampler stage without the RRC: the full
// (C, 2, M) resampler output is written, both branches.  Replaces the Pallas
// kernel rtsdr_tpu/ops/pallas_fir.py::_resample_mix_kernel
// (_mix_resample_core; reached from resample_mul2 through
// _pallas_resample_mix), which the time-sharded receiver runs on its
// stacked (T*C, N/T) chunks; that kernel contracts bf16 windows on the
// matrix unit and adds the carried zi outside through a boundary matmul.
// Here zi is read in the kernel and all arithmetic is float32.  Bound on an
// H100: bytes.  At 1,024 channels of 15,360 samples, x19/80: 3 x 61 KB in,
// 24 KB of zi, 29 KB out per channel (0.24 GB, 0.07 ms) against 2 * 3,648 *
// 158 * 2 FLOP (2.4 GFLOP, 0.04 ms).  Design: one block per (row, tile of
// outputs); no RRC look-back, so tiles do not overlap, and the tile shrinks
// (608 -> 76 outputs) until a launch has two blocks per SM, which keeps a
// one-station time-sharded step (T rows) from running on a handful of SMs.
// Two instances ask the TPU probe's layout question of this card
// (tools/profile_resample.py, B7' there): `split`, one thread per (output,
// branch), two tap reads per two multiply-adds, and `pair`, one thread makes
// the I and Q outputs from one tap read.  The receiver launches `split`: it
// ran as fast or faster at the receiver's shapes on an H100
// (tools/torch_profile_resample.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 608;      // RRC outputs owned by one resample_rrc block
constexpr int kMinBlocks = 264; // resample_mix: two blocks per SM of 132

struct Args {
  const float *e, *ni, *nq, *h, *zi, *g, *rrc_zi;
  float *y, *rrc_zi_out;
  int n_ch, n, m, taps, up, down, rtaps, lane_stride;
  float gain;
  int tile, n_tiles, x_cap, n_slots_cap;
};

// First x sample read by outputs from mlo_c on (0 if the look-back reaches
// before the block: those taps read zi instead).
__device__ __forceinline__ int x_first(const Args& p, int mlo_c) {
  const long long num = (long long)mlo_c * p.down - (p.taps - 1);
  return num <= 0 ? 0 : (int)((num + p.up - 1) / p.up);
}

// Stage the taps and the mixed window x[ilo, ilo + n_x) of row c:
// mixed_b = 2 * e * n_b, made here so that it never reaches device memory.
__device__ __forceinline__ void stage_mixed(const Args& p, int c, int ilo,
                                            int n_x, float* sh, float* sxi,
                                            float* sxq) {
  for (int k = threadIdx.x; k < p.taps; k += kThreads) sh[k] = p.h[k];
  const size_t row = (size_t)c * p.n + ilo;
  for (int j = threadIdx.x; j < n_x; j += kThreads) {
    const float e2 = 2.0f * p.e[row + j];
    sxi[j] = e2 * p.ni[row + j];
    sxq[j] = e2 * p.nq[row + j];
  }
}

// The resampler stage: outputs [m_first, m_end) of the row into slots
// (m - slot0), before the carried-zi terms and the gain.  Outputs are dealt
// to threads in groups of 32 * L (L = lane_stride): warp w of a group takes
// the outputs w, w + L, w + 2L, ... of the group's 32 * L.  kSplit: one
// thread per (output, branch) instead of one per output for both.
template <bool kSplit>
__device__ __forceinline__ void resample_stage(
    const Args& p, const float* sh, const float* sxi, const float* sxq,
    int ilo, int m_first, int m_end, int slot0, float* sri, float* srq) {
  const int t1 = p.taps - 1;
  const int L = p.lane_stride;
  const int group = 32 * L;
  const int n_comp = m_end - m_first;
  const int n_rounded = (n_comp + group - 1) / group * group;
  const int n_work = kSplit ? 2 * n_rounded : n_rounded;
  for (int s = threadIdx.x; s < n_work; s += kThreads) {
    const int b = kSplit ? s / n_rounded : 0;     // branch (split only)
    const int sl = s - b * n_rounded;
    const int w = sl >> 5, lane = sl & 31;
    const int ml = (w / L) * group + (w % L) + L * lane;
    if (ml >= n_comp) continue;
    const int m = m_first + ml;
    const long long pos = (long long)m * p.down;
    const int i0 = (int)(pos / p.up);
    const int ph = (int)(pos - (long long)i0 * p.up);
    // taps ph + up*j <= t1 that meet a sample x[i0 - j], i0 - j >= 0
    const int nj = t1 < ph ? 0 : min((t1 - ph) / p.up, i0) + 1;
    const float* hp = sh + ph;
    if (kSplit) {
      const float* x = (b ? sxq : sxi) + (i0 - ilo);
      float a = 0.0f;
#pragma unroll 4
      for (int j = 0; j < nj; ++j) a = fmaf(hp[j * p.up], x[-j], a);
      (b ? srq : sri)[m - slot0] = a;
    } else {
      const float* xi = sxi + (i0 - ilo);
      const float* xq = sxq + (i0 - ilo);
      float ai = 0.0f, aq = 0.0f;
#pragma unroll 4
      for (int j = 0; j < nj; ++j) {
        const float hk = hp[j * p.up];
        ai = fmaf(hk, xi[-j], ai);
        aq = fmaf(hk, xq[-j], aq);
      }
      sri[m - slot0] = ai;
      srq[m - slot0] = aq;
    }
  }
}

// The carried resampler state: outputs with m*down < t1 also read zi.  One
// warp per (output, branch): lanes stride over the dense taps, four
// independent sums keep four 128-byte reads of zi in flight per warp.
__device__ __forceinline__ void add_carried(const Args& p, int c,
                                            const float* sh, int m_first,
                                            int m_end, int slot0, float* sri,
                                            float* srq) {
  const int t1 = p.taps - 1;
  const int nb = (t1 + p.down - 1) / p.down;       // outputs that reach zi
  const int hi = min(m_end, nb);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t zrow = (size_t)c * 2 * t1;
  for (int q = 2 * m_first + warp; q < 2 * hi; q += kThreads / 32) {
    const int m = q >> 1, b = q & 1;
    const int pos = m * p.down;                    // < t1
    const float* z = p.zi + zrow + (size_t)b * t1;
    // tap k in (pos, t1] reads zi[pos + t1 - k]
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    int k = pos + 1 + lane;
    for (; k + 96 <= t1; k += 128) {
      a0 = fmaf(sh[k], z[pos + t1 - k], a0);
      a1 = fmaf(sh[k + 32], z[pos + t1 - k - 32], a1);
      a2 = fmaf(sh[k + 64], z[pos + t1 - k - 64], a2);
      a3 = fmaf(sh[k + 96], z[pos + t1 - k - 96], a3);
    }
    for (; k <= t1; k += 32) a0 = fmaf(sh[k], z[pos + t1 - k], a0);
    float acc = (a0 + a1) + (a2 + a3);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, d);
    if (lane == 0) (b ? srq : sri)[m - slot0] += acc;
  }
}

__global__ void __launch_bounds__(kThreads) resample_rrc_kernel(Args p) {
  extern __shared__ float smem[];
  const int t1r = p.rtaps - 1;
  float* sh = smem;                        // taps
  float* sg = sh + p.taps;                 // rtaps
  float* sxi = sg + p.rtaps;               // mixed I window (x_cap)
  float* sxq = sxi + p.x_cap;              // mixed Q window
  float* sri = sxq + p.x_cap;              // resampler outputs I (slots)
  float* srq = sri + p.n_slots_cap;        // resampler outputs Q

  const int tid = threadIdx.x;
  const int c = blockIdx.x / p.n_tiles;
  const int tile_idx = blockIdx.x % p.n_tiles;
  const int m0 = tile_idx * kTile;                 // first output owned
  const int own = min(kTile, p.m - m0);
  const int mlo = m0 - t1r;                        // output index of slot 0
  const int n_slots = own + t1r;
  const int mlo_c = max(mlo, 0);                   // first computed output
  const int mhi = m0 + own;                        // one past the last

  // x window [ilo, ihi] that the computed outputs read
  const int ilo = x_first(p, mlo_c);
  const int ihi = (int)(((long long)(mhi - 1) * p.down) / p.up);
  stage_mixed(p, c, ilo, ihi - ilo + 1, sh, sxi, sxq);
  for (int k = tid; k < p.rtaps; k += kThreads) sg[k] = p.g[k];
  __syncthreads();

  // ---- resampler: slot s holds r[mlo + s]
  resample_stage<false>(p, sh, sxi, sxq, ilo, mlo_c, mhi, mlo, sri, srq);
  // the first tile's look-back is the carried RRC state
  if (mlo < 0) {
    const size_t rrow = (size_t)c * 2 * t1r;
    for (int s = tid; s < -mlo; s += kThreads) {   // -mlo <= t1r slots
      sri[s] = p.rrc_zi[rrow + (t1r + mlo) + s];
      srq[s] = p.rrc_zi[rrow + t1r + (t1r + mlo) + s];
    }
  }
  __syncthreads();
  add_carried(p, c, sh, mlo_c, mhi, mlo, sri, srq);
  __syncthreads();
  for (int s = tid + (mlo_c - mlo); s < n_slots; s += kThreads) {
    sri[s] *= p.gain;
    srq[s] *= p.gain;
  }
  __syncthreads();

  // ---- the next block's RRC state: the row's last t1r resampler outputs
  if (tile_idx == p.n_tiles - 1) {
    const size_t rrow = (size_t)c * 2 * t1r;
    for (int j = tid; j < t1r; j += kThreads) {
      const int s = (p.m - t1r + j) - mlo;         // >= 0: m >= t1r checked
      p.rrc_zi_out[rrow + j] = sri[s];
      p.rrc_zi_out[rrow + t1r + j] = srq[s];
    }
  }

  // ---- RRC over the slots: y[m0 + o] reads slots o .. o + t1r
  const size_t yrow = (size_t)c * 2 * p.m;
  for (int o = tid; o < own; o += kThreads) {
    const float* ri = sri + o + t1r;
    const float* rq = srq + o + t1r;
    float ai = 0.0f, aq = 0.0f;
#pragma unroll 4
    for (int k = 0; k < p.rtaps; ++k) {
      const float gk = sg[k];
      ai = fmaf(gk, ri[-k], ai);
      aq = fmaf(gk, rq[-k], aq);
    }
    p.y[yrow + m0 + o] = ai;
    p.y[yrow + p.m + m0 + o] = aq;
  }
}

template <bool kSplit>
__global__ void __launch_bounds__(kThreads) resample_mix_kernel(Args p) {
  extern __shared__ float smem[];
  float* sh = smem;                        // taps
  float* sxi = sh + p.taps;                // mixed I window (x_cap)
  float* sxq = sxi + p.x_cap;              // mixed Q window
  float* sri = sxq + p.x_cap;              // outputs I of the tile
  float* srq = sri + p.n_slots_cap;        // outputs Q of the tile

  const int c = blockIdx.x / p.n_tiles;
  const int m0 = (blockIdx.x % p.n_tiles) * p.tile;   // first output owned
  const int own = min(p.tile, p.m - m0);
  const int mhi = m0 + own;
  const int ilo = x_first(p, m0);
  const int ihi = (int)(((long long)(mhi - 1) * p.down) / p.up);
  stage_mixed(p, c, ilo, ihi - ilo + 1, sh, sxi, sxq);
  __syncthreads();
  resample_stage<kSplit>(p, sh, sxi, sxq, ilo, m0, mhi, m0, sri, srq);
  __syncthreads();
  add_carried(p, c, sh, m0, mhi, m0, sri, srq);
  __syncthreads();
  const size_t yrow = (size_t)c * 2 * p.m + m0;
  for (int o = threadIdx.x; o < own; o += kThreads) {
    p.y[yrow + o] = sri[o] * p.gain;
    p.y[yrow + p.m + o] = srq[o] * p.gain;
  }
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// e, ni, nq: (C, n); h: (taps,); zi: (C, 2, taps-1); g: (rtaps,);
// rrc_zi, rrc_zi_out: (C, 2, rtaps-1); y: (C, 2, m), m = n*up/down.  All
// float32.  Needs n*up % down == 0, n*up >= taps-1 and m >= rtaps-1.
// Returns cudaGetLastError().
extern "C" int rtsdr_resample_rrc(const float* e, const float* ni,
                                  const float* nq, const float* h,
                                  const float* zi, const float* g,
                                  const float* rrc_zi, float* y,
                                  float* rrc_zi_out, int n_ch, int n, int m,
                                  int taps, int up, int down, int rtaps,
                                  int lane_stride, float gain, void* stream) {
  if (n_ch <= 0 || n <= 0 || taps < 1 || rtaps < 1 || up < 1 || down < 1 ||
      lane_stride < 1 || (long long)n * up != (long long)m * down ||
      (long long)n * up < taps - 1 || m < rtaps - 1)
    return (int)cudaErrorInvalidValue;
  Args p = {};
  p.e = e; p.ni = ni; p.nq = nq; p.h = h; p.zi = zi; p.g = g;
  p.rrc_zi = rrc_zi; p.y = y; p.rrc_zi_out = rrc_zi_out;
  p.n_ch = n_ch; p.n = n; p.m = m; p.taps = taps; p.up = up; p.down = down;
  p.rtaps = rtaps; p.lane_stride = lane_stride; p.gain = gain;
  p.tile = kTile;
  p.n_tiles = (m + kTile - 1) / kTile;
  p.n_slots_cap = kTile + rtaps - 1;
  // x samples a block's outputs can read: their span plus one filter length
  p.x_cap = (int)(((long long)p.n_slots_cap * down + (taps - 1)) / up) + 2;
  const size_t smem = sizeof(float) * ((size_t)taps + rtaps +
                                       2 * (size_t)p.x_cap +
                                       2 * (size_t)p.n_slots_cap);
  cudaError_t err = allow_smem((const void*)resample_rrc_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  resample_rrc_kernel<<<(unsigned)(n_ch * p.n_tiles), kThreads, smem,
                        (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// e, ni, nq: (C, n); h: (taps,); zi: (C, 2, taps-1); y: (C, 2, m),
// m = n*up/down.  All float32.  Needs n*up % down == 0 and n*up >= taps-1.
// split != 0 launches the one-thread-per-branch instance.  Returns
// cudaGetLastError().
extern "C" int rtsdr_resample_mix(const float* e, const float* ni,
                                  const float* nq, const float* h,
                                  const float* zi, float* y, int n_ch, int n,
                                  int m, int taps, int up, int down,
                                  int lane_stride, int split, float gain,
                                  void* stream) {
  if (n_ch <= 0 || n <= 0 || taps < 1 || up < 1 || down < 1 ||
      lane_stride < 1 || (long long)n * up != (long long)m * down ||
      (long long)n * up < taps - 1)
    return (int)cudaErrorInvalidValue;
  Args p = {};
  p.e = e; p.ni = ni; p.nq = nq; p.h = h; p.zi = zi; p.y = y;
  p.n_ch = n_ch; p.n = n; p.m = m; p.taps = taps; p.up = up; p.down = down;
  p.lane_stride = lane_stride; p.gain = gain;
  p.tile = kTile;
  while (p.tile > kTile / 8 &&
         (long long)n_ch * ((m + p.tile - 1) / p.tile) < kMinBlocks)
    p.tile /= 2;
  p.n_tiles = (m + p.tile - 1) / p.tile;
  p.n_slots_cap = p.tile;
  p.x_cap = (int)(((long long)p.tile * down + (taps - 1)) / up) + 2;
  const size_t smem = sizeof(float) * ((size_t)taps + 2 * (size_t)p.x_cap +
                                       2 * (size_t)p.n_slots_cap);
  const void* kernel = split ? (const void*)resample_mix_kernel<true>
                             : (const void*)resample_mix_kernel<false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(n_ch * p.n_tiles);
  if (split)
    resample_mix_kernel<true><<<blocks, kThreads, smem,
                                (cudaStream_t)stream>>>(p);
  else
    resample_mix_kernel<false><<<blocks, kThreads, smem,
                                 (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
