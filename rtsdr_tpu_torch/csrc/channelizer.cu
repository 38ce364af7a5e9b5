// Composed channelizer: K-slot polyphase channelizer and per-station RF
// low-pass + decimator as ONE complex decimating FIR bank, straight from the
// raw interleaved uint8 I/Q of a wideband capture:
//
//   y[b][ch][0][p] + j y[b][ch][1][p] = sum_t g[ch][t] * X[b][d*p - t]
//   X[b][n] = ((I[n] - 128) + j (Q[n] - 128)) / 128,   d = decim * K
//
// for t in [0, L); samples before the block (n < 0) come from the carried
// byte tail zi (the last L-1 complex samples of the previous block, 128 = 0).
// With ext = [zi | raw] (complex index e = n + L-1), tap t of output p meets
// ext[d*p + L-1 - t].  zi_out = the last 2(L-1) bytes of ext.
//
// Replaces the Pallas kernel rtsdr_tpu/ops/channelizer.py::_composed_kernel
// (reached from _pallas_composed via _try_pallas_composed).  That kernel
// contracts an im2col operand of byte windows in bf16 against a banded
// (span, K*2*block) weight matrix resident in fast memory.  Nothing of that
// is carried over.
//
// The math (ops/channelizer.py::ComposedPlan).  Write t = d*a + b (b < d,
// a < A = ceil(L/d)) and plane_b[q] = ext[d*q + L-1 - b]: tap t of output p
// meets plane_b[p - a], so every output is a sum of d A-tap FIRs, one per
// polyphase plane.  A station whose de-rotated taps c_k[t] = g_k[t] *
// W^{-k t} (W = exp(2 pi i / K)) are one real prototype c shared with other
// stations is, since d divides by K,
//   y_k[p] = sum_{r<K} W^{k r} u_r[p],
//   u_r[p] = sum_{b = r mod K} sum_a c[d a + b] plane_b[p - a]:
// d real FIRs summed by residue, then one K-point DFT per output for all
// such stations: 4L + 8K^2 FLOP per output instead of 8LK.  Every other
// station (a residual offset folded into its taps) runs its own complex
// taps over the same planes.  The host picks each station's route from g.
//
// Bound on an H100 (K = 16, L = 2,656, 8 captures of 4,915,200 bytes): the
// shared route 1.6 GFLOP (0.023 ms at 67 TFLOP/s) against 39 MB read and
// 16 MB written (0.017 ms): operations.  The own-taps route 8 FLOP per tap,
// output and station: 2.6 GFLOP per station (0.039 ms).
//
// Design: one launch, blocks of two roles in one grid: x = (capture, tile of
// `tile` outputs), y = own-taps groups of up to 16 stations, then the shared
// role.  Both roles stage the tile's byte window once, converted exactly
// (0x4B000000 | b is the float 2^23 + b; the 1/128 is folded into the taps)
// and scattered into the d polyphase planes (odd row pitch: a half-warp's
// neighbouring planes fall on distinct banks), nb planes per pass when all d
// do not fit.  A thread owns R = 8 consecutive outputs of one lane (the
// shared role: the prototype; the own role: a station) and one slice of the
// planes (the shared role: residue r, planes b = r mod K; the own role: one
// of ns_own slices, so that few own stations still fill the block), and
// walks its planes with a register window of R + A - 1 samples: 2 A R
// (shared) or 4 A R (own) multiply-adds per R + A - 1 shared-memory loads.
// The taps of a few planes at a time are staged in shared memory first (the
// shared role: lanes read neighbouring planes, odd pitch; the own role:
// lanes read neighbouring stations).  The partial sums meet in shared
// memory; the shared role then runs the DFT rows of its stations (direct
// form, twiddles from the host in float64 rounded once), the own role sums
// its slices.  An instance with A = 17 compiled in (K = 8, 16, 32 at decim
// 10: the window and the taps unroll) and a generic one (A padded to a
// multiple of 4, a window sliding 4 samples per 4 taps) take any K, L, P.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kR = 8;                   // outputs per thread
constexpr int kFixedA = 17;             // taps per plane, compiled in
constexpr int kSmemCap = 113 * 1024;    // two blocks per SM
constexpr int kB = 4;                   // staging loads in flight

struct Args {
  const uint8_t *raw, *zi;
  const float* proto;       // (d, a_sp | 1) real prototype taps / 128
  const float2* tw;         // (K): W^m
  const int* sh_list;       // shared stations
  const float2* own_taps;   // (d, a_sp, n_own) complex taps / 128
  const int* own_list;      // own-taps stations
  float* y;                 // (B, K, 2, P)
  uint8_t* zi_out;          // (B, 2(L-1))
  int n_cap, n, k, taps, d, a_sp, p_out, tile, n_tiles, nb, pitch;
  int n_sh, n_own, own_lanes, n_og, ns_sh, ns_own, g_sh, g_own;
  int plane_elems;
};

// exact uint8 -> float of (b - 128): 0x4B000000 | b is the float 2^23 + b
__device__ __forceinline__ float centred(unsigned b) {
  return __uint_as_float(0x4B000000u | b) - 8388736.0f;
}

// byte pair (I, Q) of complex sample e of ext = [zi | raw]; the zero level
// outside it
__device__ __forceinline__ unsigned ext_pair(const uint8_t* zi_row,
                                             const uint8_t* raw_row,
                                             long long e, int t1, int n) {
  if (e < 0) return 0x8080u;
  if (e < t1)
    return __ldg(reinterpret_cast<const unsigned short*>(zi_row) + e);
  if (e < (long long)t1 + n)
    return __ldg(reinterpret_cast<const unsigned short*>(raw_row) + (e - t1));
  return 0x8080u;
}

__device__ __forceinline__ void mac(float2& acc, float t, float2 x) {
  acc.x = fmaf(t, x.x, acc.x);
  acc.y = fmaf(t, x.y, acc.y);
}

__device__ __forceinline__ void mac(float2& acc, float2 t, float2 x) {
  acc.x = fmaf(t.x, x.x, acc.x);
  acc.x = fmaf(-t.y, x.y, acc.x);
  acc.y = fmaf(t.x, x.y, acc.y);
  acc.y = fmaf(t.y, x.x, acc.y);
}

// One plane's FIR for R consecutive outputs: acc[i] += sum_a tap(a) *
// prow[i - a + a_sp - 1] (prow: the plane's row of the thread's first output
// minus a_sp - 1).  AF > 0: A = AF taps, the whole window in registers;
// AF = 0: a_sp (a multiple of 4) taps in chunks of 4, the window sliding
// down 4 samples per chunk.  Taps a ascending.
template <int AF, typename Tap, typename TapAt>
__device__ __forceinline__ void plane_fir(const float2* prow, int a_sp,
                                          TapAt tap, float2 (&acc)[kR]) {
  if constexpr (AF > 0) {
    float2 win[kR + AF - 1];
#pragma unroll
    for (int m = 0; m < kR + AF - 1; ++m) win[m] = prow[m];
#pragma unroll
    for (int a = 0; a < AF; ++a) {
      const Tap t = tap(a);
#pragma unroll
      for (int i = 0; i < kR; ++i) mac(acc[i], t, win[i - a + AF - 1]);
    }
  } else {
    // chunk c holds taps 4c .. 4c+3; win[m] = prow[a_sp - 4 - 4c + m]
    float2 win[kR + 3];
    const float2* wp = prow + a_sp - 4;
#pragma unroll
    for (int m = 0; m < kR + 3; ++m) win[m] = wp[m];
    const int n4 = a_sp / 4;
    for (int c = 0; c < n4; ++c) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const Tap t = tap(4 * c + q);
#pragma unroll
        for (int i = 0; i < kR; ++i) mac(acc[i], t, win[i + 3 - q]);
      }
      if (c + 1 < n4) {
#pragma unroll
        for (int m = kR + 2; m >= 4; --m) win[m] = win[m - 4];
        wp -= 4;
#pragma unroll
        for (int m = 0; m < 4; ++m) win[m] = wp[m];
      }
    }
  }
}

template <int AF>
__global__ void __launch_bounds__(kThreads) composed_kernel(Args a) {
  extern __shared__ __align__(16) float2 smem[];
  float2* planes = smem;              // nb planes x pitch rows; then partials
  float* tapbuf = reinterpret_cast<float*>(smem + a.plane_elems);
  const int tid = threadIdx.x;
  const int cap = blockIdx.x / a.n_tiles;
  const int tile_idx = blockIdx.x % a.n_tiles;
  const int p0 = tile_idx * a.tile;
  const bool shared_role = (int)blockIdx.y == a.n_og;
  const int og = blockIdx.y;
  const int t1 = a.taps - 1;
  const uint8_t* raw_row = a.raw + (size_t)cap * 2 * a.n;
  const uint8_t* zi_row = a.zi + (size_t)cap * 2 * t1;

  // thread -> (lane, slice, group of R outputs)
  const int groups = a.tile / kR;
  const int lanes = shared_role ? 1 : a.own_lanes;
  const int ns = shared_role ? a.ns_sh : a.ns_own;
  const int gsub = shared_role ? a.g_sh : a.g_own;
  const bool active = tid < lanes * ns * groups;
  const int lane = tid % lanes;
  const int slice = (tid / lanes) % ns;
  const int grp = tid / (lanes * ns);
  const int rows = a.tile + a.a_sp - 1;
  const int tpitch = a.a_sp | 1;
  const float2* otap = reinterpret_cast<const float2*>(tapbuf);

  float2 acc[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) acc[i] = make_float2(0.0f, 0.0f);

  // plane row j of the tile holds q = p0 - (a_sp - 1) + j; plane b, row j
  // is ext[e0 + j*d + (d - 1 - b)]
  const long long e0 = (long long)a.d * (p0 - a.a_sp + 1) + a.taps - a.d;
  for (int b0 = 0; b0 < a.d; b0 += a.nb) {
    const int nbp = min(a.nb, a.d - b0);
    __syncthreads();                          // the last pass is read
    const long long e_end = e0 + (long long)rows * a.d;
    if (nbp == a.d && e0 >= t1 && e_end <= (long long)t1 + a.n) {
      // the window lies in raw: 16-byte loads (8 pairs each) from the
      // aligned chunk that holds its first pair on, kB in flight per thread
      const uint8_t* wb = raw_row + 2 * (e0 - t1);
      const uint4* base = reinterpret_cast<const uint4*>(
          reinterpret_cast<uintptr_t>(wb) & ~(uintptr_t)15);
      const int lead = (int)(wb - reinterpret_cast<const uint8_t*>(base)) / 2;
      const int n_el = rows * a.d;
      const int n_chunks = (lead + n_el + 7) / 8;
      for (int c0 = tid; c0 < n_chunks; c0 += kB * kThreads) {
        uint4 v[kB];
#pragma unroll
        for (int u = 0; u < kB; ++u)
          if (c0 + u * kThreads < n_chunks)
            v[u] = __ldg(base + c0 + u * kThreads);
#pragma unroll
        for (int u = 0; u < kB; ++u) {
          const int cidx = c0 + u * kThreads;
          if (cidx >= n_chunks) break;
          // pair w of the chunk is window sample 8*cidx - lead + w
          const int first = max(8 * cidx - lead, 0);
          int j = first / a.d, col = first - j * a.d;
          const unsigned words[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
          for (int w = 0; w < 8; ++w) {
            const int idx = 8 * cidx - lead + w;
            if (idx < 0 || idx >= n_el) continue;
            const unsigned iq = (words[w >> 1] >> (16 * (w & 1))) & 0xffffu;
            planes[(a.d - 1 - col) * a.pitch + j] =
                make_float2(centred(iq & 0xffu), centred(iq >> 8));
            if (++col == a.d) {
              col = 0;
              ++j;
            }
          }
        }
      }
    } else {
      // sample (row j, column col0 + bb) -> plane nbp-1-bb of the pass;
      // consecutive threads read consecutive samples
      const int n_el = rows * nbp;
      const long long col0 = a.d - b0 - nbp;
      const int sj = kThreads / nbp, sb = kThreads % nbp;
      int j = tid / nbp, bb = tid % nbp;
#pragma unroll 4
      for (int idx = tid; idx < n_el; idx += kThreads) {
        const unsigned iq = ext_pair(zi_row, raw_row,
                                     e0 + (long long)j * a.d + col0 + bb, t1,
                                     a.n);
        planes[(nbp - 1 - bb) * a.pitch + j] =
            make_float2(centred(iq & 0xffu), centred(iq >> 8));
        bb += sb;
        j += sj;
        if (bb >= nbp) {
          bb -= nbp;
          ++j;
        }
      }
    }
    for (int bs = b0; bs < b0 + nbp; bs += gsub) {
      const int ge = min(bs + gsub, b0 + nbp);
      __syncthreads();                        // planes staged / taps read
      if (shared_role) {
        const float* src = a.proto + (size_t)bs * tpitch;
        for (int idx = tid; idx < (ge - bs) * tpitch; idx += kThreads)
          tapbuf[idx] = __ldg(src + idx);
      } else {
        // (plane, tap, lane) from (plane, tap, own station)
        float2* dst = reinterpret_cast<float2*>(tapbuf);
        const int n_el = (ge - bs) * a.a_sp * a.own_lanes;
        for (int idx = tid; idx < n_el; idx += kThreads) {
          const int ln = idx % a.own_lanes;
          const int oi = og * a.own_lanes + ln;
          const size_t row = (size_t)bs * a.a_sp + idx / a.own_lanes;
          dst[idx] = oi < a.n_own ? __ldg(a.own_taps + row * a.n_own + oi)
                                  : make_float2(0.0f, 0.0f);
        }
      }
      __syncthreads();
      if (!active) continue;
      // this thread's planes in [bs, ge): b = slice mod ns
      for (int b = bs + ((slice - bs) % ns + ns) % ns; b < ge; b += ns) {
        const float2* prow = planes + (b - b0) * a.pitch + grp * kR;
        if (shared_role) {
          const float* tp = tapbuf + (b - bs) * tpitch;
          plane_fir<AF, float>(prow, a.a_sp,
                               [tp](int t) { return tp[t]; }, acc);
        } else {
          const float2* tp = otap + (size_t)(b - bs) * a.a_sp * a.own_lanes
                             + lane;
          const int step = a.own_lanes;
          plane_fir<AF, float2>(prow, a.a_sp,
                                [tp, step](int t) { return tp[t * step]; },
                                acc);
        }
      }
    }
  }

  // partial sums by (slice, lane), a pitch of tile + 1 (neighbouring slices
  // on distinct banks), over the dead planes
  __syncthreads();
  const int ppitch = a.tile + 1;
  if (active) {
    float2* pp = planes + (slice * lanes + lane) * ppitch + grp * kR;
#pragma unroll
    for (int i = 0; i < kR; ++i) pp[i] = acc[i];
  }
  __syncthreads();
  if (shared_role) {
    // y_k[p] = sum_r W^{k r} u_r[p] = sum_s W^{(k s) mod K} part_s[p]
    // (slice s holds planes b = s mod ns_sh, all of residue s mod K),
    // s ascending; the K twiddles W^m from the dead tap buffer
    float2* stw = reinterpret_cast<float2*>(tapbuf);
    for (int m = tid; m < a.k; m += kThreads) stw[m] = __ldg(a.tw + m);
    __syncthreads();
    for (int it = tid; it < a.n_sh * a.tile; it += kThreads) {
      const int q = it % a.tile;
      const int p = p0 + q;
      if (p >= a.p_out) continue;
      const int kk = __ldg(a.sh_list + it / a.tile);
      float2 s = make_float2(0.0f, 0.0f);
      int m = 0;
      for (int r = 0; r < ns; ++r) {
        mac(s, stw[m], planes[r * ppitch + q]);
        m += kk;
        if (m >= a.k) m -= a.k;
      }
      float* yr = a.y + ((size_t)cap * a.k + kk) * 2 * a.p_out;
      yr[p] = s.x;
      yr[a.p_out + p] = s.y;
    }
  } else {
    for (int it = tid; it < lanes * a.tile; it += kThreads) {
      const int q = it % a.tile, ln = it / a.tile;
      const int oi = og * a.own_lanes + ln;
      const int p = p0 + q;
      if (p >= a.p_out || oi >= a.n_own) continue;
      float2 s = make_float2(0.0f, 0.0f);
      for (int r = 0; r < ns; ++r) {
        const float2 u = planes[(r * lanes + ln) * ppitch + q];
        s.x += u.x;
        s.y += u.y;
      }
      const int kk = __ldg(a.own_list + oi);
      float* yr = a.y + ((size_t)cap * a.k + kk) * 2 * a.p_out;
      yr[p] = s.x;
      yr[a.p_out + p] = s.y;
    }
  }

  // the capture's first block also writes the new byte tail: the last
  // 2(L-1) bytes of ext, which start at ext byte 2n
  if (tile_idx == 0 && blockIdx.y == 0) {
    uint8_t* out = a.zi_out + (size_t)cap * 2 * t1;
    for (int j = tid; j < 2 * t1; j += kThreads) {
      const size_t e = 2 * (size_t)a.n + j;
      out[j] = e < 2 * (size_t)t1 ? zi_row[e] : raw_row[e - 2 * (size_t)t1];
    }
  }
}

template <int AF>
cudaError_t launch(const Args& a, size_t smem, dim3 grid,
                   cudaStream_t stream) {
  // more than 48 KB of dynamic shared memory needs an opt-in: made once per
  // instance and device, for the most any geometry takes
  static unsigned long long opted_in = 0;        // one bit per device
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const unsigned long long bit = 1ull << (dev & 63);
    if (!(opted_in & bit)) {
      e = cudaFuncSetAttribute(composed_kernel<AF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemCap);
      if (e != cudaSuccess) return e;
      opted_in |= bit;
    }
  }
  composed_kernel<AF><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// raw: (B, 2n) u8 and zi, zi_out: (B, 2(taps-1)) u8, rows at even addresses;
// y: (B, K, 2, n/d) float32.  The plan (ops/channelizer.py::composed_plan):
// proto (d, a_sp | 1) and tw (K, K, 2) float32, sh_list (n_sh) int32;
// own_taps (d, a_sp, n_own, 2) float32, own_list (n_own) int32; NULL where a
// route has no station.  The geometry (composed_geometry): tile, n_tiles,
// nb, pitch, own_lanes, n_og, ns_own, g_sh, g_own, plane_elems, smem.
// Needs n % d == 0.  Returns cudaGetLastError().
extern "C" int rtsdr_channelize_composed(
    const uint8_t* raw, const uint8_t* zi, const float* proto,
    const float* tw, const int* sh_list, const float* own_taps,
    const int* own_list, float* y, uint8_t* zi_out, int n_cap, int n, int k,
    int taps, int d, int a_sp, int p_out, int tile, int n_tiles, int nb,
    int pitch, int n_sh, int n_own, int own_lanes, int n_og, int ns_sh,
    int ns_own, int g_sh, int g_own, int plane_elems, int smem,
    void* stream) {
  const int groups = tile / kR;
  if (n_cap <= 0 || n <= 0 || k <= 0 || taps < 1 || d < 1 || n % d != 0 ||
      p_out != n / d || tile < kR || tile % kR != 0 ||
      n_tiles != (p_out + tile - 1) / tile || n_sh + n_own != k ||
      (n_sh > 0 && (proto == nullptr || sh_list == nullptr ||
                    ns_sh % k != 0 || ns_sh * groups > kThreads ||
                    g_sh < 1)) ||
      (n_own > 0 && (own_taps == nullptr || own_list == nullptr ||
                     own_lanes < 1 || own_lanes * ns_own * groups > kThreads ||
                     n_og * own_lanes < n_own || g_own < 1)) ||
      (a_sp != kFixedA && a_sp % 4 != 0) || (long long)a_sp * d < taps ||
      nb < 1 || pitch < tile + a_sp - 1 || smem > kSmemCap ||
      (long long)plane_elems < (long long)nb * pitch ||
      ((reinterpret_cast<uintptr_t>(raw) | reinterpret_cast<uintptr_t>(zi)) &
       1) != 0)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.raw = raw; a.zi = zi; a.proto = proto;
  a.tw = reinterpret_cast<const float2*>(tw); a.sh_list = sh_list;
  a.own_taps = reinterpret_cast<const float2*>(own_taps);
  a.own_list = own_list; a.y = y; a.zi_out = zi_out;
  a.n_cap = n_cap; a.n = n; a.k = k; a.taps = taps; a.d = d; a.a_sp = a_sp;
  a.p_out = p_out; a.tile = tile; a.n_tiles = n_tiles; a.nb = nb;
  a.pitch = pitch; a.n_sh = n_sh; a.n_own = n_own; a.own_lanes = own_lanes;
  a.n_og = n_og; a.ns_sh = ns_sh; a.ns_own = ns_own;
  a.g_sh = g_sh; a.g_own = g_own;
  a.plane_elems = plane_elems;
  const dim3 grid((unsigned)(n_cap * n_tiles),
                  (unsigned)(n_og + (n_sh > 0 ? 1 : 0)));
  cudaStream_t s = (cudaStream_t)stream;
  if (a_sp == kFixedA) return (int)launch<kFixedA>(a, smem, grid, s);
  return (int)launch<0>(a, smem, grid, s);
}
