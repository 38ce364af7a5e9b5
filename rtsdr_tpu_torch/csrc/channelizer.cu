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
//
// The two-stage role (composed_kernel_two_stage, a kernel of its own in
// the same launch slot: one launch a call, its name holding
// "composed_kernel").  Where the host has g's factors, g_k =
// conv(up_K(f_k), h^(k)) with h the real prototype and f_k station k's
// 151-tap RF filter turned to its offset, the sum regroups exactly:
//   stage A  s_k[m] = sum_r W^{k r} sum_{a<16} h[K a + r] X[K (m - a) - r]
//   stage B  y_k[p] = sum_{j<151} f_k[j] s_k[decim p - j]
// the slot bank at the slot rate (K real 16-tap FIRs on the K polyphase
// planes and one K-point DFT per slot sample, for every station at once),
// then each station's complex FIR at stride decim.  An offset station
// costs 8 L = 10,624 FLOP an output on its own taps; here the bank costs
// decim (4 * 16 K + 8 K^2) = 10,240 for all K = 8 stations (the DFT
// counted in direct form; the kernel's radix-2 does 78 FLOP a slot sample,
// not 512) and the RF FIR 8 * 151 a station: 19,904 an output against
// 79,744 for 1 shared + 7 own-taps stations.
//
// Bound on an H100 (K = 8, 128 captures of 2,457,600 bytes, the wideband
// cell): 39.1 GFLOP of least work (0.584 ms at 67 TFLOP/s) against 0.44
// GB (315 MB read, 126 MB written: 0.13 ms): operations.
//
// Design: a block is one capture's tile of `tile` outputs (56 at K = 8),
// 256 threads, two blocks an SM.  It stages the tile's window once, K
// (decim (tile + 15) + 15) complex samples as stage A's K planes (the
// staging above, exact conversion); stage A runs a residue's 16 taps from
// registers over groups of R = 8 slot samples (its halo: decim 15 slot
// samples for decim tile outputs, 27 % at tile 56) and writes u_r into
// stage B's layout (decim
// planes of odd pitch a station, stations an odd pitch apart); the DFT
// turns u_r into s_k in place, a slot sample a thread; stage B runs a
// (station, R outputs) per thread over a slice of the 2 decim half-planes
// of 8 taps, the taps in shared memory over the dead stage-A planes, the
// slices' partial sums added in order.  Shared memory 8 K (pitch_a + kp)
// bytes (92,032 at K = 8, tile 56).  One launch, not two: apart, s_k would
// be written to and read back from device memory, 2 x 1.26 GB a step at
// the cell (about 0.75 ms at 3.35 TB/s).  K = 4, 8 and 16 are compiled in
// (16 taps a plane in both stages, zero-padded).
//
// Several stations a slot.  A dense band puts S stations over the K slots
// (ops/channelizer.py::StationMap): station j takes slot slot_of[j]'s s_k
// and its own RF taps f_j.  Stage A and the DFT stay once per capture tile
// and slot; stage B runs S lanes, a (station, R outputs, slice) item per
// thread, 256 items at a time, reading its slot's s_k (stations of one
// slot read the same words: a broadcast).  Its taps (decim x 16 x S
// complex) and partial sums take the dead stage-A space, grown to a_elems
// float2 where they need more (S = 38 over K = 8: tile 48, 103,920 bytes,
// still two blocks an SM).  S and the map are read at run time: one
// station a slot is the map k -> k (at K = 8, 128 captures, 1 % slower
// than with S = K compiled in, the same outputs).
//
// The residual NCO in the epilogue.  A station off its slot's centre
// leaves stage B still turning at its offset; the receiver turns it back
// by exp(j (phase_j + ramp_j[p])): phase_j carried from block to block,
// ramp_j the host's float64 table of the offset's angle at each output,
// reduced mod 2 pi (step_j p in float32 reaches 3e5 rad at 0.8 MHz, where
// the float32 ulp is 0.03 rad).  Given both, the last loop turns each
// output as it writes it: one sincosf (the accurate one: the angle stays
// under 4 pi) and a complex multiply an output, the ramp read once (S x P
// float32, 2.3 MB at S = 38, from L2 across the captures), rounded as the
// stock ops round it.  In stock ops the same turn reads and writes the
// whole IF about six times (126 MB at 1,026 stations).  Without them y is
// what the bank gives, bit for bit.

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

// Stage passes of polyphase planes from ext = [zi | raw] (128 = 0),
// exactly converted: pass [b0, b0 + nbp) of the d planes, plane b - b0 of
// the pass at planes + (b - b0) * pitch, row j of plane b = ext[e0 + j*d +
// (d - 1 - b)] for j < rows.  The caller syncs before (the last pass is
// read) and after.
__device__ __forceinline__ void stage_planes(float2* planes, int pitch,
                                             const uint8_t* zi_row,
                                             const uint8_t* raw_row,
                                             long long e0, int rows, int d,
                                             int b0, int nbp, int t1, int n,
                                             int tid) {
  const long long e_end = e0 + (long long)rows * d;
  if (nbp == d && e0 >= t1 && e_end <= (long long)t1 + n) {
    // the window lies in raw: 16-byte loads (8 pairs each) from the
    // aligned chunk that holds its first pair on, kB in flight per thread
    const uint8_t* wb = raw_row + 2 * (e0 - t1);
    const uint4* base = reinterpret_cast<const uint4*>(
        reinterpret_cast<uintptr_t>(wb) & ~(uintptr_t)15);
    const int lead = (int)(wb - reinterpret_cast<const uint8_t*>(base)) / 2;
    const int n_el = rows * d;
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
        int j = first / d, col = first - j * d;
        const unsigned words[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          const int idx = 8 * cidx - lead + w;
          if (idx < 0 || idx >= n_el) continue;
          const unsigned iq = (words[w >> 1] >> (16 * (w & 1))) & 0xffffu;
          planes[(d - 1 - col) * pitch + j] =
              make_float2(centred(iq & 0xffu), centred(iq >> 8));
          if (++col == d) {
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
    const long long col0 = d - b0 - nbp;
    const int sj = kThreads / nbp, sb = kThreads % nbp;
    int j = tid / nbp, bb = tid % nbp;
#pragma unroll 4
    for (int idx = tid; idx < n_el; idx += kThreads) {
      const unsigned iq = ext_pair(zi_row, raw_row,
                                   e0 + (long long)j * d + col0 + bb, t1,
                                   n);
      planes[(nbp - 1 - bb) * pitch + j] =
          make_float2(centred(iq & 0xffu), centred(iq >> 8));
      bb += sb;
      j += sj;
      if (bb >= nbp) {
        bb -= nbp;
        ++j;
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
    stage_planes(planes, a.pitch, zi_row, raw_row, e0, rows, a.d, b0, nbp,
                 t1, a.n, tid);
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

// more than 48 KB of dynamic shared memory needs an opt-in: made once per
// kernel and device (``opted_in``: a bit per device, the caller's own), for
// the most any geometry takes
cudaError_t opt_in(const void* kernel, unsigned long long& opted_in,
                   size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(opted_in & bit)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemCap);
    if (e != cudaSuccess) return e;
    opted_in |= bit;
  }
  return cudaSuccess;
}

template <int AF>
cudaError_t launch(const Args& a, size_t smem, dim3 grid,
                   cudaStream_t stream) {
  static unsigned long long opted_in = 0;
  const cudaError_t e = opt_in(
      reinterpret_cast<const void*>(composed_kernel<AF>), opted_in, smem);
  if (e != cudaSuccess) return e;
  composed_kernel<AF><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The two-stage role: every station of one capture tile through the slot
// bank at the slot rate, then its own RF FIR, the slot-rate samples kept in
// shared memory between the two.

constexpr int kTapsA = 16;      // slot-bank taps per residue (compiled in)
constexpr int kTapsB = 16;      // RF taps per plane of decim (compiled in)
constexpr int kHalfB = kTapsB / 2;   // a stage-B unit: half a plane's taps

struct TwoStageArgs {
  const uint8_t *raw, *zi;
  const float* ha;          // (kTapsA, K): h[K a + r] / 128 at [a][r]
  const float2* fb;         // (decim, kTapsB, S): f_j[decim a + b] at [b][a][j]
  const float2* tw;         // (K): W^m
  const int* slot_of;       // (S): station j's slot
  const float* mix_phase;   // (S) or NULL: the residual NCO's carried phase
  const float* mix_ramp;    // (S, P) or NULL: its ramp, reduced mod 2 pi
  float* y;                 // (B, S, 2, P)
  uint8_t* zi_out;          // (B, 2(L-1))
  int n, n_st, taps, decim, p_out, tile, n_tiles, ns, pitch_a, a_elems, bp,
      kp;
};

// r's log2(KT) bits reversed
template <int KT>
__host__ __device__ constexpr int bit_reversed(int r) {
  int o = 0;
  for (int m = 1; m < KT; m <<= 1) {
    o = (o << 1) | (r & 1);
    r >>= 1;
  }
  return o;
}

template <int KT>
__host__ __device__ constexpr int log2_of() {
  int l = 0;
  while ((1 << l) < KT) ++l;
  return l;
}

// X_k = sum_r W^{k r} x_r (W = exp(2 pi i / KT), tw[m] = W^m), radix-2
// decimation in frequency: x in natural order; on return x[i] holds
// X_{bit_reversed(i)}.  A butterfly of span len: (u, w) -> (u + w,
// (u - w) W^{j KT / len}), the product skipped at j = 0.
template <int KT>
__device__ __forceinline__ void dft(float2 (&x)[KT],
                                    const float2 (&tw)[KT]) {
  constexpr int kLog = log2_of<KT>();
#pragma unroll
  for (int st = kLog - 1; st >= 0; --st) {
    const int half = 1 << st;
#pragma unroll
    for (int bf = 0; bf < KT / 2; ++bf) {     // butterfly bf of the stage
      const int j = bf & (half - 1);
      const int lo = ((bf >> st) << (st + 1)) + j;
      const float2 u = x[lo], w = x[lo + half];
      x[lo] = make_float2(u.x + w.x, u.y + w.y);
      const float2 v = make_float2(u.x - w.x, u.y - w.y);
      if (j == 0) {
        x[lo + half] = v;
      } else {
        const float2 t = tw[j << (kLog - 1 - st)];
        x[lo + half] = make_float2(fmaf(t.x, v.x, -(t.y * v.y)),
                                   fmaf(t.x, v.y, t.y * v.x));
      }
    }
  }
}

// A block: one capture's tile of `tile` outputs p0 + q.  With the factors
// h (the prototype, real) and f_k (station k's RF taps, complex),
//   s_k[m] = sum_{r<K} W^{k r} u_r[m],  u_r[m] = sum_{a<16} h[K a + r] X[K (m - a) - r]
//   y_k[p] = sum_{b<decim} sum_{a<16} f_k[decim a + b] s_k[decim (p - a) - b]
// Stage B reads s_k[decim q - b] for q in [p0 - 15, p0 + tile): stage A
// computes ms = decim (tile + 15) slot-rate samples m = m1 + t, m1 =
// decim (p0 - 16) + 1, and stores t = decim i + (decim - 1 - b) at row i of
// stage B's plane b (station pitch kp, plane pitch bp: both odd).  Stage
// A's planes: plane r row j = X[K (m1 - 15 + j) - r] = ext[e0 + K j + (K - 1
// - r)], e0 = d (p0 - 16) + L - 15 K.
//
// Threads: stage A, residue r = tid % K (its 16 taps in registers) and
// groups of R outputs t, tid / K apart; the DFT, one t a thread; stage B,
// items (station j = item % S, group of R outputs, slice of ns), item =
// tid + 256 i, a slice taking every ns-th of the 2 decim half-planes (8
// taps each) of its station's slot, the slices' partial sums added in
// order after.  Shared memory: stage A's planes (K x pitch_a float2) in the
// first a_elems float2, whose space then holds stage B's taps and the
// partial sums (pitch tile + 1); u_r and then s_k in place (K x kp) after
// it.
template <int KT>
__global__ void __launch_bounds__(kThreads, 2)
    composed_kernel_two_stage(TwoStageArgs a) {
  extern __shared__ __align__(16) float2 smem[];
  float2* planes = smem;                   // stage A; then taps, partials
  float2* sb = smem + a.a_elems;           // u_r, then s_k
  const int n_st = a.n_st;
  const int tid = threadIdx.x;
  const int cap = blockIdx.x / a.n_tiles;
  const int tile_idx = blockIdx.x % a.n_tiles;
  const int p0 = tile_idx * a.tile;
  const int d = a.decim * KT;
  const int t1 = a.taps - 1;
  const uint8_t* raw_row = a.raw + (size_t)cap * 2 * a.n;
  const uint8_t* zi_row = a.zi + (size_t)cap * 2 * t1;
  const int ms = a.decim * (a.tile + kTapsB - 1);
  const int ms_pad = (ms + kR - 1) / kR * kR;

  const long long e0 = (long long)d * (p0 - kTapsB) + a.taps
                       - (long long)KT * (kTapsA - 1);
  stage_planes(planes, a.pitch_a, zi_row, raw_row, e0,
               ms_pad + kTapsA - 1, KT, 0, KT, t1, a.n, tid);
  __syncthreads();

  // stage A: u_r[t], written to stage B's plane layout
  {
    const int r = tid % KT;
    float h[kTapsA];
#pragma unroll
    for (int t = 0; t < kTapsA; ++t) h[t] = __ldg(a.ha + t * KT + r);
    const float2* prow = planes + r * a.pitch_a;
    float2* ur = sb + r * a.kp;
    for (int g = tid / KT; g < ms_pad / kR; g += kThreads / KT) {
      float2 acc[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) acc[i] = make_float2(0.0f, 0.0f);
      plane_fir<kTapsA, float>(prow + g * kR, kTapsA,
                               [&h](int t) { return h[t]; }, acc);
      // t = g R + i: row t / decim of plane decim - 1 - t % decim
      int row = g * kR / a.decim, b = a.decim - 1 - (g * kR - row * a.decim);
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        if (g * kR + i < ms) ur[b * a.bp + row] = acc[i];
        if (--b < 0) {
          b = a.decim - 1;
          ++row;
        }
      }
    }
  }
  __syncthreads();

  // stage B's taps over the dead planes; the DFT across residues in place
  for (int i = tid; i < a.decim * kTapsB * n_st; i += kThreads)
    planes[i] = __ldg(a.fb + i);
  {
    float2 tw[KT];
#pragma unroll
    for (int m = 0; m < KT; ++m) tw[m] = __ldg(a.tw + m);
    // t = tid + kThreads n: row t / decim of plane decim - 1 - t % decim
    const int row_step = kThreads / a.decim;
    const int b_step = kThreads - row_step * a.decim;
    int row = tid / a.decim, b = a.decim - 1 - (tid - row * a.decim);
    for (int t = tid; t < ms; t += kThreads) {
      float2* col = sb + b * a.bp + row;
      row += row_step;
      b -= b_step;
      if (b < 0) {
        b += a.decim;
        ++row;
      }
      float2 x[KT];
#pragma unroll
      for (int r = 0; r < KT; ++r) x[r] = col[r * a.kp];
      dft<KT>(x, tw);
#pragma unroll
      for (int i = 0; i < KT; ++i) col[bit_reversed<KT>(i) * a.kp] = x[i];
    }
  }
  __syncthreads();

  // stage B: each station's RF FIR over its slot's s_k, half-planes of 8
  // taps
  const int groups = a.tile / kR;
  const int ppitch = a.tile + 1;
  float2* part = planes + a.decim * kTapsB * n_st;
  const int n_items = n_st * groups * a.ns;
  for (int item = tid; item < n_items; item += kThreads) {
    const int j = item % n_st;
    const int grp = (item / n_st) % groups;
    const int slice = item / (n_st * groups);
    const int slot = __ldg(a.slot_of + j);
    float2 acc[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) acc[i] = make_float2(0.0f, 0.0f);
    const float2* sk = sb + slot * a.kp + grp * kR;
    for (int u = slice; u < 2 * a.decim; u += a.ns) {
      const int b = u >> 1, half = u & 1;
      // taps kHalfB * half + t of plane b meet rows i - t + 15 - kHalfB * half
      const float2* tp = planes + (b * kTapsB + kHalfB * half) * n_st + j;
      plane_fir<kHalfB, float2>(sk + b * a.bp + kHalfB * (1 - half), kHalfB,
                                [tp, n_st](int t) { return tp[t * n_st]; },
                                acc);
    }
    float2* pp = part + (slice * n_st + j) * ppitch + grp * kR;
#pragma unroll
    for (int i = 0; i < kR; ++i) pp[i] = acc[i];
  }
  __syncthreads();
  for (int it = tid; it < n_st * a.tile; it += kThreads) {
    const int q = it % a.tile, kk = it / a.tile;
    const int p = p0 + q;
    if (p >= a.p_out) continue;
    float2 s = make_float2(0.0f, 0.0f);
    for (int sl = 0; sl < a.ns; ++sl) {
      const float2 v = part[(sl * n_st + kk) * ppitch + q];
      s.x += v.x;
      s.y += v.y;
    }
    if (a.mix_ramp != nullptr) {
      // the residual NCO: (I + jQ) exp(j (phase_k + ramp_k[p])), each
      // product and sum rounded apart as the receiver's stock mix rounds
      // them (no contraction into FMAs)
      float sn, cs;
      sincosf(__fadd_rn(__ldg(a.mix_phase + kk),
                        __ldg(a.mix_ramp + (size_t)kk * a.p_out + p)),
              &sn, &cs);
      s = make_float2(__fsub_rn(__fmul_rn(s.x, cs), __fmul_rn(s.y, sn)),
                      __fadd_rn(__fmul_rn(s.x, sn), __fmul_rn(s.y, cs)));
    }
    float* yr = a.y + ((size_t)cap * n_st + kk) * 2 * a.p_out;
    yr[p] = s.x;
    yr[a.p_out + p] = s.y;
  }

  // the capture's first block also writes the new byte tail
  if (tile_idx == 0) {
    uint8_t* out = a.zi_out + (size_t)cap * 2 * t1;
    for (int j = tid; j < 2 * t1; j += kThreads) {
      const size_t e = 2 * (size_t)a.n + j;
      out[j] = e < 2 * (size_t)t1 ? zi_row[e] : raw_row[e - 2 * (size_t)t1];
    }
  }
}

template <int KT>
cudaError_t launch_two_stage(const TwoStageArgs& a, size_t smem, dim3 grid,
                             cudaStream_t stream) {
  static unsigned long long opted_in = 0;
  const cudaError_t e = opt_in(
      reinterpret_cast<const void*>(composed_kernel_two_stage<KT>), opted_in,
      smem);
  if (e != cudaSuccess) return e;
  composed_kernel_two_stage<KT><<<grid, kThreads, smem, stream>>>(a);
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

// The two-stage role (ops/channelizer.py::composed_plan with factors): raw,
// zi, zi_out as above; y (B, S, 2, n/d) float32; ha (16, K) and fb (decim,
// 16, S, 2) float32, tw (K, 2); slot_of (S) int32, each station's slot in
// [0, K); mix_phase (S) and mix_ramp (S, n/d) float32, both or neither
// (NULL: y as the bank leaves it).  The geometry
// (two_stage_geometry): tile, n_tiles, ns, pitch_a, a_elems, bp, kp, smem.
// K in {4, 8, 16}; needs n % (decim K) == 0.  Returns cudaGetLastError().
extern "C" int rtsdr_channelize_two_stage(
    const uint8_t* raw, const uint8_t* zi, const float* ha, const float* fb,
    const float* tw, const int* slot_of, const float* mix_phase,
    const float* mix_ramp, float* y, uint8_t* zi_out,
    int n_cap, int n, int k, int n_st, int taps, int decim, int p_out,
    int tile, int n_tiles, int ns, int pitch_a, int a_elems, int bp, int kp,
    int smem, void* stream) {
  const int d = decim * k;
  const int ms = decim * (tile + kTapsB - 1);
  const int ms_pad = (ms + kR - 1) / kR * kR;
  if (n_cap <= 0 || n <= 0 || (k != 4 && k != 8 && k != 16) || decim < 1 ||
      n_st < 1 || slot_of == nullptr ||
      (mix_phase == nullptr) != (mix_ramp == nullptr) ||
      taps < 1 || n % d != 0 || p_out != n / d || tile < kR ||
      tile % kR != 0 || n_tiles != (p_out + tile - 1) / tile || ns < 1 ||
      k * (tile / kR) > kThreads || bp < tile + kTapsB - 1 ||
      kp < decim * bp || pitch_a < ms_pad + kTapsA - 1 ||
      a_elems < k * pitch_a ||
      (long long)decim * kTapsB * n_st + (long long)ns * n_st * (tile + 1) >
          a_elems ||
      smem < 8LL * (a_elems + (long long)k * kp) || smem > kSmemCap ||
      ((reinterpret_cast<uintptr_t>(raw) | reinterpret_cast<uintptr_t>(zi)) &
       1) != 0)
    return (int)cudaErrorInvalidValue;
  TwoStageArgs a = {};
  a.raw = raw; a.zi = zi; a.ha = ha;
  a.fb = reinterpret_cast<const float2*>(fb);
  a.tw = reinterpret_cast<const float2*>(tw);
  a.slot_of = slot_of;
  a.mix_phase = mix_phase; a.mix_ramp = mix_ramp;
  a.y = y; a.zi_out = zi_out;
  a.n = n; a.n_st = n_st; a.taps = taps; a.decim = decim; a.p_out = p_out;
  a.tile = tile; a.n_tiles = n_tiles; a.ns = ns; a.pitch_a = pitch_a;
  a.a_elems = a_elems; a.bp = bp; a.kp = kp;
  const dim3 grid((unsigned)(n_cap * n_tiles));
  cudaStream_t s = (cudaStream_t)stream;
  if (k == 4) return (int)launch_two_stage<4>(a, smem, grid, s);
  if (k == 8) return (int)launch_two_stage<8>(a, smem, grid, s);
  return (int)launch_two_stage<16>(a, smem, grid, s);
}
