// PLL / NCO carrier recovery: the whole stage in one kernel.
//
// Per lane (one loop instance), per sample k of the block:
//   if k % loop_div == 0:                     (loop-filter update)
//     e      = atan2(-x[k]*sin(a), x[k]*cos(a)),  a = previous theta + phase
//     integ += ki * e
//     phase  = mod(phase + kp*e + integ, 4*pi)
//   theta = mod(theta + dtheta, 4*pi);  a = theta + phase
//   nco[k] = cos/sin(a * scale + adjust)
// The outputs are the delayed-by-one view (element 0 = the state's last NCO
// sample) unless delay_output is 0.  New state (7, C): integrator, phase_est,
// fb_i = cos(a), fb_q = sin(a), nco_i, nco_q (undelayed last sample), theta.
//
// Replaces the Pallas kernels rtsdr_tpu/ops/pallas_pll.py::_kernel_v4 /
// _kernel_v6 / _kernel_v7 (reached through _call_v4) and ::_kernel_theta
// (through _call_theta): one thread per lane has no limit on distinct
// per-lane dtheta, so both routes are this one kernel.  Kept from them: the
// detector without atan2 — its argument is (x cos a, -x sin a), so the angle
// is exactly wrap_pi(-a) for x > 0, wrap_pi(pi - a) for x < 0 and 0 for
// x == 0 — which takes every transcendental off the recurrence.  The entry
// angle comes from the state's (fb_i, fb_q).  Not kept: theta tables, 8-row
// groups, lane slabs, in-memory transposes of whole chunks.
//
// Bound on an H100: neither bytes nor operations but the latency of the
// dependent chain (wrap, two multiply-adds, a floor-mod) times N samples:
// a lane's samples cannot overlap, and 1,024 lanes are few threads for 132
// SMs.  The roofline bound reported for it is the bytes bound (x in, two
// NCO streams out).  Design: latency-bound work wants many resident warps
// rather than full ones, so a block is one warp that owns only 2, 4 or 8
// lanes — the fewest that keeps the grid within 8 blocks per SM: 1,024 lanes
// are 512 blocks, four warps on every SM, and while one walks its
// recurrence the others move data.  The first threads of the warp walk the
// recurrences, all 32 move data.  x is channel-major (C, N), so a thread
// walking its own row would read uncoalesced: (lanes x 64 samples) tiles are
// staged through padded shared memory — each warp instruction reads 32
// consecutive samples of one lane, the next tile's loads are issued before
// the current tile's walk so they fly while it runs — and the NCO cos/sin
// are synthesised from the stored angles on the way out, 32 consecutive
// samples of one lane per instruction, off the sequential chain.  A tuple
// input arrives as separate pointers with lane counts; no stacked copy is
// made.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;    // one warp per block
constexpr int kMaxLanes = 8;    // most lanes (loop instances) per block
constexpr int kTile = 64;       // samples staged per tile
constexpr int kPer = kTile / kThreads;   // samples per thread and row
constexpr int kXPitch = kTile + 1;   // odd pitches: conflict-free row walks
constexpr int kAPitch = kTile + 3;   // holds kTile + 1 angles per row
constexpr int kMaxParts = 4;

constexpr float kPi = 3.14159265358979323846f;
constexpr float kFourPi = 12.56637061435917295385f;
constexpr float kInvTwoPi = 0.15915494309189533577f;
// 2*pi split for a two-step reduction: hi has few mantissa bits set
constexpr float kTwoPiHi = 6.28318548202514648438f;     // float(2*pi)
constexpr float kTwoPiLo = -1.74845553146951715e-7f;    // 2*pi - hi

struct Parts {
  const float* ptr[kMaxParts];
  int end[kMaxParts];   // exclusive lane end of each part
  int n;
};

// wrap to [-pi, pi].  The nearest integer comes from adding and
// subtracting 1.5 * 2^23 (round-to-nearest-even, as rintf, for |z / 2 pi| <
// 2^22) — two additions instead of a conversion instruction.
__device__ __forceinline__ float wrap_pi(float z) {
  const float k = (z * kInvTwoPi + 12582912.0f) - 12582912.0f;
  return fmaf(-k, kTwoPiLo, fmaf(-k, kTwoPiHi, z));
}

// floor-mod by 4*pi (the sign of the result follows the divisor).
// EXACT: fmodf plus the sign fix, any z.  Otherwise one step off the range
// [0, 4*pi) is folded back with selects — exact too (z - 4*pi is
// representable for z in [4*pi, 8*pi), and fmodf(z) == z for z in
// (-4*pi, 0)) and free of branches on the recurrence's own values; a z
// farther off only raises `far`, and the caller redoes the tile EXACT.
template <bool EXACT>
__device__ __forceinline__ float mod_four_pi(float z, bool& far) {
  if (EXACT) {
    z = fmodf(z, kFourPi);
    if (z < 0.0f) z += kFourPi;
    return z;
  }
  z -= (z >= kFourPi) ? kFourPi : 0.0f;
  z += (z < 0.0f) ? kFourPi : 0.0f;
  far |= !(z >= 0.0f && z <= kFourPi);
  return z;
}

// One lane's recurrence over a staged tile: x in xrow[0..len), the angle
// after each sample to arow[1..len].  Everything that depends on x alone
// (sign, zero mask, gating by loop_div) is a select off the dependent chain
// a -> e -> (integ, phase) -> a.  Returns whether a value left the range
// the select-only floor-mod covers.
template <bool EXACT>
__device__ __forceinline__ bool walk_tile(const float* xrow, float* arow,
                                          int len, int t0, int div_mask,
                                          float ki, float kp, float dth,
                                          float& integ, float& phase,
                                          float& theta, float& a) {
  bool far = false;
#pragma unroll 4
  for (int tt = 0; tt < len; ++tt) {
    const float xk = xrow[tt];
    const bool step = ((t0 + tt) & div_mask) == 0;   // a loop-filter step
    const bool seen = step && xk != 0.0f;            // ... with a signal
    const float off = xk < 0.0f ? kPi : 0.0f;
    const float kiu = seen ? ki : 0.0f, kpu = seen ? kp : 0.0f;
    const float e = wrap_pi(off - a);
    integ = fmaf(kiu, e, integ);
    phase = mod_four_pi<EXACT>(
        fmaf(kpu, e, phase) + (step ? integ : 0.0f), far);
    theta = mod_four_pi<EXACT>(theta + dth, far);
    a = theta + phase;
    arow[tt + 1] = a;
  }
  return far;
}

__device__ __forceinline__ const float* lane_row(const Parts& parts, int lane,
                                                 int n) {
  int start = 0;
  for (int p = 0; p < parts.n; ++p) {
    if (lane < parts.end[p])
      return parts.ptr[p] + (size_t)(lane - start) * n;
    start = parts.end[p];
  }
  return nullptr;
}

template <int kLanes>   // lanes per block: 2, 4 or 8
__global__ void __launch_bounds__(kThreads)
pll_kernel(Parts parts, const float* __restrict__ consts,
           const float* __restrict__ st_in, float* __restrict__ st_out,
           float* __restrict__ nco_i, float* __restrict__ nco_q, int n_lanes,
           int n, int div_mask, int delay_output) {
  __shared__ float xs[kLanes * kXPitch];
  __shared__ float sa[kLanes * kAPitch];   // sa[r][0] = angle before the tile
  __shared__ float s_scale[kLanes], s_adjust[kLanes], s_ni0[kLanes],
      s_nq0[kLanes];
  __shared__ const float* s_row[kLanes];

  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * kLanes;
  const int rows = min(kLanes, n_lanes - lane0);   // live lanes of the block
  const int lane = lane0 + tid;
  const bool walker = tid < rows;                  // runs a recurrence

  float kp = 0.f, ki = 0.f, dth = 0.f;
  float integ = 0.f, phase = 0.f, theta = 0.f, a = 0.f;
  if (walker) {
    kp = consts[0 * n_lanes + lane];
    ki = consts[1 * n_lanes + lane];
    dth = consts[2 * n_lanes + lane];
    s_scale[tid] = consts[3 * n_lanes + lane];
    s_adjust[tid] = consts[4 * n_lanes + lane];
    integ = st_in[0 * n_lanes + lane];
    phase = st_in[1 * n_lanes + lane];
    // entry feedback angle from the carried (cos, sin) pair
    a = atan2f(st_in[3 * n_lanes + lane], st_in[2 * n_lanes + lane]);
    s_ni0[tid] = st_in[4 * n_lanes + lane];
    s_nq0[tid] = st_in[5 * n_lanes + lane];
    theta = st_in[6 * n_lanes + lane];
    s_row[tid] = lane_row(parts, lane, n);
    sa[tid * kAPitch] = a;
  }
  __syncwarp();

  // x of the next tile, in flight while the current tile is walked:
  // row r, samples tid and tid + 32 of the tile
  float nxt[kLanes * kPer];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int r = 0; r < kLanes; ++r)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int k = t0 + tid + j * kThreads;
        nxt[r * kPer + j] = (r < rows && k < n) ? s_row[r][k] : 0.0f;
      }
  };
  fetch(0);

  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int len = min(kTile, n - t0);
#pragma unroll
    for (int r = 0; r < kLanes; ++r)
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        xs[r * kXPitch + tid + j * kThreads] = nxt[r * kPer + j];
    __syncwarp();
    if (t0 + kTile < n) fetch(t0 + kTile);

    // the recurrence: thread r walks lane lane0 + r
    if (walker) {
      const float i0 = integ, p0 = phase, th0 = theta, a0 = a;
      if (walk_tile<false>(xs + tid * kXPitch, sa + tid * kAPitch, len, t0,
                           div_mask, ki, kp, dth, integ, phase, theta, a)) {
        integ = i0, phase = p0, theta = th0, a = a0;
        walk_tile<true>(xs + tid * kXPitch, sa + tid * kAPitch, len, t0,
                        div_mask, ki, kp, dth, integ, phase, theta, a);
      }
    }
    __syncwarp();

    // NCO synthesis on the way out, off the sequential chain
    for (int r = 0; r < rows; ++r) {
      const int ln = lane0 + r;
      const float sc = s_scale[r], ad = s_adjust[r];
      for (int tt = tid; tt < len; tt += kThreads) {
        const int k = t0 + tt;
        float si, co;
        if (delay_output && k == 0) {
          co = s_ni0[r];
          si = s_nq0[r];
        } else {
          const float ang = sa[r * kAPitch + tt + (delay_output ? 0 : 1)];
          sincosf(fmaf(ang, sc, ad), &si, &co);
        }
        nco_i[(size_t)ln * n + k] = co;
        nco_q[(size_t)ln * n + k] = si;
      }
    }
    __syncwarp();
    if (walker) sa[tid * kAPitch] = a;   // the angle before the next tile
    __syncwarp();
  }

  if (walker) {
    float si, co;
    st_out[0 * n_lanes + lane] = integ;
    st_out[1 * n_lanes + lane] = phase;
    sincosf(a, &si, &co);
    st_out[2 * n_lanes + lane] = co;
    st_out[3 * n_lanes + lane] = si;
    sincosf(fmaf(a, s_scale[tid], s_adjust[tid]), &si, &co);
    st_out[4 * n_lanes + lane] = co;
    st_out[5 * n_lanes + lane] = si;
    st_out[6 * n_lanes + lane] = theta;
  }
}

}  // namespace

// parts: HOST array of n_parts device pointers, part p an (lanes[p], N)
// float32 array; part_lanes: HOST array of their lane counts (sum = C).
// consts: (5, C) rows kp, ki, dtheta, scale, adjust.  st_in / st_out: (7, C)
// rows integrator, phase_est, fb_i, fb_q, nco_i, nco_q, theta.  nco_i, nco_q:
// (C, N).  Returns cudaGetLastError().
extern "C" int rtsdr_pll(const void* const* parts, const int* part_lanes,
                         int n_parts, const float* consts, const float* st_in,
                         float* st_out, float* nco_i, float* nco_q,
                         int n_lanes, int n, int loop_div, int delay_output,
                         void* stream) {
  if (n_parts < 1 || n_parts > kMaxParts || n_lanes <= 0 || n <= 0 ||
      loop_div < 1 || (loop_div & (loop_div - 1)) != 0)
    return (int)cudaErrorInvalidValue;     // loop_div: a power of two
  Parts p;
  int end = 0;
  for (int i = 0; i < kMaxParts; ++i) {
    if (i < n_parts) {
      end += part_lanes[i];
      p.ptr[i] = (const float*)parts[i];
    } else {
      p.ptr[i] = nullptr;
    }
    p.end[i] = end;
  }
  p.n = n_parts;
  if (end != n_lanes) return (int)cudaErrorInvalidValue;
  // lanes per block: the fewest of 2, 4, 8 that keeps the grid within 8
  // one-warp blocks per SM (see the note at the top)
  static int n_sm = 0;
  if (n_sm == 0) {
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
  }
  int lanes = 2;
  while (lanes < kMaxLanes && (n_lanes + lanes - 1) / lanes > 8 * n_sm)
    lanes *= 2;
  const int blocks = (n_lanes + lanes - 1) / lanes;
  cudaStream_t s = (cudaStream_t)stream;
  const int mask = loop_div - 1;
  if (lanes == 2)
    pll_kernel<2><<<blocks, kThreads, 0, s>>>(
        p, consts, st_in, st_out, nco_i, nco_q, n_lanes, n, mask, delay_output);
  else if (lanes == 4)
    pll_kernel<4><<<blocks, kThreads, 0, s>>>(
        p, consts, st_in, st_out, nco_i, nco_q, n_lanes, n, mask, delay_output);
  else
    pll_kernel<8><<<blocks, kThreads, 0, s>>>(
        p, consts, st_in, st_out, nco_i, nco_q, n_lanes, n, mask, delay_output);
  return (int)cudaGetLastError();
}
