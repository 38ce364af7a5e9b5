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
// x == 0 — and the short recurrence of their note (pallas_pll.py:12-27).
//
// Bound on an H100: neither bytes nor operations but the latency of the
// dependent chain phase -> phase times N samples: a lane's samples cannot
// overlap.  The roofline bound reported for it is the bytes bound (x in,
// two NCO streams out); the chain-latency bound is in PERF.md.  The first
// version of this kernel ran ~3 x slower than its chain: its one warp
// walked a tile, then stopped to synthesise the NCO with sincosf and store
// it; at 2,048 lanes a warp walked only 2 lanes; and its chain held both
// per-sample mod-4*pi folds, kp*e and the integrator as two dependent
// steps, and the range check.
//
// Design:
//   * Warp specialisation.  A block is one walker warp and three helper
//     warps.  Each walker thread walks one lane: up to 32 lanes per block,
//     as few as there are lanes per SM (2,048 lanes: 16 lanes in each of 128
//     blocks; the C = 1 pilot / carrier pair: one lane in each of 2).  The
//     helpers run a ring of 4 stages of 64-sample tiles in shared memory:
//     they stage x with cp.async (4-byte copies: any row start, any N, any
//     tuple part), and read the walker's angles of a tile back to
//     synthesise nco_i / nco_q (the angle reduced by a two-part 2*pi, then
//     the hardware __sincosf, four samples in flight per thread) with
//     coalesced stores.
//     The stages hand over by named barriers (bar.arrive / bar.sync: "x of
//     stage s is staged", "the angles of stage s are written"), so the
//     walker waits for a tile only when the ring is empty.
//   * A shorter chain.  With kq = kp + ki the update is
//       z      = (off - theta_prev) - phase          off = 0 or pi by x's sign
//       t      = z - 2*pi*rint(z / 2*pi)             (the detector's wrap)
//       phase' = (phase + integ) + m*kq * t,  integ' = integ + m*ki * t
//     (m = 0 for x == 0), five dependent operations from phase to phase':
//     the sum phase + integ, theta's advance and its fold, x's sign, zero
//     mask and the loop_div gate are off the chain; the wrap's low part of
//     2*pi is added beside the last step.  phase's mod 4*pi is deferred to
//     once per 8 samples (it then differs from the per-sample-wrapped one
//     by whole multiples of 4*pi and rounding); the stored angle folds it
//     back per sample only where some lane's nco_scale is not a
//     half-integer (where 4*pi*scale is not a whole turn).  theta keeps the
//     plain version's per-sample float32 ramp, exactly (one conditional
//     subtraction where every lane's dtheta is in [0, 4*pi)); it depends on
//     no data, so it runs ahead of the phase chain.  x of the next 8
//     samples is in registers before the first of them is walked, so no
//     shared-memory load latency sits between two samples.  A tile whose
//     deferred fold or theta left [0, 4*pi] (a dtheta beyond 4*pi, a
//     non-finite x) is walked again with exact per-sample folds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHelpers = 3;                  // helper warps per block
constexpr int kThreads = 32 * (1 + kHelpers);
constexpr int kHelperThreads = 32 * kHelpers;
constexpr int kMaxLanes = 32;                // lanes (walkers) per block
constexpr int kTile = 64;                    // samples per stage
constexpr int kPitch = kTile + 1;            // odd: conflict-free row walks
constexpr int kStages = 4;
constexpr int kMaxParts = 4;

constexpr float kPi = 3.14159265358979323846f;
constexpr float kFourPi = 12.56637061435917295385f;
constexpr float kInvTwoPi = 0.15915494309189533577f;
constexpr float kMagic = 12582912.0f;                 // 1.5 * 2^23
// 2*pi split for a two-step reduction
constexpr float kTwoPiHi = 6.28318548202514648438f;   // float(2*pi)
constexpr float kTwoPiLo = -1.74845553146951715e-7f;  // 2*pi - hi

struct Parts {
  const float* ptr[kMaxParts];
  int end[kMaxParts];   // exclusive lane end of each part
  int n;
};

// named barriers 1..2*kStages (0 is __syncthreads).  An arrival orders the
// arriving thread's earlier shared-memory writes (and its completed
// cp.async copies) before the waiting threads' later reads: no fence.
__device__ __forceinline__ int bar_full(int s) { return 1 + s; }
__device__ __forceinline__ int bar_walked(int s) { return 1 + kStages + s; }
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

// 4-byte asynchronous copy to shared memory; zero-filled unless `valid`
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// z mod 4*pi for z in [-4*pi, 8*pi): exact (z -+ 4*pi is representable
// there), branch-free; both tests read z, so two selects deep
__device__ __forceinline__ float fold(float z) {
  return z >= kFourPi ? z - kFourPi : (z < 0.0f ? z + kFourPi : z);
}

// floor-mod by 4*pi, any z (fmodf is exact)
__device__ __forceinline__ float mod_exact(float z) {
  z = fmodf(z, kFourPi);
  return z < 0.0f ? z + kFourPi : z;
}

// z - 2*pi*rint(z / 2*pi) in [-pi, pi], the low part of 2*pi included:
// the argument range where __sincosf is accurate to ~4e-7
__device__ __forceinline__ float reduce_two_pi(float z) {
  const float k = fmaf(z, kInvTwoPi, kMagic) - kMagic;
  return fmaf(-k, kTwoPiLo, fmaf(-k, kTwoPiHi, z));
}

__device__ __forceinline__ bool in_range(float z) {
  return z >= 0.0f && z <= kFourPi;
}

// one walker's loop: constants and carried values
struct Walk {
  float kq, ki, kqlo, kilo, dth;   // kqlo = -kq * lo(2 pi), kilo likewise
  float integ, phase, theta;
  float tp;                        // theta before this sample's advance
  float a;                         // the last angle stored
};

// One sample.  `step`: a loop-filter update (compile-time in unrolled
// code).  EXACT: the per-sample folds of the plain version, any range.
// UP: every lane's dtheta lies in [0, 4*pi), so theta + dtheta < 8*pi and
// one conditional subtraction is theta's whole fold (one select deep).
template <bool EXACT, bool UP>
__device__ __forceinline__ void sample(Walk& w, float xk, bool step) {
  if (step) {
    const bool live = xk != 0.0f;
    const float off = xk < 0.0f ? kPi : 0.0f;
    const float mq = live ? w.kq : 0.0f, mi = live ? w.ki : 0.0f;
    const float mqlo = live ? w.kqlo : 0.0f, milo = live ? w.kilo : 0.0f;
    const float z = (off - w.tp) - w.phase;
    const float k = fmaf(z, kInvTwoPi, kMagic) - kMagic;
    const float tr = fmaf(-k, kTwoPiHi, z);
    const float pi_pre = w.phase + w.integ;
    w.phase = fmaf(mq, tr, fmaf(k, mqlo, pi_pre));
    w.integ = fmaf(mi, tr, fmaf(k, milo, w.integ));
    if (EXACT) w.phase = mod_exact(w.phase);
  }
  const float th = w.theta + w.dth;
  w.theta = EXACT ? mod_exact(th)
          : UP    ? (th >= kFourPi ? th - kFourPi : th)
                  : fold(th);
  w.tp = w.theta;
}

// the angle stored for sample k: theta + phase, phase folded back into
// [0, 4 pi) where the NCO scale needs it
template <bool FOLD>
__device__ __forceinline__ float angle(const Walk& w) {
  return w.theta + (FOLD ? fold(w.phase) : w.phase);
}

// Walk one staged tile: x in xrow[0..len), the angle after each sample to
// arow[1..len] (arow[0] = the angle before the tile).  Returns whether a
// deferred fold or theta left its range.
template <int DIV, bool FOLD, bool UP>
__device__ __forceinline__ bool walk_tile(const float* __restrict__ xrow,
                                          float* __restrict__ arow, int len,
                                          Walk& w) {
  bool far = false;
  arow[0] = w.a;
  if (len == kTile) {
    // x of a group is in registers before the group's first sample and the
    // next group's loads are issued before its stores: no shared-memory
    // load latency between one sample's angle and the next sample
    float xv[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) xv[r] = xrow[r];
#pragma unroll 1
    for (int g = 0; g < kTile; g += 8) {
      float xn[8];
      const int gn = g + 8 < kTile ? g + 8 : g;
#pragma unroll
      for (int r = 0; r < 8; ++r) xn[r] = xrow[gn + r];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        sample<false, UP>(w, xv[r], r % DIV == 0);
        w.a = angle<FOLD>(w);
        arow[g + r + 1] = w.a;
      }
      w.phase = fold(w.phase);
      far |= !in_range(w.phase) || !in_range(w.theta);
#pragma unroll
      for (int r = 0; r < 8; ++r) xv[r] = xn[r];
    }
  } else {
#pragma unroll 1
    for (int tt = 0; tt < len; ++tt) {
      sample<false, UP>(w, xrow[tt], (tt & (DIV - 1)) == 0);
      w.a = angle<FOLD>(w);
      arow[tt + 1] = w.a;
      if ((tt & 7) == 7) {
        w.phase = fold(w.phase);
        far |= !in_range(w.phase) || !in_range(w.theta);
      }
    }
    w.phase = fold(w.phase);
    far |= !in_range(w.phase) || !in_range(w.theta);
  }
  return far;
}

__device__ __forceinline__ void walk_tile_exact(const float* xrow, float* arow,
                                                int len, int div_mask,
                                                Walk& w) {
  arow[0] = w.a;
  for (int tt = 0; tt < len; ++tt) {
    sample<true, false>(w, xrow[tt], (tt & div_mask) == 0);
    w.a = w.theta + w.phase;
    arow[tt + 1] = w.a;
  }
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

// The walker warp: thread r walks lane lane0 + r over every tile.
template <int DIV, bool FOLD, bool UP>
__device__ void walker(Walk& w, bool walks, const float* xs, float* sa,
                       int n, int n_tiles) {
  const int tid = threadIdx.x;
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const int len = min(kTile, n - i * kTile);
    bar_sync(bar_full(s));
    if (walks) {
      const float* xrow = xs + (s * kMaxLanes + tid) * kPitch;
      float* arow = sa + (s * kMaxLanes + tid) * kPitch;
      const Walk w0 = w;
      if (walk_tile<DIV, FOLD, UP>(xrow, arow, len, w)) {
        w = w0;
        walk_tile_exact(xrow, arow, len, DIV - 1, w);
      }
    }
    bar_arrive(bar_walked(s));
  }
}

// stage x of tile i (every lane of the block) into stage i % kStages
__device__ __forceinline__ void stage_x(float* xs, const float* const* rowp,
                                        int rows, int n, int i, int hid) {
  const int s = i % kStages, t0 = i * kTile;
  for (int idx = hid; idx < rows * kTile; idx += kHelperThreads) {
    const int r = idx / kTile, tt = idx % kTile;
    const bool valid = t0 + tt < n;
    cp_async4(xs + (s * kMaxLanes + r) * kPitch + tt,
              rowp[r] + (valid ? t0 + tt : 0), valid);
  }
  cp_async_commit();
}

template <int DIV>
__global__ void __launch_bounds__(kThreads)
pll_kernel(Parts parts, const float* __restrict__ consts,
           const float* __restrict__ st_in, float* __restrict__ st_out,
           float* __restrict__ nco_i, float* __restrict__ nco_q, int n_lanes,
           int lanes_per_block, int n, int delay_output) {
  extern __shared__ float smem[];
  float* xs = smem;                                   // (stages, 32, pitch)
  float* sa = smem + kStages * kMaxLanes * kPitch;    // the angles, same
  __shared__ float s_scale[kMaxLanes], s_adjust[kMaxLanes], s_ni0[kMaxLanes],
      s_nq0[kMaxLanes];
  __shared__ const float* s_row[kMaxLanes];

  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * lanes_per_block;
  const int rows = min(lanes_per_block, n_lanes - lane0);
  const int n_tiles = (n + kTile - 1) / kTile;
  const bool walks = tid < rows;       // a walker thread with a lane
  const int lane = lane0 + tid;

  Walk w = {};
  bool fold_lane = false;
  if (walks) {
    const float kp = consts[0 * n_lanes + lane];
    w.ki = consts[1 * n_lanes + lane];
    w.kq = kp + w.ki;
    w.kqlo = -w.kq * kTwoPiLo;
    w.kilo = -w.ki * kTwoPiLo;
    w.dth = consts[2 * n_lanes + lane];
    const float sc = consts[3 * n_lanes + lane];
    s_scale[tid] = sc;
    s_adjust[tid] = consts[4 * n_lanes + lane];
    fold_lane = 2.0f * sc != rintf(2.0f * sc);
    w.integ = st_in[0 * n_lanes + lane];
    w.phase = st_in[1 * n_lanes + lane];
    // entry feedback angle from the carried (cos, sin) pair; the first
    // sample's theta_prev + phase is that angle
    w.a = atan2f(st_in[3 * n_lanes + lane], st_in[2 * n_lanes + lane]);
    w.tp = w.a - w.phase;
    s_ni0[tid] = st_in[4 * n_lanes + lane];
    s_nq0[tid] = st_in[5 * n_lanes + lane];
    w.theta = st_in[6 * n_lanes + lane];
    s_row[tid] = lane_row(parts, lane, n);
  }
  __syncthreads();

  if (tid < 32) {
    // ---- the walker warp
    const bool any_fold = __any_sync(0xffffffffu, fold_lane);
    const bool up = __all_sync(0xffffffffu,
                               !walks || (w.dth >= 0.0f && w.dth < kFourPi));
    if (any_fold) {
      if (up) walker<DIV, true, true>(w, walks, xs, sa, n, n_tiles);
      else walker<DIV, true, false>(w, walks, xs, sa, n, n_tiles);
    } else {
      if (up) walker<DIV, false, true>(w, walks, xs, sa, n, n_tiles);
      else walker<DIV, false, false>(w, walks, xs, sa, n, n_tiles);
    }
    if (walks) {
      float si, co;
      const float phase = mod_exact(w.phase);
      const float a = w.theta + phase;
      st_out[0 * n_lanes + lane] = w.integ;
      st_out[1 * n_lanes + lane] = phase;
      sincosf(a, &si, &co);
      st_out[2 * n_lanes + lane] = co;
      st_out[3 * n_lanes + lane] = si;
      sincosf(fmaf(a, s_scale[tid], s_adjust[tid]), &si, &co);
      st_out[4 * n_lanes + lane] = co;
      st_out[5 * n_lanes + lane] = si;
      st_out[6 * n_lanes + lane] = w.theta;
    }
    return;
  }

  // ---- the helper warps: stage x ahead, synthesise the NCO behind
  const int hid = tid - 32;
  const int ahead = min(kStages, n_tiles);
  for (int i = 0; i < ahead; ++i) stage_x(xs, s_row, rows, n, i, hid);
  cp_async_wait_all();
  for (int i = 0; i < ahead; ++i) bar_arrive(bar_full(i));

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages, t0 = i * kTile;
    const int len = min(kTile, n - t0);
    const bool refill = i + kStages < n_tiles;
    bar_sync(bar_walked(s));
    if (refill) stage_x(xs, s_row, rows, n, i + kStages, hid);
    const float* arow0 = sa + s * kMaxLanes * kPitch;
    const int total = rows * kTile;
    // four samples per thread in flight: independent cos/sin chains
    for (int base = hid; base < total; base += 4 * kHelperThreads) {
      float si[4], co[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int idx = min(base + j * kHelperThreads, total - 1);
        const int r = idx / kTile, tt = idx % kTile;
        const float ang = arow0[r * kPitch + tt + (delay_output ? 0 : 1)];
        __sincosf(reduce_two_pi(fmaf(ang, s_scale[r], s_adjust[r])), &si[j],
                  &co[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int idx = base + j * kHelperThreads;
        const int r = idx / kTile, tt = idx % kTile;
        if (idx >= total || tt >= len) continue;
        const int k = t0 + tt;
        const size_t o = (size_t)(lane0 + r) * n + k;
        const bool carried = delay_output && k == 0;
        nco_i[o] = carried ? s_ni0[r] : co[j];
        nco_q[o] = carried ? s_nq0[r] : si[j];
      }
    }
    if (refill) {
      cp_async_wait_all();
      bar_arrive(bar_full(s));
    }
  }
}

// the current device's SM count, cached per device
int sm_count() {
  static int n_sm[64] = {};
  int device = 0, n = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 132;
  if (device < 64 && n_sm[device]) return n_sm[device];
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    n = 132;
  if (device < 64) n_sm[device] = n;
  return n;
}

template <int DIV>
cudaError_t launch(const Parts& p, const float* consts, const float* st_in,
                   float* st_out, float* nco_i, float* nco_q, int n_lanes,
                   int n, int delay_output, cudaStream_t s) {
  // lanes per block: as few as spread the lanes over every SM, at most 32
  const int n_sm = sm_count();
  const int per = min(kMaxLanes, max(1, (n_lanes + n_sm - 1) / n_sm));
  const int blocks = (n_lanes + per - 1) / per;
  const size_t smem = sizeof(float) * 2 * kStages * kMaxLanes * kPitch;
  // above 48 KB of shared memory: allowed once per kernel and device
  static bool attr[64] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device >= 64 || !attr[device]) {
    e = cudaFuncSetAttribute(pll_kernel<DIV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    if (device < 64) attr[device] = true;
  }
  pll_kernel<DIV><<<blocks, kThreads, smem, s>>>(
      p, consts, st_in, st_out, nco_i, nco_q, n_lanes, per, n, delay_output);
  return cudaGetLastError();
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
      (loop_div != 1 && loop_div != 2 && loop_div != 4 && loop_div != 8))
    return (int)cudaErrorInvalidValue;
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
  using Launch = cudaError_t (*)(const Parts&, const float*, const float*,
                                 float*, float*, float*, int, int, int,
                                 cudaStream_t);
  const Launch fn = loop_div == 1   ? launch<1>
                    : loop_div == 2 ? launch<2>
                    : loop_div == 4 ? launch<4>
                                    : launch<8>;
  return (int)fn(p, consts, st_in, st_out, nco_i, nco_q, n_lanes, n,
                 delay_output, (cudaStream_t)stream);
}
