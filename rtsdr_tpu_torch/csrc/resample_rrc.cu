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
// resample_rrc writes the next zi itself: the zero-stuffed tail of the
// mixed stream, from the last ceil(t1/up) inputs; resample_mix's wrapper
// makes it from the same inputs with stock ops (the same bits).
//
// Replaces the Pallas kernel rtsdr_tpu/ops/pallas_fir.py::
// _resample_mix_rrc_kernel (_mix_resample_core, _rrc_banded; reached from
// resample_mul2_rrc).  That kernel contracts bf16 windows against a
// phase-banded matrix on the matrix unit, rolls the resampler tail in a
// scratch from one grid step to the next (the grid runs in order there) and
// adds both carried states outside through boundary matmuls.  Here all
// arithmetic is float32, both carried states are read in the kernel, and
// since CUDA blocks run in no order the RRC look-back is recomputed as a
// halo: a block that owns outputs [m0, m0+T) also computes the resampler
// outputs before them that the RRC reads (the first tile takes rrc_zi).
//
// Bound on an H100: bytes, barely.  At 1,024 channels of 15,360 samples:
// 2 * 3,648 * (158 + 151) * 2 FLOP = 4.5 MFLOP and 3 * 61 KB in, 29 KB out,
// 25 KB of states = 0.26 MB per channel, i.e. ~0.07 ms by operations and
// ~0.08 ms by bytes.  The first version (one thread per output, both
// branches; tiles of 608 outputs) was limited by shared-memory reads: a tap
// read at stride up and one window read per branch for every two
// multiply-adds, plus a 25 % RRC halo, six blocks at C = 1, the carried
// tail made by stock ops outside.
//
// Design:
//   * By phase.  Outputs m and m + up have the same phase, so the same
//     taps: the taps are staged as up polyphase planes hp_ph[j] = h[ph +
//     up*j], and a thread makes kR = 4 outputs of one phase for both
//     branches, so one broadcast tap read feeds 8 multiply-adds.  The
//     lanes of a warp take outputs of one phase up apart, whose windows lie
//     down samples apart: the mixed window is staged transposed (x index
//     ilo + row*down + col at col*lcap + row, lcap odd), so the lanes read
//     consecutive words, free of bank conflicts, and a warp's walk down the
//     window is uniform (one column back, or to the last column of the row
//     before).  Each window sample still feeds one multiply-add per read:
//     shared-memory bandwidth bounds this stage at about one read per
//     multiply-add.
//   * Each output sums its taps in the plain version's order (j ascending;
//     zeros staged before the block add exact zeros), then the carried zi
//     terms of the first outputs (a warp's strided partial sums and shuffle
//     tree, zi staged in shared memory one branch at a time), then the gain.
//   * The RRC (stride 1, 151 taps) is register-blocked as K2 is: 4
//     consecutive outputs per thread from a sliding 8-sample window, one
//     16-byte read of each branch and one broadcast tap read per 32
//     multiply-adds, taps in the plain version's order.
//   * Tiles by shape: 2,048, 1,024, ... 128 RRC outputs, the widest that
//     still gives two blocks per SM (C = 1: 29 blocks of 128).
//   * The last tile writes both carried states, so a call is one launch.

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
constexpr int kTile = 608;      // resample_mix: widest tile of outputs
constexpr int kMinBlocks = 264; // resample_mix: two blocks per SM of 132
constexpr int kR = 4;           // resample_rrc: outputs of one phase per thread
constexpr int kB = 4;           // resample_rrc: staging loads in flight
constexpr int kSmemTwoBlocks = 113 * 1024;
// resample_rrc's tiles of RRC outputs, widest first
constexpr int kRrcTiles[5] = {2048, 1024, 512, 256, 128};

struct Args {
  const float *e, *ni, *nq, *h, *zi, *g, *rrc_zi;
  float *y, *rrc_zi_out, *zi_out;
  int n_ch, n, m, taps, up, down, rtaps, lane_stride;
  float gain;
  int tile, n_tiles, x_cap, n_slots_cap;
  // resample_rrc's plan: RRC taps padded to a 4-multiple, taps per phase,
  // resampler slots, rows of the transposed window (odd), 16-byte stores
  int q_r, qp, s_cap, lcap, vec_out;
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

// add_carried for one branch b, with the taps read from the phase planes
// (h[k] at hp[(k % up) * qp + k / up]) and the branch's carried zi from
// shared memory: the same lanes, sums and shuffle tree; each lane's four
// tap indices advance by 128 without a division
__device__ __forceinline__ void add_carried_shared(
    const Args& p, const float* hp, const float* z, int m_first, int m_end,
    int slot0, float* sr) {
  const int t1 = p.taps - 1;
  const int nb = (t1 + p.down - 1) / p.down;       // outputs that reach zi
  const int hi = min(m_end, nb);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int adv_j = 128 / p.up, adv_p = 128 % p.up;
  const int st_j = 32 / p.up, st_p = 32 % p.up;
  for (int m = m_first + warp; m < hi; m += kThreads / 32) {
    const int pos = m * p.down;                    // < t1
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    int k = pos + 1 + lane;
    int ph[4], jj[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      ph[r] = (k + 32 * r) % p.up;
      jj[r] = (k + 32 * r) / p.up;
    }
    for (; k + 96 <= t1; k += 128) {
      a0 = fmaf(hp[ph[0] * p.qp + jj[0]], z[pos + t1 - k], a0);
      a1 = fmaf(hp[ph[1] * p.qp + jj[1]], z[pos + t1 - k - 32], a1);
      a2 = fmaf(hp[ph[2] * p.qp + jj[2]], z[pos + t1 - k - 64], a2);
      a3 = fmaf(hp[ph[3] * p.qp + jj[3]], z[pos + t1 - k - 96], a3);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ph[r] += adv_p;
        jj[r] += adv_j;
        if (ph[r] >= p.up) {
          ph[r] -= p.up;
          ++jj[r];
        }
      }
    }
    // the rest, 32 apart: k's phase and index are ph[0], jj[0] here
    int pk = ph[0], jk = jj[0];
    for (; k <= t1; k += 32) {
      a0 = fmaf(hp[pk * p.qp + jk], z[pos + t1 - k], a0);
      pk += st_p;
      jk += st_j;
      if (pk >= p.up) {
        pk -= p.up;
        ++jk;
      }
    }
    float acc = (a0 + a1) + (a2 + a3);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, d);
    if (lane == 0) sr[m - slot0] += acc;
  }
}

// K4: the block owns RRC outputs [m0, m0 + own) and computes the resampler
// outputs from slot0 = m0 - (q_r - 1) on (before the row: the carried RRC
// state); see the note at the top.
__global__ void __launch_bounds__(kThreads, 2) resample_rrc_kernel(Args p) {
  extern __shared__ __align__(16) float smem[];
  float* sgr = smem;                       // reversed RRC taps (q_r)
  float* sri = sgr + p.q_r;                // resampler slots I (s_cap)
  float* srq = sri + p.s_cap;              // resampler slots Q
  float* sxi = srq + p.s_cap;              // mixed I, transposed (down, lcap)
  float* sxq = sxi + p.lcap * p.down;      // mixed Q
  float* shp = sxq + p.lcap * p.down;      // phase taps (up, qp)

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int c = blockIdx.x / p.n_tiles;
  const int tile_idx = blockIdx.x % p.n_tiles;
  const int m0 = tile_idx * p.tile;                // first output owned
  const int own = min(p.tile, p.m - m0);
  const int slot0 = m0 - (p.q_r - 1);              // output index of slot 0
  const int m_first = max(slot0, 0);               // first computed output
  const int m_end = m0 + own;                      // one past the last
  const int t1 = p.taps - 1, t1r = p.rtaps - 1;
  // x index of the window's first sample: every phase's look-back from
  // m_first fits, samples before the block are staged as zeros
  const int ilo = (int)(((long long)m_first * p.down) / p.up) -
                  (t1 + p.up - 1) / p.up;

  // ---- stage: phase taps hp_ph[j] = h[ph + up*j] (0 past t1), reversed
  // RRC taps, the mixed window 2*e*n_b at col*lcap + row for x index
  // ilo + row*down + col (coalesced reads; consecutive elements are
  // written lcap (odd) apart, on distinct banks)
  for (int k = tid; k < p.up * p.qp; k += kThreads) {
    const int kk = k / p.qp + p.up * (k % p.qp);
    shp[k] = kk <= t1 ? p.h[kk] : 0.0f;
  }
  for (int u = tid; u < p.q_r; u += kThreads) {
    const int kk = p.q_r - 1 - u;
    sgr[u] = kk < p.rtaps ? p.g[kk] : 0.0f;
  }
  const size_t xrow = (size_t)c * p.n;
  {
    // element idx = row*down + col of the window, kB loads of each input in
    // flight per thread before any is stored; (row, col) advance by
    // kThreads elements without a division
    const int n_el = p.lcap * p.down;
    const int step_r = kThreads / p.down, step_c = kThreads % p.down;
    int row = tid / p.down, col = tid % p.down;
    for (int idx0 = tid; idx0 < n_el; idx0 += kB * kThreads) {
      float ve[kB], vi[kB], vq[kB];
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        const int i = ilo + idx0 + u * kThreads;
        ve[u] = vi[u] = vq[u] = 0.0f;
        if (idx0 + u * kThreads < n_el && i >= 0 && i < p.n) {
          ve[u] = __ldg(p.e + xrow + i);
          vi[u] = __ldg(p.ni + xrow + i);
          vq[u] = __ldg(p.nq + xrow + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        if (idx0 + u * kThreads >= n_el) break;
        const float e2 = 2.0f * ve[u];
        sxi[col * p.lcap + row] = e2 * vi[u];
        sxq[col * p.lcap + row] = e2 * vq[u];
        row += step_r;
        col += step_c;
        if (col >= p.down) {
          col -= p.down;
          ++row;
        }
      }
    }
  }
  __syncthreads();

  // ---- resampler: unit (pp, qb) makes the outputs
  // m_first + pp + up*(qb + k*q_s), k < kR, all of one phase: one
  // broadcast tap read feeds 2*kR multiply-adds; the units of one phase
  // class pp are consecutive lanes and read consecutive rows (at most 32 /
  // q_w classes share a warp).  Taps j ascending, as the plain version's k
  // ascending.
  const int n_q = (m_end - m_first + p.up - 1) / p.up;
  const int q_s = (n_q + kR - 1) / kR;
  // units per phase: whole warps, or the power of two that holds q_s (a
  // warp then takes 32 / q_w phases)
  int q_w = 1;
  while (q_w < q_s && q_w < 32) q_w *= 2;
  if (q_s > 32) q_w = (q_s + 31) / 32 * 32;
  for (int unit = tid; unit < p.up * q_w; unit += kThreads) {
    const int pp = unit / q_w, qb = unit % q_w;
    if (qb >= q_s) continue;
    const int mb = m_first + pp;                   // output of q = 0
    if (mb + p.up * qb >= m_end) continue;
    const long long pos = (long long)mb * p.down;
    const int i0 = (int)(pos / p.up);
    const int ph = (int)(pos - (long long)i0 * p.up);
    const int nj = ph <= t1 ? (t1 - ph) / p.up + 1 : 0;
    int col = (i0 - ilo) % p.down;
    int a = col * p.lcap + (i0 - ilo) / p.down + qb;
    int off[kR];
    bool ok[kR];
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      ok[k] = mb + p.up * (qb + k * q_s) < m_end;
      off[k] = ok[k] ? k * q_s : 0;    // past the tile: read row qb, unused
    }
    const float* hp = shp + ph * p.qp;
    float ai[kR], aq[kR];
#pragma unroll
    for (int k = 0; k < kR; ++k) ai[k] = aq[k] = 0.0f;
#pragma unroll 2
    for (int j = 0; j < nj; ++j) {
      const float t = hp[j];
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        ai[k] = fmaf(t, sxi[a + off[k]], ai[k]);
        aq[k] = fmaf(t, sxq[a + off[k]], aq[k]);
      }
      // x index one lower: the column before, or the last of the row before
      const bool wrap = col == 0;
      col = wrap ? p.down - 1 : col - 1;
      a += wrap ? (p.down - 1) * p.lcap - 1 : -p.lcap;
    }
#pragma unroll
    for (int k = 0; k < kR; ++k)
      if (ok[k]) {
        const int s = mb + p.up * (qb + k * q_s) - slot0;
        sri[s] = ai[k];
        srq[s] = aq[k];
      }
  }
  // the first tile's look-back is the carried RRC state
  const size_t rrow = (size_t)c * 2 * t1r;
  for (int s = tid; s < m_first - slot0; s += kThreads) {
    const int mm = slot0 + s;
    sri[s] = mm >= -t1r ? p.rrc_zi[rrow + t1r + mm] : 0.0f;
    srq[s] = mm >= -t1r ? p.rrc_zi[rrow + t1r + t1r + mm] : 0.0f;
  }
  __syncthreads();
  // the carried resampler state of the first outputs, one branch at a
  // time: its zi staged where the (dead) mixed window was
  if ((long long)m_first * p.down < t1) {
    const size_t zrow = (size_t)c * 2 * t1;
    for (int b = 0; b < 2; ++b) {
      for (int k = tid; k < t1; k += kThreads)
        sxi[k] = __ldg(p.zi + zrow + (size_t)b * t1 + k);
      __syncthreads();
      add_carried_shared(p, shp, sxi, m_first, m_end, slot0, b ? srq : sri);
      __syncthreads();
    }
  }
  for (int s = tid + (m_first - slot0); s < m_end - slot0; s += kThreads) {
    sri[s] *= p.gain;
    srq[s] *= p.gain;
  }
  __syncthreads();

  // ---- the last tile writes the carried states: the row's last t1r
  // resampler outputs, and the zero-stuffed tail of the mixed stream
  // (position n*up - t1 + j holds (2e) * n_b at its index / up where up
  // divides it, else +0)
  if (tile_idx == p.n_tiles - 1) {
    for (int j = tid; j < t1r; j += kThreads) {
      const int s = (p.m - t1r + j) - slot0;       // >= 0: m >= t1r checked
      p.rrc_zi_out[rrow + j] = sri[s];
      p.rrc_zi_out[rrow + t1r + j] = srq[s];
    }
    const size_t zrow = (size_t)c * 2 * t1;
    const int tail0 = p.n * p.up - t1;      // n*up < 2^31: checked
    for (int j = tid; j < t1; j += kThreads) {
      const int q = tail0 + j;
      float vi = 0.0f, vq = 0.0f;
      if (q % p.up == 0) {
        const size_t i = xrow + q / p.up;
        const float e2 = 2.0f * p.e[i];
        vi = e2 * p.ni[i];
        vq = e2 * p.nq[i];
      }
      p.zi_out[zrow + j] = vi;
      p.zi_out[zrow + t1 + j] = vq;
    }
  }

  // ---- RRC over the slots: outputs m0 + o .. + 3 of a thread,
  // y[m0 + o + r] = sum_u gr[u] * slot[o + r + u], u descending (the plain
  // version's k ascending) through a sliding register window
  const size_t yrow = (size_t)c * 2 * p.m;
  for (int o = 4 * tid; o < own; o += 4 * kThreads) {
    const float* x[2] = {sri + o, srq + o};
    float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    float4 hi[2];
#pragma unroll
    for (int b = 0; b < 2; ++b)
      hi[b] = *reinterpret_cast<const float4*>(x[b] + p.q_r);
#pragma unroll 2
    for (int u0 = p.q_r - 4; u0 >= 0; u0 -= 4) {
      const float4 t = *reinterpret_cast<const float4*>(sgr + u0);
      const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const float4 lo = *reinterpret_cast<const float4*>(x[b] + u0);
        const float w[8] = {lo.x,    lo.y,    lo.z,    lo.w,
                            hi[b].x, hi[b].y, hi[b].z, hi[b].w};
#pragma unroll
        for (int qq = 3; qq >= 0; --qq)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[b][r] = fmaf(tv[qq], w[qq + r], acc[b][r]);
        hi[b] = lo;
      }
    }
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      float* y = p.y + yrow + (size_t)b * p.m + m0 + o;
      if (p.vec_out && o + 4 <= own) {
        *reinterpret_cast<float4*>(y) =
            make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
      } else {
        for (int r = 0; r < 4 && o + r < own; ++r) y[r] = acc[b][r];
      }
    }
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


// The plan of a resample_rrc block that owns `tile` RRC outputs; returns
// its dynamic shared memory in bytes.
size_t rrc_plan(Args& p, int tile) {
  const int t1 = p.taps - 1;
  p.tile = tile;
  p.n_tiles = (p.m + tile - 1) / tile;
  p.q_r = (p.rtaps + 3) / 4 * 4;
  p.qp = t1 / p.up + 1;
  p.s_cap = tile + p.q_r + 4;
  const long long span = ((long long)(p.s_cap - 1) * p.down) / p.up + 2 +
                         (t1 + p.up - 1) / p.up;
  p.lcap = (int)(span / p.down) + 2;
  // the window's memory also holds one branch of the carried zi
  p.lcap = max(p.lcap, (t1 + 2 * p.down - 1) / (2 * p.down));
  p.lcap += 1 - p.lcap % 2;
  return sizeof(float) * (2 * (size_t)p.lcap * p.down +
                          (size_t)p.up * p.qp + 2 * (size_t)p.s_cap + p.q_r);
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

}  // namespace

// e, ni, nq: (C, n); h: (taps,); zi, zi_out: (C, 2, taps-1); g: (rtaps,);
// rrc_zi, rrc_zi_out: (C, 2, rtaps-1); y: (C, 2, m), m = n*up/down.  All
// float32.  Needs n*up % down == 0, n*up >= taps-1 and m >= rtaps-1.
// Returns cudaGetLastError().
extern "C" int rtsdr_resample_rrc(const float* e, const float* ni,
                                  const float* nq, const float* h,
                                  const float* zi, const float* g,
                                  const float* rrc_zi, float* y,
                                  float* rrc_zi_out, float* zi_out, int n_ch,
                                  int n, int m, int taps, int up, int down,
                                  int rtaps, float gain, void* stream) {
  if (n_ch <= 0 || n <= 0 || taps < 1 || rtaps < 1 || up < 1 || down < 1 ||
      (long long)n * up != (long long)m * down ||
      (long long)n * up < taps - 1 || m < rtaps - 1 ||
      (long long)n * up >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Args p = {};
  p.e = e; p.ni = ni; p.nq = nq; p.h = h; p.zi = zi; p.g = g;
  p.rrc_zi = rrc_zi; p.y = y; p.rrc_zi_out = rrc_zi_out; p.zi_out = zi_out;
  p.n_ch = n_ch; p.n = n; p.m = m; p.taps = taps; p.up = up; p.down = down;
  p.rtaps = rtaps; p.gain = gain;
  // the widest tile that still gives two blocks per SM within the shared
  // memory of two blocks per SM, else the narrowest
  const long long want = 2LL * sm_count();
  int pick = 4;
  for (int i = 0; i < 5; ++i) {
    const size_t smem_i = rrc_plan(p, kRrcTiles[i]);
    if ((long long)n_ch * p.n_tiles >= want && smem_i <= kSmemTwoBlocks) {
      pick = i;
      break;
    }
  }
  const size_t smem = rrc_plan(p, kRrcTiles[pick]);
  p.vec_out = m % 4 == 0 && ((uintptr_t)y & 15) == 0;
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
