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
// Both kernels write the next zi themselves: the zero-stuffed tail of the
// mixed stream, from the last ceil(t1/up) inputs (the bits of the stock-op
// tail, ops/cuda_resample.py::resample_mul2_tail).
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
// Here all arithmetic is float32 and the block is K4's without the RRC
// stage: the taps as up phase planes, kR outputs of one phase per unit, the
// mixed window staged transposed, the carried zi staged in shared memory
// (its taps read linearly from device memory: no phase-plane index
// arithmetic per tap), the next zi written by the last tile; no unit idle
// (K4 pads a phase's units to a power of two).  K4 keeps its own body:
// through these shared helpers it ran 17 % slower at the wideband shape
// (tools/torch_profile_kernels.py --only K4, PERF.md).  Tiles by shape:
// equal tiles of at most 1,024 outputs, as few as give two blocks per SM
// with every unit in one pass of the block (a one-station time-sharded
// step has T rows).  The segmented form (n_seg = T; rows are (segment,
// channel)): a row of segment s > 0 reads its left neighbour's last
// ceil(t1/up) inputs (extract, both NCOs) in place and mixes them in its
// window, so no zero-stuffed zi is built, shifted or read for it; segment
// 0's rows read the carried zi, and only the last segment's rows
// write the next one.  Bound on an H100: bytes.  At 4 x 1,024 stacked rows
// of 3,840 (x19/80): 3 x 63 MB in, 30 MB out, 2 x 25 MB of carried zi
// (0.27 GB, 0.080 ms) against 2 * 3.7 M * 158 * 2 FLOP (2.4 GFLOP, 0.035
// ms).  Two arms ask the TPU probe's layout question of this card
// (tools/profile_resample.py, B7' there): `pair`, a unit makes kR outputs of
// both branches from one tap read, and `split`, a unit makes 2 kR outputs of
// one branch (as many multiply-adds per tap read, other rows of the
// window); tools/torch_profile_resample.py times both.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kR = 4;           // outputs of one phase per unit
constexpr int kB = 4;           // resample_rrc: staging loads in flight
constexpr int kMixB = 8;        // resample_mix: staging loads in flight
constexpr int kSmemTwoBlocks = 113 * 1024;
// resample_rrc's tiles of RRC outputs, widest first
constexpr int kRrcTiles[5] = {2048, 1024, 512, 256, 128};
// resample_mix's widest tile of outputs
constexpr int kMixTileMax = 1024;

struct Args {
  const float *e, *ni, *nq, *h, *zi, *g, *rrc_zi;
  float *y, *rrc_zi_out, *zi_out;
  int n_ch, n, m, taps, up, down, rtaps;
  float gain;
  int tile, n_tiles;
  // resample_rrc's plan: RRC taps padded to a 4-multiple, resampler slots
  int q_r, s_cap;
  // taps per phase, rows of the transposed window (odd), 16-byte stores
  int qp, lcap, vec_out;
  // resample_mix's segments (rows are (segment, channel); 1: no segments)
  int n_seg;
};

// Phase taps hp_ph[j] = h[ph + up*j] (0 past t1) at shp[ph * qp + j].
__device__ __forceinline__ void stage_phase_taps(const Args& p, float* shp) {
  const int t1 = p.taps - 1;
  for (int k = threadIdx.x; k < p.up * p.qp; k += kThreads) {
    const int kk = k / p.qp + p.up * (k % p.qp);
    shp[k] = kk <= t1 ? p.h[kk] : 0.0f;
  }
}

// The mixed window 2*e*n_b of the row at xrow, x index ilo + row*down + col
// at col*lcap + row (coalesced reads; consecutive elements are written lcap
// (odd) apart, on distinct banks), kMixB loads of each input in flight per
// thread before any is stored; (row, col) advance by kThreads elements
// without a division.  x < 0 reads the row at prow (a segment's left
// neighbour) at x + n, or zeros when prow < 0.
__device__ __forceinline__ void stage_window(const Args& p, size_t xrow,
                                             long long prow, int ilo,
                                             float* sxi, float* sxq) {
  const int tid = threadIdx.x;
  const int n_el = p.lcap * p.down;
  const int step_r = kThreads / p.down, step_c = kThreads % p.down;
  int row = tid / p.down, col = tid % p.down;
  for (int idx0 = tid; idx0 < n_el; idx0 += kMixB * kThreads) {
    float ve[kMixB], vi[kMixB], vq[kMixB];
#pragma unroll
    for (int u = 0; u < kMixB; ++u) {
      const int i = ilo + idx0 + u * kThreads;
      ve[u] = vi[u] = vq[u] = 0.0f;
      if (idx0 + u * kThreads < n_el && i < p.n) {
        const long long at = i >= 0 ? (long long)xrow + i
                                    : (prow >= 0 ? prow + p.n + i : -1);
        if (at >= 0) {
          ve[u] = __ldg(p.e + at);
          vi[u] = __ldg(p.ni + at);
          vq[u] = __ldg(p.nq + at);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kMixB; ++u) {
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

// The resampler over the staged window: unit (pp, qb) makes the outputs
// m_first + pp + up*(qb + k*q_s), k < NO, all of one phase, into slots
// (m - slot0): kPair, NO = kR outputs of both branches, so one broadcast
// tap read feeds 2*kR multiply-adds; else NO = 2*kR outputs of one branch
// (the branch outermost), the same multiply-adds per tap read.  The q_s
// units of one phase class pp are consecutive lanes and read consecutive
// rows; none is idle (K4 pads a phase's units to a power of two).  Taps j
// ascending, as the plain version's k ascending; samples before the
// window's data are staged zeros.
template <bool kPair>
__device__ __forceinline__ void resample_units(
    const Args& p, const float* shp, const float* sxi, const float* sxq,
    int ilo, int m_first, int m_end, int slot0, float* sri, float* srq) {
  constexpr int NO = kPair ? kR : 2 * kR;
  const int t1 = p.taps - 1;
  const int n_q = (m_end - m_first + p.up - 1) / p.up;
  const int q_s = (n_q + NO - 1) / NO;
  const int q_w = q_s;
  const int per_branch = p.up * q_w;
  for (int unit = threadIdx.x; unit < (kPair ? 1 : 2) * per_branch;
       unit += kThreads) {
    const int br = kPair ? 0 : unit / per_branch;
    const int uu = unit - br * per_branch;
    const int pp = uu / q_w, qb = uu % q_w;
    if (qb >= q_s) continue;
    const int mb = m_first + pp;                   // output of q = 0
    if (mb + p.up * qb >= m_end) continue;
    const long long pos = (long long)mb * p.down;
    const int i0 = (int)(pos / p.up);
    const int ph = (int)(pos - (long long)i0 * p.up);
    const int nj = ph <= t1 ? (t1 - ph) / p.up + 1 : 0;
    int col = (i0 - ilo) % p.down;
    int a = col * p.lcap + (i0 - ilo) / p.down + qb;
    int off[NO];
    bool ok[NO];
#pragma unroll
    for (int k = 0; k < NO; ++k) {
      ok[k] = mb + p.up * (qb + k * q_s) < m_end;
      off[k] = ok[k] ? k * q_s : 0;    // past the tile: read row qb, unused
    }
    const float* hp = shp + ph * p.qp;
    const float* sx = br ? sxq : sxi;
    float ai[NO], aq[NO];
#pragma unroll
    for (int k = 0; k < NO; ++k) ai[k] = aq[k] = 0.0f;
#pragma unroll 2
    for (int j = 0; j < nj; ++j) {
      const float t = hp[j];
#pragma unroll
      for (int k = 0; k < NO; ++k) {
        if (kPair) {
          ai[k] = fmaf(t, sxi[a + off[k]], ai[k]);
          aq[k] = fmaf(t, sxq[a + off[k]], aq[k]);
        } else {
          ai[k] = fmaf(t, sx[a + off[k]], ai[k]);
        }
      }
      // x index one lower: the column before, or the last of the row before
      const bool wrap = col == 0;
      col = wrap ? p.down - 1 : col - 1;
      a += wrap ? (p.down - 1) * p.lcap - 1 : -p.lcap;
    }
#pragma unroll
    for (int k = 0; k < NO; ++k)
      if (ok[k]) {
        const int s = mb + p.up * (qb + k * q_s) - slot0;
        if (kPair) {
          sri[s] = ai[k];
          srq[s] = aq[k];
        } else {
          (br ? srq : sri)[s] = ai[k];
        }
      }
  }
}

// The carried resampler state of one branch b: outputs with m*down < t1
// also read zi (arbitrary floats).  One warp per output: lanes stride over
// the dense taps (read from the phase planes, h[k] at hp[(k % up) * qp +
// k / up]) against the branch's zi staged in shared memory, four
// independent sums per lane (each lane's four tap indices advance by 128
// without a division), then a shuffle tree.
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

// add_carried_shared with the taps read as h[k] from device memory (the
// lanes' taps are consecutive: coalesced, and L1 keeps them): the same lanes,
// sums and shuffle tree, so the same bits, without the phase-plane index
// arithmetic per tap (K6's).
__device__ __forceinline__ void add_carried_linear(
    const Args& p, const float* z, int m_first, int m_end, int slot0,
    float* sr) {
  const int t1 = p.taps - 1;
  const int nb = (t1 + p.down - 1) / p.down;       // outputs that reach zi
  const int hi = min(m_end, nb);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int m = m_first + warp; m < hi; m += kThreads / 32) {
    const int pos = m * p.down;                    // < t1
    const float* zk = z + pos + t1;                // zk[-k] = z[pos + t1 - k]
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    int k = pos + 1 + lane;
    for (; k + 96 <= t1; k += 128) {
      a0 = fmaf(__ldg(p.h + k), zk[-k], a0);
      a1 = fmaf(__ldg(p.h + k + 32), zk[-k - 32], a1);
      a2 = fmaf(__ldg(p.h + k + 64), zk[-k - 64], a2);
      a3 = fmaf(__ldg(p.h + k + 96), zk[-k - 96], a3);
    }
    for (; k <= t1; k += 32) a0 = fmaf(__ldg(p.h + k), zk[-k], a0);
    float acc = (a0 + a1) + (a2 + a3);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, d);
    if (lane == 0) sr[m - slot0] += acc;
  }
}

// The carried resampler state of the block's first outputs (those with
// m*down < t1), one branch at a time: zi row zrow staged in the dead window
// memory.  Ends with all threads past the last barrier.
__device__ __forceinline__ void add_carried_rows(const Args& p, size_t zrow,
                                                 float* sxi, int m_first,
                                                 int m_end, int slot0,
                                                 float* sri, float* srq) {
  const int t1 = p.taps - 1;
  for (int b = 0; b < 2; ++b) {
    for (int k = threadIdx.x; k < t1; k += kThreads)
      sxi[k] = __ldg(p.zi + zrow + (size_t)b * t1 + k);
    __syncthreads();
    add_carried_linear(p, sxi, m_first, m_end, slot0, b ? srq : sri);
    __syncthreads();
  }
}

// The zero-stuffed tail of the row's mixed stream: position n*up - t1 + j
// holds (2e) * n_b at its index / up where up divides it, else +0.
__device__ __forceinline__ void write_mixed_tail(const Args& p, size_t xrow,
                                                 float* out) {
  const int t1 = p.taps - 1;
  const int tail0 = p.n * p.up - t1;      // n*up < 2^31: checked
  for (int j = threadIdx.x; j < t1; j += kThreads) {
    const int q = tail0 + j;
    float vi = 0.0f, vq = 0.0f;
    if (q % p.up == 0) {
      const size_t i = xrow + q / p.up;
      const float e2 = 2.0f * p.e[i];
      vi = e2 * p.ni[i];
      vq = e2 * p.nq[i];
    }
    out[j] = vi;
    out[t1 + j] = vq;
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

// K6: the block owns resampler outputs [m0, m0 + own) of stacked row
// (segment, channel); see the note at the top.
template <bool kPair>
__global__ void __launch_bounds__(kThreads, 2) resample_mix_kernel(Args p) {
  extern __shared__ __align__(16) float smem[];
  float* sri = smem;                       // outputs I of the tile
  float* srq = sri + p.tile;               // outputs Q
  float* sxi = srq + p.tile;               // mixed I, transposed (down, lcap)
  float* sxq = sxi + p.lcap * p.down;      // mixed Q
  float* shp = sxq + p.lcap * p.down;      // phase taps (up, qp)

  const int tid = threadIdx.x;
  const int row = blockIdx.x / p.n_tiles;
  const int tile_idx = blockIdx.x % p.n_tiles;
  const int rows_per_seg = p.n_ch / p.n_seg;
  const int seg = row / rows_per_seg, c = row % rows_per_seg;
  const int m0 = tile_idx * p.tile;
  const int m_end = m0 + min(p.tile, p.m - m0);
  const int t1 = p.taps - 1;
  const int ilo = (int)(((long long)m0 * p.down) / p.up) -
                  (t1 + p.up - 1) / p.up;

  stage_phase_taps(p, shp);
  const size_t xrow = (size_t)row * p.n;
  // a segment after the first reads its left neighbour's inputs in place
  stage_window(p, xrow,
               seg > 0 ? (long long)(row - rows_per_seg) * p.n : -1, ilo,
               sxi, sxq);
  __syncthreads();
  resample_units<kPair>(p, shp, sxi, sxq, ilo, m0, m_end, m0, sri, srq);
  __syncthreads();
  if (seg == 0 && (long long)m0 * p.down < t1)
    add_carried_rows(p, (size_t)c * 2 * t1, sxi, m0, m_end, m0, sri, srq);
  const size_t yrow = (size_t)row * 2 * p.m + m0;
  for (int o = tid; o < m_end - m0; o += kThreads) {
    p.y[yrow + o] = sri[o] * p.gain;
    p.y[yrow + p.m + o] = srq[o] * p.gain;
  }
  if (seg == p.n_seg - 1 && tile_idx == p.n_tiles - 1)
    write_mixed_tail(p, xrow, p.zi_out + (size_t)c * 2 * t1);
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The window rows (odd) for a block whose outputs span `span` x samples,
// at least half a carried zi branch (the window's memory also holds one).
int window_rows(const Args& p, long long span) {
  int lcap = (int)(span / p.down) + 2;
  lcap = max(lcap, (p.taps - 1 + 2 * p.down - 1) / (2 * p.down));
  return lcap + 1 - lcap % 2;
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
  p.lcap = window_rows(p, ((long long)(p.s_cap - 1) * p.down) / p.up + 2 +
                              (t1 + p.up - 1) / p.up);
  return sizeof(float) * (2 * (size_t)p.lcap * p.down +
                          (size_t)p.up * p.qp + 2 * (size_t)p.s_cap + p.q_r);
}

// The plan of a resample_mix block that owns `tile` outputs; returns its
// dynamic shared memory in bytes.
size_t mix_plan(Args& p, int tile) {
  const int t1 = p.taps - 1;
  p.tile = tile;
  p.n_tiles = (p.m + tile - 1) / tile;
  p.qp = t1 / p.up + 1;
  p.lcap = window_rows(p, ((long long)(tile - 1) * p.down) / p.up + 2 +
                              (t1 + p.up - 1) / p.up);
  return sizeof(float) * (2 * (size_t)p.lcap * p.down +
                          (size_t)p.up * p.qp + 2 * (size_t)tile);
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

// e, ni, nq: (R, n) rows, R = n_seg * C (segment-major when n_seg > 1);
// h: (taps,); zi, zi_out: (C, 2, taps-1); y: (R, 2, m), m = n*up/down.  All
// float32.  Rows of segment s > 0 read segment s-1's row of the same channel
// as their left halo, segment 0's rows read zi; zi_out is the last
// segment's tail.  Needs n*up % down == 0 and n*up >= taps-1 (so a row
// holds the ceil((taps-1)/up) inputs its right neighbour reads).  split != 0
// launches the one-branch-per-unit instance.  Returns cudaGetLastError().
extern "C" int rtsdr_resample_mix(const float* e, const float* ni,
                                  const float* nq, const float* h,
                                  const float* zi, float* y, float* zi_out,
                                  int n_rows, int n_seg, int n, int m,
                                  int taps, int up, int down, int split,
                                  float gain, void* stream) {
  if (n_rows <= 0 || n_seg < 1 || n_rows % n_seg != 0 || n <= 0 ||
      taps < 1 || up < 1 || down < 1 ||
      (long long)n * up != (long long)m * down ||
      (long long)n * up < taps - 1 || (long long)n * up >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Args p = {};
  p.e = e; p.ni = ni; p.nq = nq; p.h = h; p.zi = zi; p.y = y;
  p.zi_out = zi_out;
  p.n_ch = n_rows; p.n_seg = n_seg; p.n = n; p.m = m; p.taps = taps;
  p.up = up; p.down = down; p.gain = gain;
  // tiles of equal width, as few as give two blocks per SM with every unit
  // of a tile in one pass of the block and the shared memory of two blocks
  // per SM; at least 8 outputs
  const long long want = 2LL * sm_count();
  const int n_out = split ? 2 * kR : kR;
  int n_t = (m + kMixTileMax - 1) / kMixTileMax;
  size_t smem = 0;
  for (;; ++n_t) {
    const int tile = (m + n_t - 1) / n_t;
    smem = mix_plan(p, tile);
    const int n_q = (tile + up - 1) / up;
    const long long units =
        (split ? 2LL : 1LL) * up * ((n_q + n_out - 1) / n_out);
    if ((units <= kThreads && smem <= kSmemTwoBlocks &&
         (long long)n_rows * p.n_tiles >= want) ||
        tile <= 8 || n_t >= m)
      break;
  }
  const void* kernel = split ? (const void*)resample_mix_kernel<false>
                             : (const void*)resample_mix_kernel<true>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(n_rows * p.n_tiles);
  if (split)
    resample_mix_kernel<false><<<blocks, kThreads, smem,
                                 (cudaStream_t)stream>>>(p);
  else
    resample_mix_kernel<true><<<blocks, kThreads, smem,
                                (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
