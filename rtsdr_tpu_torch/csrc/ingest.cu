// Fused ingest: raw interleaved uint8 I/Q -> RF low-pass + decimate ->
// FM discriminator -> audio low-pass + decimate (-> IF band-pass bank), one
// kernel, four entry points over one device routine:
//
//   iq        raw (C, 2N) u8 -> I, Q (C, N/decim):   (b-128)/128 folded in,
//             y[m] = sum_k h[k] * xext[m*decim + taps-1-k], xext = [zi | x]
//   fm        iq + fm[m] = atan2(q*ip - i*qp, i*ip + q*qp) with the sample
//             before the block taken from (prev_i, prev_q)
//   fm_audio  fm + audio[a] = sum_k ah[k] * fmext[a*down + ataps-1-k],
//             fmext = [audio_zi | fm]; fm itself is written only when asked
//   fm_audio_bank  fm_audio + F stride-1 band-passes over the same fm:
//             bank[f][m] = sum_k bh[f][k] * bext[m + btaps-1-k],
//             bext = [bank_zi | fm], btaps <= ataps
// New state: zi_i / zi_q = last taps-1 normalised I / Q, prev = last IF
// sample, audio_zi = last ataps-1 fm samples.
//
// The iq entry also cuts each raw row into n_seg equal segments, each its
// own output row (segment-major: (n_seg, C, ...); the time-sharded
// receiver's form).  A segment's window reads the bytes before it in the
// same raw row in place, where the first segment reads the zero level
// (128); zi still adds to every segment.
//
// Replaces the Pallas kernels of rtsdr_tpu/ops/ingestfir.py:
// _ingest_kernel (via _pallas_ingest), _ingest_demod_kernel /
// _ingest_demod_core (via _pallas_ingest_demod) and
// _ingest_demod_audio_kernel (via _pallas_ingest_demod_audio, with its
// n_bank epilogue as the fourth entry).  Those contract byte windows
// against banded two-level int8 tap matrices on the matrix unit, carry a
// rolling fm scratch from one grid step to the next and use a polynomial
// atan2; here the taps are float32, the angle is atan2f, and since CUDA
// blocks run in no order the look-back of the audio stage is recomputed as
// a halo: a block that owns IF outputs [t0, t0+T) also computes the IF
// samples the audio planes reach back to.
//
// Bound on an H100: operations.  At 1,024 channels of 307,200 bytes the RF
// stage is 2 * 2 * 151 FLOP for each of 15.7 M IF samples (9.5 GFLOP) plus
// 0.95 GFLOP of audio taps, against 315 MB read and ~75 MB written: ~27
// FLOP per byte, above the ~20 where the float32 CUDA-core rate (67 TFLOP/s)
// meets the memory rate (3.35 TB/s).  The first version spent about four
// instructions per multiply-add (a 16-bit shared read and two byte-to-float
// conversions per tap and IF output, two shared reads per audio tap) and
// recomputed a 25 % halo.
//
// Design:
//   * Polyphase register blocking.  The tile's raw window is read in
//     16-byte chunks (held in registers) and scattered straight into its
//     decim polyphase planes of I and of Q, each byte converted once (an
//     exact bit trick and one FMA), the carried zi added where the window
//     reaches before the block: plane_phi[s] = x[decim*(mlo - q_pad + 1 +
//     s) - phi].  The taps become decim reversed phase filters of q_pad =
//     16 taps (zero padded).  A thread makes 4 consecutive IF outputs: per
//     4 taps of a phase, one 16-byte read of I, one of Q and one broadcast
//     16-byte tap read feed 32 FMAs through a sliding 8-sample register
//     window; a warp's reads are 512 contiguous bytes.
//   * The audio stage is the same sum at stride down: the discriminator
//     writes each fm sample to its audio polyphase plane; one work item per
//     (phase, 4 outputs) sums a phase, and each output then adds its phase
//     sums (all threads take part, not one in five).
//   * Summation order: phi ascending, then the taps of a phase; each output
//     sum is reordered against the plain version's k ascending (its error
//     is a few 1e-7, rehearsed index for index in
//     tests/test_torch_cuda_ingest.py).
//   * Launch geometry by shape: blocks of 256, 128, 64 or 32 threads
//     (1,024 down to 128 IF slots), the widest that still gives two blocks
//     per SM: at C >= 1,024 a tile owns 860 IF outputs behind a 160-slot
//     audio halo; at C = 1 the narrowest block that holds a tile.  Once the
//     RF stage has read the planes, their memory holds the slots and audio
//     planes.
//   * The receivers' shapes (RF decim 10, 151 taps; audio down 5, 151 taps)
//     have an instance of their own with those counts compiled in.
//
// The bank stage reads the contiguous fm slots: its look-back of btaps-1
// <= ataps-1 samples lies inside the halo already computed, so the
// demodulated stream reaches the pilot / stereo / RDS band-passes without a
// trip through device memory.  It adds 2 * F * btaps FLOP per IF sample and
// sums its taps in the plain version's order, one shared read of fm per F
// multiply-adds.  The first btaps-1 outputs of a row take their look-back
// from bank_zi in device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxBank = 3;                   // band-passes in the bank stage
constexpr int kSmemTwoBlocks = 113 * 1024;    // two blocks per SM
constexpr int kB = 8;                         // staging loads in flight

// modes from kFmAudio on run the audio stage
enum Mode { kIq = 0, kFm = 1, kFmAudio = 2, kFmAudioBank = 3 };

struct Args {
  const uint8_t* raw;
  const float *rf_h, *zi_i, *zi_q, *prev_i, *prev_q, *audio_h, *audio_zi;
  const float *bank_h, *bank_zi;       // (n_bank, btaps), (C, btaps-1)
  float *out_i, *out_q, *fm, *audio;
  float* bank;                         // (n_bank, C, m_if)
  float *zi_i_out, *zi_q_out, *prev_i_out, *prev_q_out, *audio_zi_out;
  int n_ch, n_pairs, taps, decim, ataps, down, n_bank, btaps;
  int n_seg;             // segments per raw row (iq entry), else 1
  // the plan (set by launch)
  int m_if, n_audio;     // IF samples / audio samples per block
  int q_pad, aq_pad;     // taps per RF / audio phase filter (4-multiples)
  int halo, tile, n_tiles, slots;
  int ps, aps;           // floats per RF plane / audio plane
  int vec_out;           // outputs may be stored 16 bytes at a time
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// (b - 128) / 128 of the byte in bits 0-7 of w, exactly: 0x4B0000bb is the
// float 2^23 + b, and (2^23 + b) / 128 - 65537 is representable
__device__ __forceinline__ float normed(unsigned w) {
  return fmaf(__uint_as_float(0x4B000000u | (w & 0xffu)), 0.0078125f,
              -65537.0f);
}

// acc[r] += sum_u g[u] * x[u + r], r = 0..3, u ascending, one fused
// multiply-add each: x a 16-byte aligned plane read through a sliding
// 8-sample register window, g the (4-multiple) q taps; X = 2 does two
// planes (I and Q) with one tap read
template <int X>
__device__ __forceinline__ void plane_fir(const float* const* x,
                                          const float* g, int q,
                                          float (*acc)[4]) {
  float4 lo[X];
#pragma unroll
  for (int b = 0; b < X; ++b) lo[b] = *reinterpret_cast<const float4*>(x[b]);
#pragma unroll 2
  for (int u0 = 0; u0 < q; u0 += 4) {
    const float4 t = *reinterpret_cast<const float4*>(g + u0);
    const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int b = 0; b < X; ++b) {
      const float4 hi = *reinterpret_cast<const float4*>(x[b] + u0 + 4);
      const float w[8] = {lo[b].x, lo[b].y, lo[b].z, lo[b].w,
                          hi.x,    hi.y,    hi.z,    hi.w};
#pragma unroll
      for (int uu = 0; uu < 4; ++uu)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[b][r] = fmaf(tv[uu], w[uu + r], acc[b][r]);
      lo[b] = hi;
    }
  }
}

// (b - 128) / 128 of the pair e (0..7) of a 16-byte chunk: I in bits
// 0-7 and Q in bits 8-15 of the returned word
__device__ __forceinline__ unsigned pair_of(const uint4& v, int e) {
  const unsigned w = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
  return (e & 1) ? w >> 16 : w;
}

// the 16 segment bytes [gb, gb + 16) at a row's edge: the zero level (128)
// outside [lo, row_bytes)
__device__ __forceinline__ uint4 edge_chunk(const uint8_t* row, int gb,
                                            int lo, int row_bytes) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    unsigned x = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int g = gb + 4 * k + b;
      const unsigned byte = (g >= lo && g < row_bytes) ? row[g] : 128u;
      x |= byte << (8 * b);
    }
    w[k] = x;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One tile: row c, its IF outputs [t0, t0 + own), its raw window
struct Tile {
  int c, tile_idx, t0, mlo, own;
  const uint8_t* row;    // the segment's first byte
  int lo;                // first byte of the raw row, relative to the segment
  int i_lo, b0a, n_chunks;
};

template <int D, int QP>
__device__ __forceinline__ Tile tile_of(const Args& p, int g) {
  const int DEC = D ? D : p.decim, QPD = QP ? QP : p.q_pad;
  Tile t;
  t.c = g / p.n_tiles;
  t.tile_idx = g % p.n_tiles;
  t.t0 = t.tile_idx * p.tile;
  t.mlo = t.t0 - p.halo;
  t.own = min(p.tile, p.m_if - t.t0);
  const int row_bytes = 2 * p.n_pairs;
  // output row c is segment `seg` of raw row c % n_src; the raw row's bytes
  // before the segment are real (lo <= 0 of them)
  const int n_src = p.n_ch / p.n_seg;
  const int seg = t.c / n_src;
  t.lo = -seg * row_bytes;
  t.row = p.raw + ((size_t)(t.c % n_src) * p.n_seg + seg) * row_bytes;
  // the window: pairs [i_lo, i_lo + decim*ps) of the segment, in 16-byte
  // chunks aligned in global memory from byte b0a <= 2*i_lo on
  t.i_lo = DEC * (t.mlo - QPD + 1) - (DEC - 1);
  const int b0 = 2 * t.i_lo;
  const int shift = (int)((reinterpret_cast<intptr_t>(t.row) + b0) & 15);
  t.b0a = b0 - shift;                               // even: whole pairs
  t.n_chunks = (2 * DEC * p.ps + shift + 15) >> 4;
  return t;
}

// chunks q0 + u*nt (u < kB) of the window into registers, all of them in
// flight at once
__device__ __forceinline__ void load_window(const Args& p, const Tile& t,
                                            int q0, uint4 (&v)[kB]) {
  const int row_bytes = 2 * p.n_pairs;
#pragma unroll
  for (int u = 0; u < kB; ++u) {
    const int q = q0 + u * blockDim.x;
    const int gb = t.b0a + 16 * q;
    if (q < t.n_chunks && gb >= t.lo && gb + 16 <= row_bytes)
      v[u] = __ldg(reinterpret_cast<const uint4*>(t.row + gb));
  }
}

// the chunks into the polyphase planes, each byte converted once:
// plane_phi[s] = x[decim*(mlo - q_pad + 1 + s) - phi] (the zero level 128
// outside the raw row), the carried zi added where -t1 <= x index < 0
template <int D, int QP>
__device__ __forceinline__ void scatter_window(const Args& p, const Tile& t,
                                               int q0, uint4 (&v)[kB],
                                               float* sp) {
  const int DEC = D ? D : p.decim, QPD = QP ? QP : p.q_pad;
  const int nt = blockDim.x;
  const int c = t.c, i_lo = t.i_lo, b0a = t.b0a, n_chunks = t.n_chunks;
  const int lo = t.lo;
  const uint8_t* row = t.row;
  const int row_bytes = 2 * p.n_pairs;
  const int t1 = p.taps - 1;
  const int n_win = DEC * p.ps;                 // pairs of the window
  const int qs = DEC * p.ps;                    // from I to Q planes
#pragma unroll
  for (int u = 0; u < kB; ++u) {
    const int q = q0 + u * nt;
    if (q < n_chunks) {
      const int gb = b0a + 16 * q;
      if (gb < lo || gb + 16 > row_bytes)   // the row's edges
        v[u] = edge_chunk(row, gb, lo, row_bytes);
      // pair gb/2 + e of the segment is window pair ir0 + e: plane
      // decim-1 - ir % decim, index ir / decim (kept >= 0 by the offset:
      // ir0 >= -7); 8 pairs cross at most one plane wrap (decim >= 8)
      const int ir0 = gb / 2 - i_lo;
      const int s0 = (ir0 + 8 * DEC) / DEC - 8;
      const int phi0 = DEC - 1 - (ir0 + 8 * DEC) % DEC;
      if (ir0 >= 0 && ir0 + 8 <= n_win && gb >= 0 && DEC >= 8) {
        // inside the window and past the carried tail: no checks
        float* d = sp + phi0 * p.ps + s0;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const unsigned w = pair_of(v[u], e);
          float* de = d - e * p.ps + (e > phi0 ? qs + 1 : 0);
          de[0] = normed(w);
          de[qs] = normed(w >> 8);
        }
      } else {
        int s = s0, phi = phi0;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int ir = ir0 + e;
          if (ir >= 0 && ir < n_win) {
            const unsigned w = pair_of(v[u], e);
            float vi = normed(w), vq = normed(w >> 8);
            const int i = ir + i_lo;
            if (i < 0 && i >= -t1) {
              const size_t z = (size_t)c * t1 + (t1 + i);
              vi += p.zi_i[z];
              vq += p.zi_q[z];
            }
            sp[phi * p.ps + s] = vi;
            sp[qs + phi * p.ps + s] = vq;
          }
          if (--phi < 0) {
            phi = DEC - 1;
            ++s;
          }
        }
      }
    }
  }
}

// ---- everything of a tile after the RF stage: its outputs and states
template <int MODE, int DN, int AQ>
__device__ __forceinline__ void tile_rest(const Args& p, const Tile& tl,
                                          float (&acc)[2][4], float* sp,
                                          const float* sga,
                                          const float* sbh) {
  const int DWN = DN ? DN : p.down, AQP = AQ ? AQ : p.aq_pad;
  // once the RF stage has read the planes, their memory holds:
  float* si = sp;                              // IF slots I
  float* sq = si + p.slots;                    // IF slots Q
  float* sf = sq + p.slots;                    // fm slots (bank stage)
  float* sap = sf + p.slots;                   // audio planes (down, aps)
  float* spart = sap + DWN * p.aps;         // audio partial sums
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int c = tl.c, tile_idx = tl.tile_idx, t0 = tl.t0, mlo = tl.mlo;
  const int own = tl.own;
  const uint8_t* row = tl.row;
  const int t1 = p.taps - 1;
  const int o = 4 * tid;
  const int m = mlo + o;
  if (MODE != kIq) __syncthreads();   // the planes are read: slots go there
  if (MODE == kIq) {
    if (o < own) {
      const size_t y = (size_t)c * p.m_if + m;
      if (p.vec_out && o + 4 <= own) {
        *reinterpret_cast<float4*>(p.out_i + y) =
            make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
        *reinterpret_cast<float4*>(p.out_q + y) =
            make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
      } else {
        for (int r = 0; r < 4 && o + r < own; ++r) {
          p.out_i[y + r] = acc[0][r];
          p.out_q[y + r] = acc[1][r];
        }
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float vi = acc[0][r], vq = acc[1][r];
      if (m + r < 0) {            // IF sample -1 is the carried one
        vi = m + r == -1 ? p.prev_i[c] : 0.0f;
        vq = m + r == -1 ? p.prev_q[c] : 0.0f;
      }
      si[o + r] = vi;
      sq[o + r] = vq;
    }
  }

  // ---- new RF state: the last taps-1 normalised I/Q pairs of the row
  if (tile_idx == p.n_tiles - 1) {
    for (int j = tid; j < t1; j += nt) {
      const int pos = p.n_pairs - t1 + j;
      const size_t z = (size_t)c * t1;
      p.zi_i_out[z + j] = pos < 0 ? p.zi_i[z + t1 + pos]
                                  : ((float)row[2 * pos] - 128.0f) * 0.0078125f;
      p.zi_q_out[z + j] = pos < 0 ? p.zi_q[z + t1 + pos]
                                  : ((float)row[2 * pos + 1] - 128.0f) * 0.0078125f;
    }
  }
  if (MODE == kIq) return;
  __syncthreads();

  // ---- discriminator: slot r holds fm[mlo + r], from slots r and r-1;
  // with the audio stage each fm also goes to its audio plane:
  // plane_psi[s] = fm[down*(t0/down - aq_pad + 1 + s) - psi]
  const int at1 = p.ataps - 1;    // audio look-back (0 in mode fm)
  const int e = p.halo - DWN * AQP;
  for (int r = 1 + tid; r < p.halo + own; r += nt) {
    const int j = mlo + r;
    float f;
    if (j < 0) {                  // fmext before the block
      f = j >= -at1 ? p.audio_zi[(size_t)c * at1 + (at1 + j)] : 0.0f;
    } else {
      const float i = si[r], q = sq[r], ip = si[r - 1], qp = sq[r - 1];
      f = atan2f(q * ip - i * qp, i * ip + q * qp);
    }
    if (MODE == kFmAudioBank) sf[r] = f;
    if (MODE >= kFmAudio) {
      const int jp = r - e - DWN;
      if (jp + DWN - 1 >= 0) {
        const int s = (jp + DWN - 1) / DWN;
        sap[(DWN * s - jp) * p.aps + s] = f;
      }
    }
    if (j >= t0) {                 // owned (j < m_if holds for every slot)
      if (p.fm != nullptr) p.fm[(size_t)c * p.m_if + j] = f;
      if (MODE >= kFmAudio && j >= p.m_if - at1)
        p.audio_zi_out[(size_t)c * at1 + (j - (p.m_if - at1))] = f;
      if (j == p.m_if - 1) {
        p.prev_i_out[c] = si[r];
        p.prev_q_out[c] = sq[r];
      }
    }
  }
  if (MODE < kFmAudio) return;
  // a block shorter than the audio look-back keeps part of the old tail
  if (tile_idx == 0)
    for (int j = tid; j < at1 - p.m_if; j += nt)
      p.audio_zi_out[(size_t)c * at1 + j] =
          p.audio_zi[(size_t)c * at1 + p.m_if + j];
  __syncthreads();

  // ---- audio low-pass + decimate over the audio planes: work item
  // (psi, group) makes the partial sums of phase psi for the 4 outputs
  // a0 + 4*group .. + 3; then each output adds its partials, psi ascending
  const int a0 = t0 / DWN;                 // a multiple of 4
  const int n_a = own / DWN;
  const int n_g = (n_a + 3) / 4;
  const int pst = round4(p.tile / DWN) + 4;  // partials per phase
  for (int w = tid; w < DWN * n_g; w += nt) {
    const int psi = w / n_g, al = 4 * (w % n_g);
    float aacc[1][4] = {{0.0f, 0.0f, 0.0f, 0.0f}};
    const float* x[1] = {sap + psi * p.aps + al};
    plane_fir<1>(x, sga + psi * AQP, AQP, aacc);
    *reinterpret_cast<float4*>(spart + psi * pst + al) =
        make_float4(aacc[0][0], aacc[0][1], aacc[0][2], aacc[0][3]);
  }
  __syncthreads();
  for (int al = tid; al < n_a; al += nt) {
    float acc = spart[al];
    for (int psi = 1; psi < DWN; ++psi) acc += spart[psi * pst + al];
    p.audio[(size_t)c * p.n_audio + a0 + al] = acc;
  }
  if (MODE != kFmAudioBank) return;

  // ---- IF band-pass bank over the fm slots, stride 1, taps in the plain
  // version's order
  const int bt1 = p.btaps - 1;
  for (int oo = tid; oo < own; oo += nt) {
    const int mm = t0 + oo;
    const float* w = sf + p.halo + oo;          // w[-k] = fm[mm - k]
    const int kin = min(bt1, mm);               // taps that stay in the block
    float bacc[kMaxBank] = {0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int k = 0; k <= kin; ++k) {
      const float xv = w[-k];
#pragma unroll
      for (int f = 0; f < kMaxBank; ++f)
        bacc[f] = fmaf(sbh[f * p.btaps + k], xv, bacc[f]);
    }
    // the row's first outputs: tap k > mm reads bext[mm + bt1 - k] = bank_zi
    for (int k = kin + 1; k <= bt1; ++k) {
      const float xv = p.bank_zi[(size_t)c * bt1 + (mm + bt1 - k)];
#pragma unroll
      for (int f = 0; f < kMaxBank; ++f)
        bacc[f] = fmaf(sbh[f * p.btaps + k], xv, bacc[f]);
    }
#pragma unroll
    for (int f = 0; f < kMaxBank; ++f)
      if (f < p.n_bank)
        p.bank[((size_t)f * p.n_ch + c) * p.m_if + mm] = bacc[f];
  }
}

// D, QP, DN, AQ: the RF decimation and taps per phase, the audio
// decimation and taps per phase when known at compile time (0: read from p)
template <int MODE, int D, int QP, int DN, int AQ>
__global__ void __launch_bounds__(kMaxThreads, 2) ingest_kernel(Args p) {
  const int DEC = D ? D : p.decim, QPD = QP ? QP : p.q_pad;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sg = reinterpret_cast<float*>(smem);                 // RF phase taps
  float* sga = sg + DEC * QPD;                        // audio's
  float* sbh = sga + (MODE >= kFmAudio ? p.down * p.aq_pad : 0);  // bank's
  float* sp = sbh + (MODE == kFmAudioBank ? round4(kMaxBank * p.btaps) : 0);
  const int nt = blockDim.x;
  const int tid = threadIdx.x;

  // the tile's window: its loads in flight while the taps are staged
  const Tile tl = tile_of<D, QP>(p, blockIdx.x);
  uint4 v[kB];
  load_window(p, tl, tid, v);

  // reversed phase taps: g_phi[u] = h[decim*(q_pad-1-u) + phi], 0 past h
  for (int k = tid; k < DEC * QPD; k += nt) {
    const int kk = DEC * (QPD - 1 - k % QPD) + k / QPD;
    sg[k] = kk < p.taps ? p.rf_h[kk] : 0.0f;
  }
  if (MODE >= kFmAudio)
    for (int k = tid; k < p.down * p.aq_pad; k += nt) {
      const int kk = p.down * (p.aq_pad - 1 - k % p.aq_pad) + k / p.aq_pad;
      sga[k] = kk < p.ataps ? p.audio_h[kk] : 0.0f;
    }
  if (MODE == kFmAudioBank)
    for (int k = tid; k < kMaxBank * p.btaps; k += nt)
      sbh[k] = k < p.n_bank * p.btaps ? p.bank_h[k] : 0.0f;  // unused: zero taps

  scatter_window<D, QP>(p, tl, tid, v, sp);
  for (int q0 = tid + kB * nt; q0 < tl.n_chunks; q0 += kB * nt) {
    load_window(p, tl, q0, v);
    scatter_window<D, QP>(p, tl, q0, v, sp);
  }
  __syncthreads();

  // ---- RF low-pass + decimate: IF slots o .. o+3 of this thread,
  // y[mlo + o + r] = sum_phi sum_u g_phi[u] * plane_phi[o + r + u]
  const int o = 4 * tid;
  float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll 1
  for (int phi = 0; phi < DEC; ++phi) {
    const float* x[2] = {sp + phi * p.ps + o, sp + (DEC + phi) * p.ps + o};
    plane_fir<2>(x, sg + phi * QPD, QPD, acc);
  }
  tile_rest<MODE, DN, AQ>(p, tl, acc, sp, sga, sbh);
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

// the plan of a block of `threads` threads (its slots, tile and shared
// memory); false when such a block holds no tile
template <int MODE>
bool plan(Args& p, int threads, size_t* smem) {
  p.slots = 4 * threads;
  const int quantum = MODE >= kFmAudio ? 4 * p.down : 4;
  p.tile = (p.slots - p.halo) / quantum * quantum;
  if (p.tile < quantum) return false;
  p.n_tiles = (p.m_if + p.tile - 1) / p.tile;
  p.ps = p.slots + p.q_pad;
  p.aps = MODE >= kFmAudio ? round4(p.slots / p.down + p.aq_pad + 4) : 0;
  // the slots, audio planes and partial sums reuse the planes' memory
  *smem = sizeof(float) *
          ((size_t)p.decim * p.q_pad +
           (MODE >= kFmAudio ? (size_t)p.down * p.aq_pad : 0) +
           (MODE == kFmAudioBank ? (size_t)round4(kMaxBank * p.btaps) : 0) +
           (size_t)2 * p.decim * p.ps);
  return true;
}

template <int MODE>
cudaError_t launch(Args p, cudaStream_t stream) {
  if (p.n_ch <= 0 || p.n_pairs <= 0 || p.taps < 1 || p.decim < 1 ||
      p.n_pairs % p.decim != 0 || p.n_seg < 1 || p.n_ch % p.n_seg != 0 ||
      (p.n_seg > 1 && p.n_pairs < p.taps - 1) ||
      (reinterpret_cast<uintptr_t>(p.raw) & 1) != 0)
    return cudaErrorInvalidValue;
  p.m_if = p.n_pairs / p.decim;
  p.q_pad = round4((p.taps + p.decim - 1) / p.decim);
  p.aq_pad = 0;
  p.n_audio = 0;
  p.halo = MODE == kFm ? 4 : 0;
  if (MODE >= kFmAudio) {
    if (p.ataps < 1 || p.down < 1 || p.m_if % p.down != 0)
      return cudaErrorInvalidValue;
    if (MODE == kFmAudioBank &&
        (p.n_bank < 1 || p.n_bank > kMaxBank || p.btaps < 1 ||
         p.btaps > p.ataps))
      return cudaErrorInvalidValue;
    p.n_audio = p.m_if / p.down;
    p.aq_pad = round4((p.ataps + p.down - 1) / p.down);
    // the audio planes reach down*aq_pad fm samples back, and the first
    // of them one IF sample further
    p.halo = round4(p.down * p.aq_pad);
  }
  // the widest block that still gives two blocks per SM, else the
  // narrowest that holds a tile
  static const int kThreads[4] = {256, 128, 64, 32};
  const long long want = 2LL * sm_count();
  int pick = -1;
  size_t smem = 0;
  for (int i = 0; i < 4; ++i) {
    size_t sm_i = 0;
    if (!plan<MODE>(p, kThreads[i], &sm_i)) continue;
    pick = i;
    if ((long long)p.n_ch * p.n_tiles >= want && sm_i <= kSmemTwoBlocks)
      break;
  }
  if (pick < 0 || !plan<MODE>(p, kThreads[pick], &smem))
    return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(p.n_ch * p.n_tiles);
  p.vec_out = p.m_if % 4 == 0 &&
              (reinterpret_cast<uintptr_t>(p.out_i) & 15) == 0 &&
              (reinterpret_cast<uintptr_t>(p.out_q) & 15) == 0;
  // the receivers' front end (RF: decim 10, 151 taps; audio: down 5, 151
  // taps) has its own instance
  const bool rx = p.decim == 10 && p.q_pad == 16 &&
                  (MODE < kFmAudio || (p.down == 5 && p.aq_pad == 32));
  const void* kernel = rx ? (const void*)ingest_kernel<MODE, 10, 16, 5, 32>
                          : (const void*)ingest_kernel<MODE, 0, 0, 0, 0>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (rx)
    ingest_kernel<MODE, 10, 16, 5, 32>
        <<<blocks, kThreads[pick], smem, stream>>>(p);
  else
    ingest_kernel<MODE, 0, 0, 0, 0>
        <<<blocks, kThreads[pick], smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* rtsdr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shapes: raw (C, 2*n_pairs) u8 at an even address (the iq entry: raw
// (C/n_seg, n_seg*2*n_pairs), C output rows, n_pairs >= taps-1 if n_seg > 1);
// rf_h (taps,); zi_* and zi_*_out (C, taps-1); prev_* and prev_*_out (C,); audio_h (ataps,);
// audio_zi and audio_zi_out (C, ataps-1); out_i, out_q, fm (C, n_pairs/decim);
// audio (C, n_pairs/decim/down); bank_h (n_bank, btaps); bank_zi
// (C, btaps-1); bank (n_bank, C, n_pairs/decim).  All float32 but raw.  Each
// returns cudaGetLastError().

extern "C" int rtsdr_ingest_iq(const uint8_t* raw, const float* rf_h,
                               const float* zi_i, const float* zi_q,
                               float* out_i, float* out_q, float* zi_i_out,
                               float* zi_q_out, int n_ch, int n_pairs,
                               int taps, int decim, int n_seg, void* stream) {
  Args p = {};
  p.raw = raw; p.rf_h = rf_h; p.zi_i = zi_i; p.zi_q = zi_q;
  p.out_i = out_i; p.out_q = out_q;
  p.zi_i_out = zi_i_out; p.zi_q_out = zi_q_out;
  p.n_ch = n_ch; p.n_pairs = n_pairs; p.taps = taps; p.decim = decim;
  p.n_seg = n_seg;
  return (int)launch<kIq>(p, (cudaStream_t)stream);
}

extern "C" int rtsdr_ingest_fm(const uint8_t* raw, const float* rf_h,
                               const float* zi_i, const float* zi_q,
                               const float* prev_i, const float* prev_q,
                               float* fm, float* zi_i_out, float* zi_q_out,
                               float* prev_i_out, float* prev_q_out, int n_ch,
                               int n_pairs, int taps, int decim,
                               void* stream) {
  Args p = {};
  p.raw = raw; p.rf_h = rf_h; p.zi_i = zi_i; p.zi_q = zi_q;
  p.prev_i = prev_i; p.prev_q = prev_q; p.fm = fm;
  p.zi_i_out = zi_i_out; p.zi_q_out = zi_q_out;
  p.prev_i_out = prev_i_out; p.prev_q_out = prev_q_out;
  p.n_ch = n_ch; p.n_pairs = n_pairs; p.taps = taps; p.decim = decim;
  p.n_seg = 1;
  p.ataps = 1;
  return (int)launch<kFm>(p, (cudaStream_t)stream);
}

// fm may be NULL: the demodulated stream is then not written at all.
extern "C" int rtsdr_ingest_fm_audio(
    const uint8_t* raw, const float* rf_h, const float* zi_i,
    const float* zi_q, const float* prev_i, const float* prev_q,
    const float* audio_h, const float* audio_zi, float* fm, float* audio,
    float* zi_i_out, float* zi_q_out, float* prev_i_out, float* prev_q_out,
    float* audio_zi_out, int n_ch, int n_pairs, int taps, int decim,
    int ataps, int down, void* stream) {
  Args p = {};
  p.raw = raw; p.rf_h = rf_h; p.zi_i = zi_i; p.zi_q = zi_q;
  p.prev_i = prev_i; p.prev_q = prev_q;
  p.audio_h = audio_h; p.audio_zi = audio_zi; p.fm = fm; p.audio = audio;
  p.zi_i_out = zi_i_out; p.zi_q_out = zi_q_out;
  p.prev_i_out = prev_i_out; p.prev_q_out = prev_q_out;
  p.audio_zi_out = audio_zi_out;
  p.n_ch = n_ch; p.n_pairs = n_pairs; p.taps = taps; p.decim = decim;
  p.n_seg = 1;
  p.ataps = ataps; p.down = down;
  return (int)launch<kFmAudio>(p, (cudaStream_t)stream);
}

// fm_audio plus the band-pass bank; fm may be NULL as above.  n_bank in
// 1..3, btaps <= ataps.
extern "C" int rtsdr_ingest_fm_audio_bank(
    const uint8_t* raw, const float* rf_h, const float* zi_i,
    const float* zi_q, const float* prev_i, const float* prev_q,
    const float* audio_h, const float* audio_zi, const float* bank_h,
    const float* bank_zi, float* fm, float* audio, float* bank,
    float* zi_i_out, float* zi_q_out, float* prev_i_out, float* prev_q_out,
    float* audio_zi_out, int n_ch, int n_pairs, int taps, int decim,
    int ataps, int down, int n_bank, int btaps, void* stream) {
  Args p = {};
  p.raw = raw; p.rf_h = rf_h; p.zi_i = zi_i; p.zi_q = zi_q;
  p.prev_i = prev_i; p.prev_q = prev_q;
  p.audio_h = audio_h; p.audio_zi = audio_zi;
  p.bank_h = bank_h; p.bank_zi = bank_zi;
  p.fm = fm; p.audio = audio; p.bank = bank;
  p.zi_i_out = zi_i_out; p.zi_q_out = zi_q_out;
  p.prev_i_out = prev_i_out; p.prev_q_out = prev_q_out;
  p.audio_zi_out = audio_zi_out;
  p.n_ch = n_ch; p.n_pairs = n_pairs; p.taps = taps; p.decim = decim;
  p.n_seg = 1;
  p.ataps = ataps; p.down = down; p.n_bank = n_bank; p.btaps = btaps;
  return (int)launch<kFmAudioBank>(p, (cudaStream_t)stream);
}
