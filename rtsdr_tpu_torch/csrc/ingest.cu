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
// n_bank epilogue as the fourth entry).  Those contract byte windows against banded two-level
// int8 tap matrices on the matrix unit, carry a rolling fm scratch from one
// grid step to the next and use a polynomial atan2; here the taps are
// float32, the angle is atan2f, and since CUDA blocks run in no order the
// look-back of the audio stage is recomputed as a halo: a block that owns IF
// outputs [t0, t0+T) also computes the ataps IF samples before them.  The
// carried zi is read directly for the first outputs of the block.
//
// Bound on an H100: operations.  At 1,024 channels of 307,200 bytes the RF
// stage is 2 * 2 * 151 FLOP for each of 15.7 M IF samples (9.5 GFLOP) plus
// 0.95 GFLOP of audio taps, against 315 MB read and ~75 MB written: ~27
// FLOP per byte, above the ~20 where the float32 CUDA-core rate (67 TFLOP/s)
// meets the memory rate (3.35 TB/s), so the least time is set by the CUDA
// cores' float32 rate, not by memory.  Design: one block per (channel, tile
// of T IF outputs); the tile's raw bytes plus look-back go to shared memory
// once with 16-byte loads and stay uint8 there (a quarter of the float
// footprint, so more blocks per SM); each thread produces IF (i, q) pairs,
// reading one 16-bit (I, Q) word per tap and converting the bytes with an
// exact integer-to-float bit trick; fm goes through atan2f into shared
// memory; the audio stage reads it there.  The halo costs (ataps / T) extra
// RF work (25 % at T = 615).  This first version spends about four
// instructions per multiply-add, so it runs well below the bound.
//
// The bank stage reads the fm slots the audio stage reads: its look-back of
// btaps-1 <= ataps-1 samples lies inside the halo already computed, so the
// demodulated stream reaches the pilot / stereo / RDS band-passes without a
// trip through device memory.  It adds 2 * F * btaps FLOP per IF sample
// (13.9 GFLOP at 1,024 channels, F = 3: more than the RF stage) for 126 MB
// of traffic saved; each thread keeps F accumulators so that one
// shared-memory read of fm feeds F multiply-adds.  The first btaps-1 outputs
// of a row take their look-back from bank_zi in device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRounds = 3;                    // IF slots per thread
constexpr int kSlots = kThreads * kRounds;    // IF slots per block, halo included

constexpr int kMaxBank = 3;                   // band-passes in the bank stage

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
  int m_if, n_audio;     // IF samples / audio samples per block
  int halo, tile, n_tiles;
  int raw_bytes;         // shared-memory bytes for the raw window (16-multiple)
  int n_seg;             // segments per raw row (iq entry), else 1
};

// exact uint8 -> float of (b - 128): 0x4B000000 | b is the float 2^23 + b
__device__ __forceinline__ float centred(unsigned b) {
  return __uint_as_float(0x4B000000u | b) - 8388736.0f;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) ingest_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sraw = smem;
  float* sh = reinterpret_cast<float*>(smem + p.raw_bytes);   // RF taps
  float* sah = sh + p.taps;                                   // audio taps
  float* sbh = sah + (MODE >= kFmAudio ? p.ataps : 0);        // bank taps
  float* si = sbh + (MODE == kFmAudioBank ? kMaxBank * p.btaps : 0);  // IF slots
  float* sq = si + kSlots;
  float* sf = sq + kSlots;                                    // fm slots

  const int tid = threadIdx.x;
  const int c = blockIdx.x / p.n_tiles;
  const int tile_idx = blockIdx.x % p.n_tiles;
  const int t0 = tile_idx * p.tile;          // first IF output owned
  const int mlo = t0 - p.halo;               // IF index of slot 0
  const int t1 = p.taps - 1;
  const int own = min(p.tile, p.m_if - t0);  // IF outputs owned
  const int n_slots = own + p.halo;
  const int row_bytes = 2 * p.n_pairs;
  // output row c is segment `seg` of raw row c % n_src; the raw row's bytes
  // before the segment are real (lo <= 0 of them)
  const int n_src = p.n_ch / p.n_seg;
  const int seg = c / n_src;
  const int lo = -seg * row_bytes;
  const uint8_t* row =
      p.raw + ((size_t)(c % n_src) * p.n_seg + seg) * row_bytes;

  // ---- stage the raw window: bytes [b0, b1) of the segment (bytes before
  // it included, down to lo), zero level (128) outside them.  sraw[j] holds
  // segment byte b0a + j, with b0a <= b0 chosen so that 16-byte chunks are
  // aligned in global memory.
  const int b0 = 2 * (p.decim * mlo - t1);
  const int b1 = 2 * (p.decim * (mlo + n_slots - 1) + 1);
  const int shift = (int)((reinterpret_cast<intptr_t>(row) + b0) & 15);
  const int b0a = b0 - shift;
  const int n_chunks = (b1 - b0a + 15) >> 4;
  for (int q = tid; q < n_chunks; q += kThreads) {
    const int gb = b0a + 16 * q;
    if (gb >= lo && gb + 16 <= row_bytes) {
      *reinterpret_cast<uint4*>(sraw + 16 * q) =
          *reinterpret_cast<const uint4*>(row + gb);
    } else {
      for (int e = 0; e < 16; ++e) {
        const int g = gb + e;
        sraw[16 * q + e] =
            (g >= lo && g < row_bytes) ? row[g] : (uint8_t)128;
      }
    }
  }
  for (int k = tid; k < p.taps; k += kThreads) sh[k] = p.rf_h[k];
  if (MODE >= kFmAudio)
    for (int k = tid; k < p.ataps; k += kThreads) sah[k] = p.audio_h[k];
  if (MODE == kFmAudioBank)
    for (int k = tid; k < kMaxBank * p.btaps; k += kThreads)
      sbh[k] = k < p.n_bank * p.btaps ? p.bank_h[k] : 0.0f;  // unused: zero taps
  __syncthreads();

  // ---- RF low-pass + decimate: one (i, q) pair per slot
  for (int r = tid; r < n_slots; r += kThreads) {
    const int m = mlo + r;
    float vi = 0.0f, vq = 0.0f;
    if (m >= 0 && m < p.m_if) {
      // tap k reads pair (decim*m - k) of the block = window byte
      // shift + 2*(decim*r + t1 - k)
      const unsigned char* w = sraw + shift + 2 * (p.decim * r + t1);
      float ai = 0.0f, aq = 0.0f;
#pragma unroll 8
      for (int k = 0; k < p.taps; ++k) {
        const unsigned iq =
            *reinterpret_cast<const unsigned short*>(w - 2 * k);
        const float hk = sh[k];
        ai = fmaf(hk, centred(iq & 0xffu), ai);
        aq = fmaf(hk, centred(iq >> 8), aq);
      }
      vi = ai * 0.0078125f;
      vq = aq * 0.0078125f;
      // the first outputs of the block also see the carried tail: tap k
      // reads xext[decim*m + t1 - k] = zi[...] while that index is < t1
      for (int k = p.decim * m + 1; k <= t1; ++k) {
        const size_t z = (size_t)c * t1 + (p.decim * m + t1 - k);
        vi = fmaf(sh[k], p.zi_i[z], vi);
        vq = fmaf(sh[k], p.zi_q[z], vq);
      }
      if (MODE == kIq) {
        p.out_i[(size_t)c * p.m_if + m] = vi;
        p.out_q[(size_t)c * p.m_if + m] = vq;
      }
    } else if (MODE != kIq && m == -1) {
      vi = p.prev_i[c];
      vq = p.prev_q[c];
    }
    si[r] = vi;
    sq[r] = vq;
  }

  // ---- new RF state: the last taps-1 normalised I/Q pairs of the row
  if (tile_idx == p.n_tiles - 1) {
    for (int j = tid; j < t1; j += kThreads) {
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

  // ---- discriminator: slot r holds fm[mlo + r], from slots r and r-1
  const int at1 = p.ataps - 1;    // audio look-back (0 in mode fm)
  for (int r = 1 + tid; r < n_slots; r += kThreads) {
    const int j = mlo + r;
    float f;
    if (j < 0) {
      f = p.audio_zi[(size_t)c * at1 + (at1 + j)];   // fmext before the block
    } else {
      const float i = si[r], q = sq[r], ip = si[r - 1], qp = sq[r - 1];
      f = atan2f(q * ip - i * qp, i * ip + q * qp);
    }
    sf[r] = f;
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
    for (int j = tid; j < at1 - p.m_if; j += kThreads)
      p.audio_zi_out[(size_t)c * at1 + j] =
          p.audio_zi[(size_t)c * at1 + p.m_if + j];
  __syncthreads();

  // ---- audio low-pass + decimate over the fm slots
  const int a0 = t0 / p.down;                 // tile is a multiple of down
  const int n_a = min(p.tile / p.down, p.n_audio - a0);
  for (int al = tid; al < n_a; al += kThreads) {
    // tap k reads fm[down*(a0+al) - k] = slot halo + down*al - k
    const float* w = sf + p.halo + p.down * al;
    float acc = 0.0f;
#pragma unroll 8
    for (int k = 0; k < p.ataps; ++k) acc = fmaf(sah[k], w[-k], acc);
    p.audio[(size_t)c * p.n_audio + a0 + al] = acc;
  }
  if (MODE != kFmAudioBank) return;

  // ---- IF band-pass bank over the same fm slots, stride 1
  const int bt1 = p.btaps - 1;
  for (int o = tid; o < own; o += kThreads) {
    const int m = t0 + o;
    const float* w = sf + p.halo + o;           // w[-k] = fm[m - k]
    const int kin = min(bt1, m);                // taps that stay in the block
    float acc[kMaxBank] = {0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int k = 0; k <= kin; ++k) {
      const float xv = w[-k];
#pragma unroll
      for (int f = 0; f < kMaxBank; ++f)
        acc[f] = fmaf(sbh[f * p.btaps + k], xv, acc[f]);
    }
    // the row's first outputs: tap k > m reads bext[m + bt1 - k] = bank_zi
    for (int k = kin + 1; k <= bt1; ++k) {
      const float xv = p.bank_zi[(size_t)c * bt1 + (m + bt1 - k)];
#pragma unroll
      for (int f = 0; f < kMaxBank; ++f)
        acc[f] = fmaf(sbh[f * p.btaps + k], xv, acc[f]);
    }
#pragma unroll
    for (int f = 0; f < kMaxBank; ++f)
      if (f < p.n_bank)
        p.bank[((size_t)f * p.n_ch + c) * p.m_if + m] = acc[f];
  }
}

template <int MODE>
cudaError_t launch(Args p, cudaStream_t stream) {
  if (p.n_ch <= 0 || p.n_pairs <= 0 || p.taps < 1 || p.decim < 1 ||
      p.n_pairs % p.decim != 0 || p.n_seg < 1 || p.n_ch % p.n_seg != 0 ||
      (p.n_seg > 1 && p.n_pairs < p.taps - 1) ||
      (reinterpret_cast<uintptr_t>(p.raw) & 1) != 0)
    return cudaErrorInvalidValue;
  p.m_if = p.n_pairs / p.decim;
  p.halo = 0;
  p.tile = kSlots;
  p.n_audio = 0;
  if (MODE == kFm) p.halo = 1;
  if (MODE >= kFmAudio) {
    if (p.ataps < 1 || p.down < 1 || p.m_if % p.down != 0)
      return cudaErrorInvalidValue;
    if (MODE == kFmAudioBank &&
        (p.n_bank < 1 || p.n_bank > kMaxBank || p.btaps < 1 ||
         p.btaps > p.ataps))
      return cudaErrorInvalidValue;
    p.n_audio = p.m_if / p.down;
    p.halo = p.ataps;     // ataps-1 fm samples need one more IF sample
  }
  p.tile = kSlots - p.halo;
  if (MODE >= kFmAudio) p.tile = p.tile / p.down * p.down;
  if (p.tile < 1) return cudaErrorInvalidValue;
  p.n_tiles = (p.m_if + p.tile - 1) / p.tile;
  p.raw_bytes = (2 * ((kSlots - 1) * p.decim + p.taps) + 16 + 15) & ~15;
  const size_t smem =
      p.raw_bytes +
      sizeof(float) * ((size_t)p.taps + (MODE >= kFmAudio ? p.ataps : 0) +
                       (MODE == kFmAudioBank ? kMaxBank * p.btaps : 0) +
                       3 * kSlots);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ingest_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  ingest_kernel<MODE><<<(unsigned)(p.n_ch * p.n_tiles), kThreads, smem,
                        stream>>>(p);
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
