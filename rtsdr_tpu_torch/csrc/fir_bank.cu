// FIR bank: F equal-length FIRs over one (C, N) float32 input at output
// stride s, with an optional elementwise pre-op and the overlap-save state.
//
//   y[f][c][m] = sum_k h[f][k] * xext[c][m*s + taps-1-k],  xext = [zi | pre(x)]
//   pre: 0 none, 1 square (x*x), 2 mul2 (2*x*x2)
//   zi_out[c]  = last taps-1 samples of xext (already in the pre-op domain)
//
// Replaces the Pallas kernel rtsdr_tpu/ops/pallas_fir.py::_fir_kernel
// (reached from fir_bank / fir_bank_carried / fir_block_pre).  That kernel
// contracts bf16 windows against a banded Toeplitz matrix on the matrix
// unit and adds the carried tail outside; here each output is a float32
// sum over the taps, and zi is read directly for indices before the block.
//
// Bound on an H100: operations at 151 taps (2*taps FLOP per output and
// filter against 4/s input bytes and 4 output bytes: 30-60 FLOP per byte,
// above the ~20 where the float32 CUDA-core rate of 67 TFLOP/s meets the
// memory rate of 3.35 TB/s); bytes for one filter at stride 5 with the
// mixer pre-op.  The first version of this kernel was bound by
// shared-memory reads instead: every multiply-add of a thread's one output
// needed one x read, and each of the F filters one tap read.  It also left
// most of the card idle at small shapes (C = 1 at stride 1: 15 blocks of
// 1,024 outputs on 132 SMs).
//
// Design:
//   * Register blocking.  A thread makes R = 4*G outputs (G groups of 4
//     consecutive outputs) for all F filters.  Per group it slides an
//     8-sample register window along the input: one 16-byte shared read of
//     x and F broadcast 16-byte tap reads feed 16*F multiply-adds (the
//     first version: F per read).  A warp's group reads are 512 contiguous
//     bytes, free of bank conflicts.
//   * Polyphase staging.  At stride s the staged span is split into its s
//     polyphase planes as it is loaded (element j of the span goes to plane
//     j % s, index j / s), and the taps into s phase filters of
//     ceil((taps + pad) / s) taps each, zero-padded to a multiple of 4 on
//     the host.  Each plane is then a stride-1 FIR with the same blocking.
//     The taps are also padded at the front (pad zeros, taps-1+pad a
//     multiple of 4), so that the span starts on a 16-byte boundary of x:
//     the pre-op, the zi look-back and the masked ragged edge are applied
//     as the span is staged, from 16-byte loads where the row allows, four
//     (eight in a one-warp block) in flight per thread, the taps' loads
//     issued before them.
//   * Summation order.  Each output adds its taps in the plain version's
//     order (k ascending, one fused multiply-add each; the padding adds
//     exact zeros), so it equals the plain version bit for bit.
//   * Launch geometry by shape.  Tiles of 1,024, 512, 256 or 128 outputs
//     (128 threads x 2 groups down to 32 x 1): the widest that still gives
//     two blocks per SM, so C >= 1,024 keeps wide tiles (the taps-1 halo a
//     small share of the span) and C = 1 is spread over the card.
// Each block makes one tile, so there is nothing to double-buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 128;
constexpr int kTapsAhead = 4;   // tap loads per thread issued before x's

// xext at x index g of row c, in the pre-op domain: zi before the block
// (zero before zi, and for a NULL zi), zero past its end
__device__ __forceinline__ float xext_at(const float* __restrict__ x,
                                         const float* __restrict__ x2,
                                         const float* __restrict__ zi, int pre,
                                         int c, int g, int n, int t1) {
  if (g < 0) {
    if (g < -t1 || zi == nullptr) return 0.0f;
    return zi[(size_t)c * t1 + (t1 + g)];
  }
  if (g >= n) return 0.0f;
  const float v = x[(size_t)c * n + g];
  if (pre == 1) return v * v;
  if (pre == 2) return 2.0f * v * x2[(size_t)c * n + g];
  return v;
}

// F filters, S the stride (0: any stride, given at run time), G groups of
// 4 outputs per thread, B 16-byte staging loads in flight per thread; a
// tile is blockDim.x * 4 * G outputs
template <int F, int S, int G, int B>
__global__ void __launch_bounds__(kMaxThreads)
fir_bank_kernel(const float* __restrict__ x, const float* __restrict__ x2,
                const float* __restrict__ zi, const float* __restrict__ hp,
                float* __restrict__ y, float* __restrict__ zi_out, int n_ch,
                int n, int m_out, int t1, int stride_rt, int q_pad, int lead,
                int n_tiles, int pre, int vec_in, int vec_out) {
  extern __shared__ __align__(16) float smem[];
  const int s = S ? S : stride_rt;
  const int nt = blockDim.x;
  const int tile = nt * 4 * G;
  const int plane = tile + q_pad;           // floats per polyphase plane
  float* sh = smem;                         // (F, s, q_pad) phase taps
  float* sx = smem + F * s * q_pad;         // (s, plane) polyphase planes
  const int c = blockIdx.x / n_tiles;
  const int tix = blockIdx.x % n_tiles;
  const int m0 = tix * tile;
  const int g0 = m0 * s - lead;             // x index of span element 0
  const int tid = threadIdx.x;

  // the taps' loads are issued first and stored after the span's loads:
  // at C = 1 the load latency is most of a launch
  const int n_h4 = F * s * q_pad / 4;
  const float4* h4 = reinterpret_cast<const float4*>(hp);
  float4* s4 = reinterpret_cast<float4*>(sh);
  float4 tv[kTapsAhead];
#pragma unroll
  for (int u = 0; u < kTapsAhead; ++u)
    if (tid + u * nt < n_h4) tv[u] = h4[tid + u * nt];

  // the span, 4 elements at a time (g0 and the span are multiples of 4);
  // each thread puts the 16-byte loads of B such groups in flight before
  // it stores any
  const int span4 = plane * s / 4;
  for (int j0 = tid; j0 < span4; j0 += B * nt) {
    float4 a[B], b[B];
    bool inside[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int j4 = j0 + u * nt;
      const int g = g0 + 4 * j4;
      inside[u] = vec_in && j4 < span4 && g >= 0 && g < n;
      if (inside[u]) {
        a[u] = *reinterpret_cast<const float4*>(x + (size_t)c * n + g);
        if (pre == 2)
          b[u] = *reinterpret_cast<const float4*>(x2 + (size_t)c * n + g);
      }
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int j4 = j0 + u * nt;
      if (j4 >= span4) break;
      const int j = 4 * j4;
      float v[4];
      if (inside[u]) {
        v[0] = a[u].x, v[1] = a[u].y, v[2] = a[u].z, v[3] = a[u].w;
        if (pre == 1) {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] *= v[e];
        } else if (pre == 2) {
          v[0] = 2.0f * v[0] * b[u].x, v[1] = 2.0f * v[1] * b[u].y;
          v[2] = 2.0f * v[2] * b[u].z, v[3] = 2.0f * v[3] * b[u].w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = xext_at(x, x2, zi, pre, c, g0 + j + e, n, t1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = j + e;
        sx[(jj % s) * plane + jj / s] = v[e];
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kTapsAhead; ++u)
    if (tid + u * nt < n_h4) s4[tid + u * nt] = tv[u];
  for (int i = tid + kTapsAhead * nt; i < n_h4; i += nt) s4[i] = h4[i];
  __syncthreads();

  // Every output sums its taps in the plain version's order, k ascending
  // (p = lead - k descending), one fused multiply-add each: the zero taps
  // of the padding add exact zeros, so the sums round as the plain
  // version's do.
  float acc[G][4][F];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int f = 0; f < F; ++f) acc[g][r][f] = 0.0f;

  if (S == 1) {
    // window [lo | hi] = plane[o + q0 .. o + q0 + 7], sliding down
    const float* pl = sx + tid * 4;
    float4 hi[G];
#pragma unroll
    for (int g = 0; g < G; ++g)
      hi[g] = *reinterpret_cast<const float4*>(pl + g * 4 * nt + q_pad);
    for (int q0 = q_pad - 4; q0 >= 0; q0 -= 4) {
      float hv[F][4];
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float4 t = *reinterpret_cast<const float4*>(sh + f * q_pad + q0);
        hv[f][0] = t.x, hv[f][1] = t.y, hv[f][2] = t.z, hv[f][3] = t.w;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 lo =
            *reinterpret_cast<const float4*>(pl + g * 4 * nt + q0);
        const float w[8] = {lo.x,    lo.y,    lo.z,    lo.w,
                            hi[g].x, hi[g].y, hi[g].z, hi[g].w};
#pragma unroll
        for (int qq = 3; qq >= 0; --qq)
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int f = 0; f < F; ++f)
              acc[g][r][f] = fmaf(hv[f][qq], w[qq + r], acc[g][r][f]);
        hi[g] = lo;
      }
    }
  } else if (S > 1) {
    // one window per plane; p = q*S + phi descending is q descending with
    // phi descending inside (G is 1)
    const int sp = S > 1 ? S : 1;
    float4 hi[sp];
#pragma unroll
    for (int ph = 0; ph < sp; ++ph)
      hi[ph] = *reinterpret_cast<const float4*>(sx + ph * plane + tid * 4 +
                                                q_pad);
    for (int q0 = q_pad - 4; q0 >= 0; q0 -= 4) {
      float4 lo[sp];
      float4 hv[sp][F];
#pragma unroll
      for (int ph = 0; ph < sp; ++ph) {
        lo[ph] = *reinterpret_cast<const float4*>(sx + ph * plane + tid * 4 +
                                                  q0);
#pragma unroll
        for (int f = 0; f < F; ++f)
          hv[ph][f] = *reinterpret_cast<const float4*>(
              sh + (f * sp + ph) * q_pad + q0);
      }
#pragma unroll
      for (int qq = 3; qq >= 0; --qq)
#pragma unroll
        for (int ph = sp - 1; ph >= 0; --ph) {
          const float w[8] = {lo[ph].x, lo[ph].y, lo[ph].z, lo[ph].w,
                              hi[ph].x, hi[ph].y, hi[ph].z, hi[ph].w};
#pragma unroll
          for (int f = 0; f < F; ++f) {
            const float hk = qq == 0 ? hv[ph][f].x
                           : qq == 1 ? hv[ph][f].y
                           : qq == 2 ? hv[ph][f].z : hv[ph][f].w;
#pragma unroll
            for (int r = 0; r < 4; ++r)
              acc[0][r][f] = fmaf(hk, w[qq + r], acc[0][r][f]);
          }
        }
#pragma unroll
      for (int ph = 0; ph < sp; ++ph) hi[ph] = lo[ph];
    }
  } else {
    // any other stride: the same order from scalar reads
    for (int p = s * q_pad - 1; p >= 0; --p) {
      const int ph = p % s, q = p / s;
      const float* pl = sx + ph * plane + tid * 4 + q;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float hk = sh[(f * s + ph) * q_pad + q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[0][r][f] = fmaf(hk, pl[r], acc[0][r][f]);
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int m = m0 + g * 4 * nt + tid * 4;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float* row = y + ((size_t)f * n_ch + c) * m_out;
      if (vec_out && m + 3 < m_out) {
        *reinterpret_cast<float4*>(row + m) =
            make_float4(acc[g][0][f], acc[g][1][f], acc[g][2][f],
                        acc[g][3][f]);
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (m + r < m_out) row[m + r] = acc[g][r][f];
      }
    }
  }

  // the block of the last tile also writes the carried tail
  if (zi_out != nullptr && tix == n_tiles - 1) {
    for (int j = tid; j < t1; j += nt)
      zi_out[(size_t)c * t1 + j] =
          xext_at(x, x2, zi, pre, c, n - t1 + j, n, t1);
  }
}

struct Args {
  const float *x, *x2, *zi, *hp;
  float *y, *zi_out;
  int n_ch, n, m_out, t1, stride, q_pad, lead, pre, vec_in, vec_out;
};

template <int F, int S, int G, int B>
cudaError_t launch(const Args& a, int threads, cudaStream_t stream) {
  const int tile = threads * 4 * G;
  const int n_tiles = (a.m_out + tile - 1) / tile;
  const size_t smem = sizeof(float) * ((size_t)F * a.stride * a.q_pad +
                                       (size_t)a.stride * (tile + a.q_pad));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fir_bank_kernel<F, S, G, B>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  fir_bank_kernel<F, S, G, B><<<(unsigned)(a.n_ch * n_tiles), threads, smem,
                                stream>>>(
      a.x, a.x2, a.zi, a.hp, a.y, a.zi_out, a.n_ch, a.n, a.m_out, a.t1,
      a.stride, a.q_pad, a.lead, n_tiles, a.pre, a.vec_in, a.vec_out);
  return cudaGetLastError();
}

template <int F, int S>
cudaError_t launch_g(const Args& a, int threads, int groups,
                     cudaStream_t stream) {
  // the narrowest tile (one warp per block: a small launch, bound by load
  // latency) keeps twice the staging loads in flight; wider tiles keep the
  // registers for occupancy
  if (S == 1 && groups == 2) return launch<F, 1, 2, 4>(a, threads, stream);
  if (threads == 32) return launch<F, S, 1, 8>(a, threads, stream);
  return launch<F, S, 1, 4>(a, threads, stream);
}

template <int F>
cudaError_t launch_s(const Args& a, int threads, int groups,
                     cudaStream_t stream) {
  switch (a.stride) {
    case 1: return launch_g<F, 1>(a, threads, groups, stream);
    case 5: return launch_g<F, 5>(a, threads, groups, stream);
    case 10: return launch_g<F, 10>(a, threads, groups, stream);
  }
  return launch_g<F, 0>(a, threads, groups, stream);
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

// x, x2 (NULL unless pre == 2): (C, N); zi (NULL = zero state): (C, taps-1);
// hp: the F filters of `taps` taps as phase taps (F, stride, q_pad), 16-byte
// aligned, as ops/cuda_fir.py::phase_taps builds them: lead = taps-1 rounded
// up to a multiple of 4, hp[f][phi][q] = h[f][lead - q*stride - phi] where
// that index lies in [0, taps), else 0, q_pad = ceil((lead+1) / stride)
// rounded up to a multiple of 4; y: (F, C, M), M = ceil(N / stride);
// zi_out (or NULL): (C, taps-1).  F in 1..3.  Returns cudaGetLastError().
extern "C" int rtsdr_fir_bank(const float* x, const float* x2, const float* zi,
                              const float* hp, float* y, float* zi_out,
                              int n_ch, int n, int m_out, int taps, int n_f,
                              int stride, int pre, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_ch <= 0 || n <= 0 || m_out <= 0 || taps < 1 || stride < 1 ||
      pre < 0 || pre > 2 || (pre == 2 && x2 == nullptr) ||
      ((uintptr_t)hp & 15) != 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x, a.x2 = x2, a.zi = zi, a.hp = hp, a.y = y, a.zi_out = zi_out;
  a.n_ch = n_ch, a.n = n, a.m_out = m_out, a.t1 = taps - 1, a.stride = stride;
  a.lead = (a.t1 + 3) / 4 * 4;
  a.q_pad = ((a.lead + 1 + stride - 1) / stride + 3) / 4 * 4;
  a.pre = pre;
  a.vec_in = n % 4 == 0 && ((uintptr_t)x & 15) == 0 &&
             (pre != 2 || ((uintptr_t)x2 & 15) == 0);
  a.vec_out = m_out % 4 == 0 && ((uintptr_t)y & 15) == 0;
  // the widest tile that still gives two blocks per SM (else the
  // narrowest), within the shared memory a block may have
  static const int kThreads[4] = {128, 128, 64, 32};
  static const int kGroups[4] = {2, 1, 1, 1};
  const long long want = 2LL * sm_count();
  int pick = 3;
  for (int i = stride == 1 ? 0 : 1; i < 4; ++i) {   // 2 groups: stride 1
    const int tile = kThreads[i] * 4 * kGroups[i];
    const long long blocks = (long long)n_ch * ((m_out + tile - 1) / tile);
    const size_t smem = sizeof(float) * ((size_t)n_f * stride * a.q_pad +
                                         (size_t)stride * (tile + a.q_pad));
    if (blocks >= want && smem <= 200 * 1024) {
      pick = i;
      break;
    }
  }
  const int th = kThreads[pick], gr = kGroups[pick];
  switch (n_f) {
    case 1: return (int)launch_s<1>(a, th, gr, s);
    case 2: return (int)launch_s<2>(a, th, gr, s);
    case 3: return (int)launch_s<3>(a, th, gr, s);
  }
  return (int)cudaErrorInvalidValue;
}
