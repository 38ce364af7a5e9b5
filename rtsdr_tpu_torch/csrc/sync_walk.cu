// The RDS frame layer's resync walk: which syndrome matches of a block are
// accepted 26-spaced syncs, false positives and resyncs, with the C++
// reference's recovery (a run of more than 10 false positives resets the
// anchor).
//
// Per lane, per window w of the block (gp = base_pos + w):
//   match = sid[w] > 0 && valid[w]
//   ok    = last < 0 || gp - last == 26
//   real  = (match && ok) || (corr[w] && valid[w] && last >= 0
//                             && gp - last == 26)
//   fp    = match && !ok
//   last  = real ? gp : last
//   bad   = real ? 0 : (fp ? bad + 1 : bad)
//   fire  = bad > 10;  last = fire ? -1 : last;  bad = fire ? 0 : bad
// Outputs is_sync = real, is_fp = fp, is_resync = fire per window, and the
// lane's last / bad after its W windows.
//
// Replaces no Pallas kernel: the JAX package leaves the walk to XLA, as the
// jax.lax.scan of rtsdr_tpu/pipeline/frame.py::resolve_sync (scan_fn), which
// compiles into one device loop.  Eager PyTorch has no such loop: the plain
// version (pipeline/frame.py::_walk_plain) is W steps of about 18 stock ops,
// some 1,400 launches per block at W = 77, at any lane count.
//
// Bound on an H100: neither bytes (L*W*9 + 12*L: sid, the two flags and the
// three output flags per window, three integers in and two out per lane) nor
// operations, but the latency of the dependent chain bad -> bad (an add, two
// selects, a compare, a select) times W windows, and the one launch.  The
// windows of a lane are sequential; lanes are independent.
//
// Design: one thread per lane walks its W windows with last / bad in
// registers, over rows staged in shared memory.  A block takes kTile
// consecutive lanes, whose rows are one contiguous stretch of each (L, W)
// array: its 256 threads copy them in with coalesced loads (every load of
// the block in flight at once), kTile threads walk, and the flags go back
// out coalesced.  The first version read each window from global memory in
// the walking thread: a warp's reads were strided by W, each window waited
// on a load, and L = 1,024 took 29.5 us on an H100 (7.0 us at L = 1).
// Small tiles spread the lanes over the SMs (L = 1,024: 128 blocks).
// Integer arithmetic wraps as the plain version's int32 tensors do (done in
// unsigned: signed overflow is undefined in C++).  Flags are bytes, written
// 0 or 1 only, so the outputs compare equal to torch.bool tensors.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // copy in / out
constexpr int kTile = 8;        // lanes per block, walked by threads 0..7
// a tile's rows (sid, two input and three output flags) in 48 KB of
// shared memory: W <= 682 (ops/cuda_sync.py::MAX_WINDOWS)
constexpr int kMaxWindows = 48 * 1024 / (kTile * (int)(sizeof(int) + 5));

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// One lane's walk over its W windows (c NULL: no repairs).
__device__ __forceinline__ void walk(
    const int* __restrict__ s, const uint8_t* __restrict__ v,
    const uint8_t* __restrict__ c, uint8_t* __restrict__ o_sync,
    uint8_t* __restrict__ o_fp, uint8_t* __restrict__ o_fire, int base,
    int& last, int& bad, int w_max) {
#pragma unroll 4
  for (int w = 0; w < w_max; ++w) {
    const bool valid_w = v[w] != 0;
    const bool match = s[w] > 0 && valid_w;
    const bool repair = c != nullptr && c[w] != 0 && valid_w;
    const int gp = wrap_add(base, w);
    const bool on_lattice = wrap_sub(gp, last) == 26;
    const bool ok = last < 0 || on_lattice;
    const bool real = (match && ok) || (repair && last >= 0 && on_lattice);
    const bool fp = match && !ok;
    last = real ? gp : last;
    bad = real ? 0 : (fp ? wrap_add(bad, 1) : bad);
    const bool fire = bad > 10;
    last = fire ? -1 : last;
    bad = fire ? 0 : bad;
    o_sync[w] = real;
    o_fp[w] = fp;
    o_fire[w] = fire;
  }
}

__global__ void __launch_bounds__(kThreads)
sync_walk_kernel(const int* __restrict__ sid,
                 const uint8_t* __restrict__ valid,
                 const uint8_t* __restrict__ corr,   // NULL: no repairs
                 const int* __restrict__ base_pos,
                 const int* __restrict__ last_in,
                 const int* __restrict__ bad_in,
                 uint8_t* __restrict__ is_sync, uint8_t* __restrict__ is_fp,
                 uint8_t* __restrict__ is_resync,
                 int* __restrict__ last_out, int* __restrict__ bad_out,
                 int n_lanes, int w_max) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int l0 = blockIdx.x * kTile;
  const int n = min(kTile, n_lanes - l0);
  const int cells = n * w_max;
  const int cap = kTile * w_max;
  int* t_sid = reinterpret_cast<int*>(smem);
  uint8_t* t_valid = smem + sizeof(int) * cap;
  uint8_t* t_corr = t_valid + cap;
  uint8_t* t_sync = t_corr + cap;
  uint8_t* t_fp = t_sync + cap;
  uint8_t* t_fire = t_fp + cap;
  const size_t off = (size_t)l0 * (size_t)w_max;
#pragma unroll 4
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    t_sid[i] = sid[off + i];
    t_valid[i] = valid[off + i];
    if (corr != nullptr) t_corr[i] = corr[off + i];
  }
  __syncthreads();
  if (threadIdx.x < n) {
    const int lane = l0 + threadIdx.x;
    const int r = threadIdx.x * w_max;
    int last = last_in[lane];
    int bad = bad_in[lane];
    walk(t_sid + r, t_valid + r, corr != nullptr ? t_corr + r : nullptr,
         t_sync + r, t_fp + r, t_fire + r, base_pos[lane], last, bad, w_max);
    last_out[lane] = last;
    bad_out[lane] = bad;
  }
  __syncthreads();
#pragma unroll 4
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    is_sync[off + i] = t_sync[i];
    is_fp[off + i] = t_fp[i];
    is_resync[off + i] = t_fire[i];
  }
}

}  // namespace

// Shapes: sid (L, W) int32; valid, corr (or NULL) (L, W) bytes; base_pos,
// last_in, bad_in (L,) int32; is_sync, is_fp, is_resync (L, W) bytes;
// last_out, bad_out (L,) int32.  All contiguous, on the stream's device.
// W at most kMaxWindows.
extern "C" int rtsdr_sync_walk(const void* sid, const void* valid,
                               const void* corr, const void* base_pos,
                               const void* last_in, const void* bad_in,
                               void* is_sync, void* is_fp, void* is_resync,
                               void* last_out, void* bad_out, int n_lanes,
                               int w_max, void* stream) {
  if (n_lanes <= 0 || w_max <= 0 || w_max > kMaxWindows)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n_lanes + kTile - 1) / kTile;
  const size_t smem = (size_t)kTile * w_max * (sizeof(int) + 5);
  sync_walk_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)sid, (const uint8_t*)valid, (const uint8_t*)corr,
      (const int*)base_pos, (const int*)last_in, (const int*)bad_in,
      (uint8_t*)is_sync, (uint8_t*)is_fp, (uint8_t*)is_resync,
      (int*)last_out, (int*)bad_out, n_lanes, w_max);
  return (int)cudaGetLastError();
}
