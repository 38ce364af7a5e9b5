"""Critically-sampled polyphase filter-bank (PFB) channelizer.

Counterpart of ``rtsdr_tpu/ops/channelizer.py``: split one wideband IQ
capture into K frequency channels, each downconverted to complex baseband
and decimated by K — the K-station front door for the batched receiver.

Math.  Channel k = ``decimate_K(LPF(x[t] * exp(-2j*pi*k*t/K)))`` with a
shared prototype low-pass ``h``.  Substituting n = j*K + p gives the
polyphase form

    y[m, k] = sum_p exp(+2j*pi*k*p/K) * u_p[m]
    u_p[m]  = sum_j h[j*K + p] * x[m*K - p - j*K]

i.e. per-phase FIR over the decimated phase planes followed by a length-K
inverse DFT across phases — ``K * ifft(u, axis=phase)``.

Three routes, as in the reference:

  * ``pfb_channelize``       complex phase planes + ``torch.fft.ifft`` (any
    length, complex64 / complex128: the oracle path);
  * ``pfb_channelize_u8``    the same bank as ONE banded matrix product over
    the raw interleaved bytes (stock ops: windows + ``torch.matmul`` in
    float32, as the reference leaves it to its compiler);
  * ``composed_channelize_u8``  channelizer ∘ per-station RF low-pass ↓decim
    as one complex decimate-by-``decim*K`` FIR bank straight from the bytes:
    on a CUDA tensor the hand-written kernel ``csrc/channelizer.cu``
    (launch or raise), on a CPU tensor the plain version beside it
    (``composed_channelize_u8_ref``: windows + ``torch.matmul``), which is
    also what the kernel is compared with on the card.

Streaming: the carried state is the input tail (complex samples, or raw
bytes where 128 stands for 0), so chained blocks equal one long call.

Spans: each call of ``pfb_channelize_u8`` and ``composed_channelize_u8`` is
one ``rtsdr.channelize`` span of ``utils/trace.py`` (``route``,
``captures``, ``slots``, ``shared`` and ``own``: the stations on the
shared prototype and on their own taps, ``taps``: the bank's length), on
an eager call and at a compiled step's capture; a replayed graph runs no
span.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from rtsdr_tpu_torch.ops import _cuda
from rtsdr_tpu_torch.ops.coeffs import lowpass_taps
from rtsdr_tpu_torch.ops.fir import derived_from
from rtsdr_tpu_torch.utils.trace import annotate


def channelizer_taps(n_channels: int, taps_per_branch: int = 16,
                     cutoff_frac: float = 0.45) -> np.ndarray:
    """Prototype low-pass for a K-channel PFB.

    cutoff = cutoff_frac * (fs / K): 0.45 leaves a guard band between
    adjacent 1/K-wide slots; the per-station RF LPF downstream does the
    tight selectivity.
    """
    k = n_channels
    taps = taps_per_branch * k
    return lowpass_taps(1.0, cutoff_frac / k, taps)


def _tail_len(n_channels: int, taps: int) -> int:
    t = -(-taps // n_channels)  # taps per branch (ceil)
    return t * n_channels + n_channels - 1


def channelizer_zi(n_channels: int, taps: int, batch_shape: tuple = (),
                   dtype=torch.complex64, device="cuda") -> torch.Tensor:
    """Zero initial state: the carried input tail."""
    return torch.zeros((*batch_shape, _tail_len(n_channels, taps)),
                       dtype=dtype, device=device)


def _padded_proto(h, k: int) -> tuple[np.ndarray, int]:
    """The prototype padded to a whole number of branches, and that number."""
    h64 = np.asarray(h, np.float64)
    t = -(-h64.shape[0] // k)
    if h64.shape[0] < t * k:
        h64 = np.pad(h64, (0, t * k - h64.shape[0]))
    return h64, t


def pfb_channelize(x: torch.Tensor, h, zi: torch.Tensor, n_channels: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Channelize complex x (..., N) -> (..., M, K), M = N/K.

    Output m, k is exactly ``sum_n h[n] x_ext[L + m*K - n] * W(k, n)``
    with W the downconversion twiddle — equal to mix->lfilter->[::K] of
    the concatenated stream (lfilter alignment: output sample m
    corresponds to input index m*K).
    """
    k = n_channels
    h64, t = _padded_proto(h, k)
    n = x.shape[-1]
    if n % k:
        raise ValueError(
            f"pfb_channelize: block length {n} does not divide by {k}")
    m_out = n // k
    batch = x.shape[:-1]
    l_zi = t * k + k - 1
    if zi.shape[-1] != l_zi:
        raise ValueError(f"zi: expected (..., {l_zi}), got {tuple(zi.shape)}")

    x_ext = torch.cat([zi.to(x.dtype), x], dim=-1)
    # Phase planes v[r, p] = x_ext[(r+2)K - 1 - p]: one reshape + flip.
    # The base offset K keeps output m on the K-grid of the stream:
    # u[m, p] below reads x_ext[a + (m+t-1)K - n] with a = 2K-1, and
    # stream position = that - len(zi) = m*K - n.
    rows = (x_ext.shape[-1] - k) // k
    v = x_ext[..., k:k + rows * k].reshape(*batch, rows, k).flip(-1)
    # u[m, p] = sum_j h[jK + p] v[m + t - 1 - j, p]
    real = torch.float64 if x.dtype == torch.complex128 else torch.float32
    h_b = torch.as_tensor(h64.reshape(t, k), dtype=real, device=x.device)
    u = torch.zeros((*batch, m_out, k), dtype=x.dtype, device=x.device)
    for j in range(t):
        u = u + v[..., t - 1 - j: t - 1 - j + m_out, :] * h_b[j]
    y = k * torch.fft.ifft(u, dim=-1)
    return y.to(x.dtype), x_ext[..., -l_zi:].to(zi.dtype)


def channelizer_zi_u8(n_channels: int, taps: int, batch_shape: tuple = (),
                      device="cuda") -> torch.Tensor:
    """Zero initial state for the raw-byte path: value-128 bytes
    (normalize to 0 — equal to the complex path's zero tail)."""
    return torch.full((*batch_shape, 2 * _tail_len(n_channels, taps)), 128,
                      dtype=torch.uint8, device=device)


def _normalize(b: torch.Tensor) -> torch.Tensor:
    return (b.to(torch.float32) - 128.0) * (1.0 / 128.0)


def _banded_matrix(c: np.ndarray, o: np.ndarray, span_b: int) -> np.ndarray:
    """(span_b, K*2*block) byte-domain matrix of a complex FIR bank.

    ``c``: (K, T) complex taps; ``o``: (block, T) complex window offset that
    output i of a block reads for tap t (bijective in t per column).  Column
    (ch, quad, i):  y_re = sum re(c)*x_re - im(c)*x_im,
                    y_im = sum im(c)*x_re + re(c)*x_im.
    """
    k = c.shape[0]
    block = o.shape[0]
    i_idx = np.arange(block)[:, None]
    h_mat = np.zeros((span_b, block * k * 2), np.float64)
    rs = 2 * o.ravel()
    for ch in range(k):
        cr = np.broadcast_to(c[ch].real, o.shape).ravel()
        ci = np.broadcast_to(c[ch].imag, o.shape).ravel()
        col = np.broadcast_to(ch * 2 * block + i_idx, o.shape).ravel()
        h_mat[rs, col] = cr
        h_mat[rs + 1, col] = -ci
        h_mat[rs, col + block] = ci
        h_mat[rs + 1, col + block] = cr
    return h_mat


def _derived_from(taps: np.ndarray, key, build, device) -> torch.Tensor:
    """float32 tensor on ``device`` that ``build()`` derives from the host
    array ``taps``, made once per (array, key, device)."""
    # C order whatever order build() left: a kernel reads the memory
    return derived_from(
        taps, (*key, str(device)),
        lambda: torch.as_tensor(
            np.ascontiguousarray(build(), dtype=np.float32)).to(device))


def _windows_matmul(x_ext: torch.Tensor, h_mat: torch.Tensor, nblk: int,
                    stride_b: int, k: int, block: int) -> torch.Tensor:
    """Row r of the operand is the normalized byte window starting at
    r*stride_b (h_mat.shape[0] long); returns (..., K, 2, nblk*block)."""
    batch = x_ext.shape[:-1]
    span_b = h_mat.shape[0]
    need = (nblk - 1) * stride_b + span_b
    pad_n = need - x_ext.shape[-1]
    if pad_n > 0:       # value 128 -> 0; meets zero matrix entries anyway
        x_ext = torch.cat([x_ext, torch.full(
            (*batch, pad_n), 128, dtype=torch.uint8, device=x_ext.device)],
            dim=-1)
    windows = _normalize(x_ext[..., :need]).unfold(-1, span_b, stride_b)
    y = torch.matmul(windows, h_mat)              # (..., nblk, K*2*block)
    y = y.reshape(*batch, nblk, k, 2, block)
    y = torch.movedim(y, -4, -2)                  # (..., K, 2, nblk, block)
    return y.reshape(*batch, k, 2, nblk * block)


def pfb_channelize_u8(raw_u8: torch.Tensor, h, zi_raw: torch.Tensor,
                      n_channels: int, block: int = 16
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """K-channel PFB straight from interleaved uint8 IQ bytes.

    The mix + prototype LPF + decimate-by-K for ALL K channels and both
    quadratures is ONE banded matrix product over the raw byte stream: the
    length-K inverse DFT across polyphase branches folds into the filter
    matrix (channel k's complex taps are h[n]*exp(2j*pi*n*k/K)).
    Output-equivalent to normalize -> complex -> ``pfb_channelize``
    (float32 rounding only).  Stock tensor ops in float32 (no kernel of its
    own in either package).

    raw_u8: (..., 2*N) interleaved IQ; zi_raw: (..., 2*(t*K + K - 1))
    carried byte tail (start from ``channelizer_zi_u8``).  Returns
    ((..., K, 2, M) float32 stacked I/Q at the channel rate — the
    receivers' 'iq' frontend input — and the new byte tail).
    """
    with annotate("rtsdr.channelize", route="pfb") as span:
        if span:
            span.add(captures=math.prod(raw_u8.shape[:-1]),
                     slots=n_channels, shared=n_channels, own=0,
                     taps=len(h))
        return _pfb_channelize_u8(raw_u8, h, zi_raw, n_channels, block)


def _pfb_channelize_u8(raw_u8, h, zi_raw, n_channels: int, block: int):
    k = n_channels
    h64, t = _padded_proto(h, k)
    l_zi = t * k + k - 1
    if zi_raw.shape[-1] != 2 * l_zi:
        raise ValueError(
            f"zi_raw: expected (..., {2 * l_zi}), got {tuple(zi_raw.shape)}")
    n = raw_u8.shape[-1] // 2
    if n % k or (n // k) % block:
        raise ValueError(
            f"pfb_channelize_u8: {n} samples are not whole blocks of "
            f"{block} outputs x {k} channels (use pfb_channelize)")
    if n < l_zi:
        raise ValueError("pfb_channelize_u8: block shorter than its tail")
    m_out = n // k
    span_b = 2 * k * (block - 1 + t)
    stride_b = 2 * k * block

    def build():
        # output i of a block, channel ch, reads complex index
        # (i+t)*K - 1 - n_tap relative to the block's window
        n_idx = np.arange(t * k)
        c = np.stack([h64 * np.exp(2j * np.pi * n_idx * ch / k)
                      for ch in range(k)])
        o = (np.arange(block)[:, None] + t) * k - 1 - n_idx[None, :]
        return _banded_matrix(c, o, span_b)

    h_mat = _derived_from(h, ("pfb", k, block), build, raw_u8.device)
    # windows[s] = x_ext[2k + s*stride : + span]
    x_ext = torch.cat([zi_raw, raw_u8], dim=-1)[..., 2 * k:]
    y = _windows_matmul(x_ext, h_mat, m_out // block, stride_b, k, block)
    return y, raw_u8[..., -2 * l_zi:].contiguous()


def composed_rf_taps(n_channels: int, h_proto, h_rf, decim: int,
                     offsets_hz=None, fs_ch: float | None = None
                     ) -> np.ndarray:
    """Compose channelizer slot k + the per-station RF decimating LPF
    into one complex FIR per station, straight at the wideband rate.

    Both stages are LTI decimating FIRs, so the cascade
    ``decimate_10(h_rf * decimate_K(h_ch^(k) * x))`` is EXACTLY one
    decimate-by-``10K`` FIR with taps

        g_k[t] = sum_j h_rf[j] * h_ch^(k)[t - j*K],
        h_ch^(k)[n] = h_ch[n] * exp(2j*pi*k*n/K)

    (i.e. ``conv(upsample_K(h_rf), h_ch^(k))``).

    ``offsets_hz`` (length K, off-grid stations): mixing between the
    stages commutes into the composition exactly —
    ``mix(theta) -> h_rf`` equals ``(h_rf[j] * exp(-1j*step*j)) ->
    post-mix exp(1j*theta(decim*p))`` — so the residual NCO moves to
    the IF rate; apply the post-mix with
    ``step_k = -2*pi*offsets_hz[k]/fs_ch`` per IF sample times ``decim``
    (see pipeline/wideband.py).

    Returns (K, L) complex128, L = (len(h_rf)-1)*K + len(h_ch_padded).
    """
    k = n_channels
    h64, t = _padded_proto(h_proto, k)
    h_rf = np.asarray(h_rf, np.float64)
    j_idx = np.arange(len(h_rf), dtype=np.float64)
    n_idx = np.arange(t * k, dtype=np.float64)
    g = []
    for ch in range(k):
        h_rf_k = h_rf.astype(np.complex128)
        if offsets_hz is not None and offsets_hz[ch]:
            if fs_ch is None:
                raise ValueError("offsets_hz needs fs_ch")
            step = -2.0 * np.pi * float(offsets_hz[ch]) / fs_ch
            h_rf_k = h_rf_k * np.exp(-1j * step * j_idx)
        up = np.zeros(((len(h_rf) - 1) * k + 1), np.complex128)
        up[::k] = h_rf_k
        h_chk = h64 * np.exp(2j * np.pi * n_idx * ch / k)
        g.append(np.convolve(up, h_chk))
    return np.stack(g)


def composed_zi_u8(g_len: int, batch_shape: tuple = (), device="cuda"
                   ) -> torch.Tensor:
    """Zero history for the composed path: value-128 bytes for the last
    L-1 complex wideband samples."""
    return torch.full((*batch_shape, 2 * (g_len - 1)), 128,
                      dtype=torch.uint8, device=device)


def _new_tail(raw_u8: torch.Tensor, zi_raw: torch.Tensor) -> torch.Tensor:
    """The last ``zi_raw.shape[-1]`` bytes of [zi_raw | raw_u8]."""
    nz = zi_raw.shape[-1]
    if raw_u8.shape[-1] >= nz:
        return raw_u8[..., -nz:].contiguous()
    return torch.cat([zi_raw, raw_u8], dim=-1)[..., -nz:].contiguous()


def composed_channelize_u8_ref(raw_u8: torch.Tensor, g: np.ndarray,
                               zi_raw: torch.Tensor, decim: int,
                               block: int = 16
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``composed_channelize_u8`` (any device):
    the normalized byte windows of ``block`` outputs each against the
    banded byte-domain matrix of ``g``, in float32.  A ragged P is padded
    to whole blocks and sliced."""
    k, g_l = g.shape
    d = decim * k                       # complex samples per output
    _check_composed(raw_u8, g, zi_raw, d)
    p_out = raw_u8.shape[-1] // 2 // d
    nblk = -(-p_out // block)
    span_b = 2 * (d * (block - 1) + g_l)

    def build():
        # output i reads complex window offset o = d*i + (L-1) - t for tap t
        o = (d * np.arange(block)[:, None] + (g_l - 1)
             - np.arange(g_l)[None, :])
        return _banded_matrix(g, o, span_b)

    h_mat = _derived_from(g, ("composed", d, block), build, raw_u8.device)
    x_ext = torch.cat([zi_raw, raw_u8], dim=-1)
    y = _windows_matmul(x_ext, h_mat, nblk, 2 * d * block, k, block)
    return y[..., :p_out].contiguous(), _new_tail(raw_u8, zi_raw)


def _check_composed(raw_u8, g, zi_raw, d: int) -> None:
    g_l = g.shape[1]
    if raw_u8.dtype != torch.uint8 or zi_raw.dtype != torch.uint8:
        raise TypeError(
            f"composed_channelize_u8: expected uint8 bytes, got "
            f"{raw_u8.dtype} / {zi_raw.dtype}")
    if raw_u8.dim() < 1 or raw_u8.shape[-1] < 2 * d \
            or raw_u8.shape[-1] % (2 * d):
        raise ValueError(
            f"raw_u8: {tuple(raw_u8.shape)} is not a whole number of "
            f"{d}-pair decimation groups")
    want = (*raw_u8.shape[:-1], 2 * (g_l - 1))
    if tuple(zi_raw.shape) != want:
        raise ValueError(
            f"zi_raw: expected {want}, got {tuple(zi_raw.shape)}")


#: the kernel's compiled-in taps per polyphase plane (K = 8, 16, 32 at
#: decim 10 with 16 taps per branch and the 151-tap RF filter all give 17)
FIXED_TAPS_PER_PLANE = 17
#: outputs per thread, threads per block, shared memory of a block that
#: leaves room for two per SM (227 KB of an H100 SM)
K5_R, K5_THREADS, K5_SMEM = 8, 256, 113 * 1024
_K5_TAP_BUFFER = 16 * 1024        # taps of one sub-step, at most
_K5_TILES = (64, 32, 16, 8)
#: a station shares the prototype when its de-rotated taps are within this
#: of the prototype's, and real within it too (relative to max |c|)
SHARED_MATCH_REL = 1e-9


@dataclasses.dataclass(frozen=True)
class ComposedPlan:
    """What ``composed_channelize_u8`` hands its kernel for one ``g``.

    With c_k[t] = g_k[t] * exp(-2j*pi*k*t/K) and d = decim*K, a station
    whose c_k is one real prototype c shared with others (every station
    without a residual offset) is

        y_k[p] = sum_{r<K} W^{k*r} u_r[p],   W = exp(2j*pi/K),
        u_r[p] = sum_{b = r mod K, b < d} sum_{a<A} c[d*a + b] * plane_b[p-a]

    with plane_b[q] = X[d*q - b] (d divides by K, so W^{k*t} = W^{k*b}):
    d real A-tap FIRs over the polyphase planes, summed by residue, then a
    K-point DFT per output, for all such stations at once.  Every other
    station is an "own-taps" station: its complex taps, plane by plane.
    """

    k: int
    taps: int
    decim: int
    a_sp: int                 # taps per plane as the kernel walks them
    shared: tuple             # stations on the shared prototype
    own: tuple                # stations with their own taps
    proto: np.ndarray | None  # (d, a_sp | 1) f32: c[d*a + b] / 128 at [b, a]
    twiddle: np.ndarray       # (K, 2) float32: W^m = cos / sin(2 pi m / K)
    own_taps: np.ndarray | None   # (d, a_sp, n_own, 2) float32, g / 128

    @property
    def d(self) -> int:
        return self.decim * self.k


def _derotated(g: np.ndarray) -> np.ndarray:
    """c_k[t] = g_k[t] * exp(-2j*pi*k*t/K), in float64 (the angle reduced
    mod K exactly in integers)."""
    k, g_l = g.shape
    kt = (np.arange(k)[:, None] * np.arange(g_l)[None, :]) % k
    return g * np.exp(-2j * np.pi * kt / k)


def _planes_of(taps: np.ndarray, d: int, a_sp: int) -> np.ndarray:
    """(..., L) -> (..., d, a_sp): tap d*a + b at [b, a], zeros past L."""
    pad = np.zeros((*taps.shape[:-1], d * a_sp), taps.dtype)
    pad[..., :taps.shape[-1]] = taps
    return np.swapaxes(pad.reshape(*taps.shape[:-1], a_sp, d), -1, -2)


def composed_plan(g: np.ndarray, decim: int) -> ComposedPlan:
    """The station-by-station route of ``composed_channelize_u8`` for the
    (K, L) taps ``g``, made once per array (``g`` must not change once
    passed).  A station takes the shared route when its de-rotated taps
    are real and equal those of the largest group of such stations, both
    within ``SHARED_MATCH_REL * max|c|``; every other station takes its
    own taps.  The kernel's shared role needs K <= 256 (a thread per
    residue and group of outputs): a larger K puts every station on its
    own taps."""
    return derived_from(g, ("composed_plan", decim),
                        lambda: _build_plan(np.asarray(g), decim))


def _build_plan(g: np.ndarray, decim: int) -> ComposedPlan:
    k, g_l = g.shape
    d = decim * k
    a = -(-g_l // d)
    a_sp = a if a == FIXED_TAPS_PER_PLANE else -(-a // 4) * 4
    c = _derotated(np.asarray(g, np.complex128))
    lim = SHARED_MATCH_REL * float(np.abs(c).max())
    shared = ()
    real = np.flatnonzero(np.abs(c.imag).max(axis=1) <= lim)
    if k <= K5_THREADS and real.size:
        cr = c.real[real]
        near = np.stack([np.abs(cr - row).max(axis=1) <= lim for row in cr])
        shared = tuple(int(j) for j in real[near[np.argmax(near.sum(1))]])
    own = tuple(j for j in range(k) if j not in shared)
    proto = None
    if shared:
        proto = np.zeros((d, a_sp | 1), np.float32)      # odd pitch
        proto[:, :a_sp] = _planes_of(c[shared[0]].real / 128.0, d, a_sp)
    # W^{k r} = W^{(k r) mod K}: the K-entry table, float64 rounded once
    ang = 2.0 * np.pi * np.arange(k) / k
    twiddle = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    own_taps = None
    if own:
        gp = _planes_of(g[list(own)] / 128.0, d, a_sp)     # (n_own, d, a_sp)
        gp = np.moveaxis(gp, 0, -1)                        # (d, a_sp, n_own)
        own_taps = np.stack([gp.real, gp.imag], -1).astype(np.float32)
    return ComposedPlan(k, g_l, decim, a_sp, shared, own, proto, twiddle,
                        own_taps)


@dataclasses.dataclass(frozen=True)
class ComposedGeometry:
    """How one launch cuts the work: tiles of ``tile`` outputs (grid x:
    capture and tile); grid y: ``n_og`` own-taps groups of ``own_lanes``
    stations, then the shared role if any.  A block stages its tile's
    byte window as polyphase planes, ``nb`` planes per pass (``pitch``
    rows each); a thread owns R outputs of one lane and one slice of the
    planes (the shared role: K residues; the own role: ``ns_own`` slices)
    and walks them ``g_sh`` / ``g_own`` planes per sub-step, whose taps
    are staged first.  The shared role's ``ns_sh`` slices are K residues
    times the splits of each residue's planes that fill the block."""

    tile: int
    n_tiles: int
    nb: int
    pitch: int
    own_lanes: int
    n_og: int
    ns_sh: int
    ns_own: int
    g_sh: int
    g_own: int
    plane_elems: int          # float2 slots before the tap buffer
    smem: int                 # bytes of dynamic shared memory
    shared_role: bool

    @property
    def roles(self) -> int:
        return self.n_og + self.shared_role


def composed_geometry(plan: ComposedPlan, n_cap: int, p_out: int,
                      n_sm: int = 132) -> ComposedGeometry:
    """The widest tile whose planes fit one pass and whose grid gives two
    blocks per SM; else the widest that fits one pass; else the narrowest,
    with the planes staged in several passes."""
    k, d, a_sp = plan.k, plan.d, plan.a_sp
    n_sh, n_own = len(plan.shared), len(plan.own)
    own_lanes = 0
    if n_own:
        own_lanes = 1
        while own_lanes < min(n_own, 16):
            own_lanes *= 2
    n_og = -(-n_own // own_lanes) if n_own else 0
    tpitch = a_sp | 1
    options = []
    for tile in _K5_TILES:
        groups = tile // K5_R
        if n_sh and k * groups > K5_THREADS:
            continue
        ns_sh = k * max(1, K5_THREADS // (k * groups))
        ns_own = max(1, K5_THREADS // (own_lanes * groups)) if n_own else 1
        pitch = (tile + a_sp - 1) | 1
        part = max(ns_sh if n_sh else 0, ns_own * own_lanes) * (tile + 1)
        # taps of one sub-step: the shared role ns_sh planes (real), the own
        # role ns_own planes (complex, own_lanes stations) at least
        sh_b, own_b = 4 * ns_sh * tpitch, 8 * ns_own * a_sp * own_lanes
        nb = min(d, (K5_SMEM - max(sh_b if n_sh else 0, own_b)) // (8 * pitch))
        plane_elems = max(nb * pitch, part)
        left = min(K5_SMEM - 8 * plane_elems, _K5_TAP_BUFFER)
        if nb < 1 or left < (sh_b if n_sh else own_b):
            continue
        g_sh = min(d, ns_sh * max(1, left // sh_b))
        g_own = min(d, ns_own * max(1, left // max(own_b, 1)))
        taps_b = max(4 * g_sh * tpitch if n_sh else 0,
                     8 * g_own * a_sp * own_lanes)
        n_tiles = -(-p_out // tile)
        geo = ComposedGeometry(tile, n_tiles, nb, pitch, own_lanes, n_og,
                               ns_sh, ns_own, g_sh, g_own, plane_elems,
                               8 * plane_elems + taps_b, bool(n_sh))
        options.append(geo)
        if nb == d and n_cap * n_tiles * geo.roles >= 2 * n_sm:
            return options[-1]
    if not options:
        raise ValueError(
            f"composed_channelize_u8: {a_sp} taps per plane do not fit the "
            "kernel's window")
    whole = [o for o in options if o.nb == d]
    return whole[0] if whole else options[-1]


_n_sm: dict = {}


def _sm_count(dev) -> int:
    if dev not in _n_sm:
        _n_sm[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _n_sm[dev]


def composed_channelize_u8(raw_u8: torch.Tensor, g: np.ndarray,
                           zi_raw: torch.Tensor, decim: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """K stations' channelizer + RF front-end LPF + decimate as ONE complex
    FIR bank over the raw wideband bytes.

    ``g``: (K, L) complex taps from ``composed_rf_taps`` (host numpy; not
    to be modified once passed).  Output p of station ch is
    ``sum_t g[ch, t] * X[decim*K*p - t]`` with X the normalized complex
    stream ``((I-128) + j(Q-128))/128`` — the same recurrence as channelize
    -> ``ops.fir.fir_decimate`` in exact arithmetic.

    raw_u8: (..., 2*N) interleaved uint8 at ``fs_w = K*fs``, N a multiple
    of ``decim*K``; zi_raw: (..., 2*(L-1)) carried byte tail (start from
    ``composed_zi_u8``).  Returns ((..., K, 2, P) float32 decimated station
    I/Q at the IF rate, P = N/(decim*K), and the new byte tail) — feed
    receivers built with ``frontend_impl='if'``.  Any K, L and P are taken.

    A CUDA tensor launches the kernel (``csrc/channelizer.cu``) or raises;
    the route of each station (shared prototype + in-kernel DFT, or its
    own taps) is chosen on the host from ``g`` alone (``composed_plan``).
    A CPU tensor runs ``composed_channelize_u8_ref``.
    """
    with annotate("rtsdr.channelize", route="composed") as span:
        if span:
            plan = composed_plan(g, decim)
            span.add(captures=math.prod(raw_u8.shape[:-1]), slots=g.shape[0],
                     shared=len(plan.shared), own=len(plan.own),
                     taps=g.shape[1])
        return _composed_channelize_u8(raw_u8, g, zi_raw, decim)


def _composed_channelize_u8(raw_u8, g, zi_raw, decim: int):
    if not raw_u8.is_cuda:
        return composed_channelize_u8_ref(raw_u8, g, zi_raw, decim)
    k, g_l = g.shape
    d = decim * k
    _check_composed(raw_u8, g, zi_raw, d)
    dev = raw_u8.device
    _cuda.check(raw_u8, "raw_u8", dtype=torch.uint8)
    _cuda.check(zi_raw, "zi_raw", dtype=torch.uint8, device=dev)
    if raw_u8.data_ptr() % 2 or zi_raw.data_ptr() % 2:
        raise ValueError("raw_u8 / zi_raw: must start at an even address")
    lead = tuple(raw_u8.shape[:-1])
    n = raw_u8.shape[-1] // 2
    p_out = n // d
    plan = composed_plan(g, decim)
    n_sm = _sm_count(dev)
    geo = derived_from(
        g, ("composed_geometry", decim, math.prod(lead), p_out, n_sm),
        lambda: composed_geometry(plan, math.prod(lead), p_out, n_sm))
    y = torch.empty((*lead, k, 2, p_out), dtype=torch.float32, device=dev)
    new_zi = torch.empty_like(zi_raw)
    on = _plan_on(g, plan, dev)
    _cuda.launch(
        "rtsdr_channelize_composed", "channelizer.composed",
        _cuda.ptr(raw_u8), _cuda.ptr(zi_raw), *map(_cuda.ptr, on),
        _cuda.ptr(y), _cuda.ptr(new_zi), math.prod(lead), n, k, g_l, d,
        plan.a_sp, p_out, geo.tile, geo.n_tiles, geo.nb, geo.pitch,
        len(plan.shared), len(plan.own), geo.own_lanes, geo.n_og, geo.ns_sh,
        geo.ns_own, geo.g_sh, geo.g_own, geo.plane_elems, geo.smem)
    return y, new_zi


def _plan_on(g: np.ndarray, plan: ComposedPlan, dev) -> tuple:
    """The plan's arrays on ``dev`` (made once per ``g`` and device): the
    prototype planes, the twiddles, the shared stations, the own taps, the
    own stations (None where a route has no station)."""
    def build():
        def f32(a):
            return None if a is None else torch.as_tensor(
                np.ascontiguousarray(a, np.float32)).to(dev)

        def i32(a):
            return None if not a else torch.as_tensor(
                np.asarray(a, np.int32)).to(dev)
        return (f32(plan.proto), f32(plan.twiddle), i32(plan.shared),
                f32(plan.own_taps), i32(plan.own))

    return derived_from(g, ("composed_plan_on", plan.decim, str(dev)), build)


def channel_center_freqs(n_channels: int, fs: float) -> np.ndarray:
    """Center frequency of each output channel (Hz), wrapped to +-fs/2."""
    k = np.arange(n_channels)
    f = k * fs / n_channels
    return np.where(f >= fs / 2, f - fs, f)
