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
    as one complex decimate-by-``decim*K`` FIR bank straight from the bytes
    (or, given the bank's factors and where it is less work, as the slot
    bank then each station's RF FIR, in one launch):
    on a CUDA tensor the hand-written kernel ``csrc/channelizer.cu``
    (launch or raise), on a CPU tensor the plain version beside it
    (``composed_channelize_u8_ref``: windows + ``torch.matmul``), which is
    also what the kernel is compared with on the card.

Stations and slots: by default station k is slot k (S = K).  A
``StationMap`` (``station_map``) puts S stations over the K slots, several
a slot where the band is dense: ``pfb_channelize_u8`` then gives each
station its slot's row, and the composed bank has one row of taps a
station (its slot's band-pass and its own RF filter), which the kernel
runs in its two-stage role (the slot bank once a capture, then each
station's RF FIR).

Streaming: the carried state is the input tail (complex samples, or raw
bytes where 128 stands for 0), so chained blocks equal one long call.

Spans: each call of ``pfb_channelize_u8`` and ``composed_channelize_u8`` is
one ``rtsdr.channelize`` span of ``utils/trace.py`` (``route``,
``captures``, ``slots``, ``shared``, ``own`` and ``two_stage``: the
stations on the shared prototype, on their own taps and on the two-stage
role, ``taps``: the bank's length, ``stations``: S, ``per_slot``: the most
stations any slot carries, ``mix``: the stations whose residual NCO the
two-stage role turns in its epilogue, S or 0), on an eager call and at a
compiled step's capture; a replayed graph runs no span.

The residual NCO.  A station off its slot's centre leaves the bank still
turning at its offset; ``residual_mix`` turns it back in stock ops, and
``composed_channelize_u8(..., mix=(phase, ramp))`` returns its outputs so
turned: inside the kernel's two-stage role on a CUDA tensor, by
``residual_mix`` after the bank on every other route.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from rtsdr_tpu_torch.ops import _cuda
from rtsdr_tpu_torch.ops.coeffs import lowpass_taps
from rtsdr_tpu_torch.ops.fir import derived_from, derived_from_list
from rtsdr_tpu_torch.utils.trace import annotate


class StationMap(NamedTuple):
    """S stations over the K slots of a capture: station j decodes slot
    ``slot_of[j]``.  Made by ``station_map``; where a function takes
    ``stations=None``, station k is slot k (S = K)."""

    k: int
    slot_of: tuple

    @property
    def stations(self) -> int:
        return len(self.slot_of)

    @property
    def per_slot(self) -> int:
        """The most stations any slot carries."""
        return max(collections.Counter(self.slot_of).values())


def station_map(n_slots: int, slot_of) -> StationMap | None:
    """The ``StationMap`` of stations in slots ``slot_of`` (each in
    ``[0, n_slots)``, at least one station); None where it is one station
    a slot in slot order, which every function takes as its default."""
    slots = tuple(int(c) for c in slot_of)
    if not slots or any(c < 0 or c >= n_slots for c in slots):
        raise ValueError(f"slot_of: each station's slot in [0, {n_slots}), "
                         f"got {list(slot_of)}")
    if slots == tuple(range(n_slots)):
        return None
    return StationMap(n_slots, slots)


def _span_stations(k: int, stations: StationMap | None) -> dict:
    """The span attributes ``stations`` and ``per_slot``."""
    if stations is None:
        return {"stations": k, "per_slot": 1}
    return {"stations": stations.stations, "per_slot": stations.per_slot}


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
                      n_channels: int, block: int = 16,
                      stations: StationMap | None = None
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
    receivers' 'iq' frontend input — and the new byte tail).  With
    ``stations``, the output holds each station's slot: (..., S, 2, M).
    """
    with annotate("rtsdr.channelize", route="pfb") as span:
        if span:
            span.add(captures=math.prod(raw_u8.shape[:-1]),
                     slots=n_channels, shared=n_channels, own=0,
                     two_stage=0, taps=len(h), mix=0,
                     **_span_stations(n_channels, stations))
        y, zi = _pfb_channelize_u8(raw_u8, h, zi_raw, n_channels, block)
        if stations is not None:
            y = y.index_select(-3, _slot_index(stations, y.device))
        return y, zi


def _slot_index(stations: StationMap, device) -> torch.Tensor:
    """Each station's slot as an int64 tensor on ``device`` (made once)."""
    key = (stations, str(device))
    if key not in _slot_indices:
        _slot_indices[key] = torch.as_tensor(stations.slot_of,
                                             dtype=torch.int64).to(device)
    return _slot_indices[key]


_slot_indices: dict = {}


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
    return composed_rf_factors(n_channels, h_proto, h_rf, decim, offsets_hz,
                               fs_ch)[0]


def composed_rf_factors(n_channels: int, h_proto, h_rf, decim: int,
                        offsets_hz=None, fs_ch: float | None = None,
                        stations: StationMap | None = None
                        ) -> tuple[np.ndarray, tuple]:
    """``composed_rf_taps``' g and the factors it is composed of:
    ``(g, (h_ch, f))``, h_ch the prototype padded to whole branches
    (float64, length K * taps per branch) and f (S, len(h_rf)) complex128
    each station's RF taps turned to its offset, ``f_j[i] = h_rf[i] *
    exp(-1j*step_j*i)``; ``g_j = conv(upsample_K(f_j), h_ch^(slot_j))``.
    The factors let ``composed_channelize_u8`` run the two stages apart.

    ``stations``: S stations over the K slots; station j takes slot
    ``slot_of[j]``'s band-pass and ``offsets_hz[j]`` (length S); by
    default station k is slot k."""
    k = n_channels
    slot_of = _slots(k, stations)
    h64, t = _padded_proto(h_proto, k)
    h_rf = np.asarray(h_rf, np.float64)
    j_idx = np.arange(len(h_rf), dtype=np.float64)
    f = np.empty((len(slot_of), len(h_rf)), np.complex128)
    for j in range(len(slot_of)):
        f[j] = h_rf
        if offsets_hz is not None and offsets_hz[j]:
            if fs_ch is None:
                raise ValueError("offsets_hz needs fs_ch")
            step = -2.0 * np.pi * float(offsets_hz[j]) / fs_ch
            f[j] = f[j] * np.exp(-1j * step * j_idx)
    return _compose(h64, f, k, slot_of), (h64, f)


def _slots(k: int, stations: StationMap | None) -> tuple:
    """Each station's slot: ``stations.slot_of``, or slot k for station k."""
    if stations is None:
        return tuple(range(k))
    if stations.k != k:
        raise ValueError(f"stations: a map over {stations.k} slots, not {k}")
    return stations.slot_of


def _compose(h64: np.ndarray, f: np.ndarray, k: int, slot_of=None
             ) -> np.ndarray:
    """g_j = conv(upsample_K(f_j), h_ch^(slot_j)): (S, (l_rf-1)*K +
    len(h64)); station j in slot j where ``slot_of`` is None."""
    n_idx = np.arange(len(h64), dtype=np.float64)
    g = []
    for j in range(f.shape[0]):
        ch = j if slot_of is None else slot_of[j]
        up = np.zeros(((f.shape[1] - 1) * k + 1), np.complex128)
        up[::k] = f[j]
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
                               block: int = 16,
                               stations: StationMap | None = None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``composed_channelize_u8`` (any device):
    the normalized byte windows of ``block`` outputs each against the
    banded byte-domain matrix of ``g``, in float32.  A ragged P is padded
    to whole blocks and sliced.  ``stations``: g's S rows are stations
    over K slots (the decimation decim * K); by default K = g's rows."""
    k, g_l = _slot_count(g, stations), g.shape[1]
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
    y = _windows_matmul(x_ext, h_mat, nblk, 2 * d * block, g.shape[0],
                        block)
    return y[..., :p_out].contiguous(), _new_tail(raw_u8, zi_raw)


def _slot_count(g: np.ndarray, stations: StationMap | None) -> int:
    """K: g's rows, or the map's slots where it has one row a station."""
    if stations is None:
        return g.shape[0]
    if stations.stations != g.shape[0]:
        raise ValueError(f"g: {g.shape[0]} rows for {stations.stations} "
                         "stations")
    return stations.k


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
#: factors handed to ``composed_plan`` must compose to g within this
#: (relative to max |g|)
FACTORS_MATCH_REL = 1e-12
#: the two-stage role's compiled-in slot counts and taps per plane (the
#: slot bank's taps per residue, the RF filter's per plane of decim)
TWO_STAGE_SLOTS = (4, 8, 16)
TWO_STAGE_TAPS = 16


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

    With g's factors, g_k = conv(upsample_K(f_k), h^(k)) (``composed_rf_
    factors``), every station may instead take the two-stage role:

        s_k[m] = sum_{r<K} W^{k*r} sum_a h[K*a + r] * X[K*(m - a) - r]
        y_k[p] = sum_j f_k[j] * s_k[decim*p - j]

    the slot bank at the slot rate (K real FIRs and one K-point DFT per
    slot sample, for all stations), then each station's RF FIR.  With a
    ``StationMap`` the role runs S stations: y_j from s at slot_of[j], its
    own f_j (``slot_of``); the shared and own-taps roles take one station
    a slot only.
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
    # the two-stage role (every station; shared and own then empty):
    stage_a: np.ndarray | None = None  # (16, K) f32: h[K*a + r] / 128 at [a, r]
    stage_b: np.ndarray | None = None  # (decim, 16, S, 2) f32: f_j[decim*a + b]
    slot_of: tuple | None = None  # the two-stage role: each station's slot

    @property
    def d(self) -> int:
        return self.decim * self.k

    @property
    def stations(self) -> int:
        return self.k if self.slot_of is None else len(self.slot_of)

    @property
    def two_stage(self) -> bool:
        return self.stage_a is not None


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


def composed_plan(g: np.ndarray, decim: int, factors=None,
                  stations: StationMap | None = None) -> ComposedPlan:
    """The route of ``composed_channelize_u8`` for the (K, L) taps ``g``,
    made once per array (``g`` and the factors must not change once
    passed).

    Without ``factors``, station by station: a station takes the shared
    route when its de-rotated taps are real and equal those of the largest
    group of such stations, both within ``SHARED_MATCH_REL * max|c|``;
    every other station takes its own taps.  The kernel's shared role needs
    K <= 256 (a thread per residue and group of outputs): a larger K puts
    every station on its own taps.

    ``factors = (h_ch, f)`` (``composed_rf_factors``) must compose to g
    within ``FACTORS_MATCH_REL * max|g|`` (else ValueError); then every
    station takes the two-stage role when that needs fewer FLOP an output
    than those routes (4 L + 8 K a shared station, 8 L an own-taps one,
    against decim (4 len(h_ch) + 8 K^2) + 8 K len(f) for the slot bank and
    every station's RF FIR) and the kernel has it for K, len(h_ch) / K and
    len(f) / decim (``TWO_STAGE_SLOTS``, ``TWO_STAGE_TAPS``).

    ``stations`` (g's (S, L) rows are stations over K slots): the
    two-stage role whenever the kernel has it, which needs the factors;
    else ValueError (the shared and own-taps roles take one station a
    slot)."""
    if stations is not None and factors is None:
        raise ValueError(
            "composed_plan: stations over shared slots take only the "
            "two-stage role, which needs g's factors (composed_rf_factors)")
    if factors is None:
        return derived_from(g, ("composed_plan", decim),
                            lambda: _build_plan(np.asarray(g), decim))
    h_ch, f = factors
    return derived_from_list(
        (g, h_ch, f), ("composed_plan", decim, stations),
        lambda: _build_plan(np.asarray(g), decim, np.asarray(h_ch),
                            np.asarray(f), stations))


def _build_plan(g: np.ndarray, decim: int, h_ch=None, f=None,
                stations: StationMap | None = None) -> ComposedPlan:
    k, g_l = _slot_count(g, stations), g.shape[1]
    d = decim * k
    a = -(-g_l // d)
    a_sp = a if a == FIXED_TAPS_PER_PLANE else -(-a // 4) * 4
    # W^{k r} = W^{(k r) mod K}: the K-entry table, float64 rounded once
    ang = 2.0 * np.pi * np.arange(k) / k
    twiddle = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    if h_ch is not None:
        _check_factors(g, h_ch, f, stations)
        fits = _two_stage_fits(k, decim, len(h_ch), f.shape[1], g.shape[0])
        if stations is not None:
            if not fits:
                raise ValueError(
                    f"composed_plan: the two-stage role does not take "
                    f"{g.shape[0]} stations over {k} slots (K in "
                    f"{TWO_STAGE_SLOTS}, the taps within its window)")
            return _two_stage_plan(g, decim, h_ch, f, a_sp, twiddle,
                                   stations.slot_of)
        if (_two_stage_flop(k, decim, len(h_ch), f.shape[1])
                < _mixed_flop(g, decim) and fits):
            return _two_stage_plan(g, decim, h_ch, f, a_sp, twiddle)
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
    own_taps = None
    if own:
        gp = _planes_of(g[list(own)] / 128.0, d, a_sp)     # (n_own, d, a_sp)
        gp = np.moveaxis(gp, 0, -1)                        # (d, a_sp, n_own)
        own_taps = np.stack([gp.real, gp.imag], -1).astype(np.float32)
    return ComposedPlan(k, g_l, decim, a_sp, shared, own, proto, twiddle,
                        own_taps)


def _check_factors(g: np.ndarray, h_ch: np.ndarray, f: np.ndarray,
                   stations: StationMap | None = None) -> None:
    k = _slot_count(g, stations)
    if (h_ch.ndim != 1 or len(h_ch) % k or np.iscomplexobj(h_ch)
            or f.ndim != 2 or f.shape[0] != g.shape[0]
            or g.shape[1] != (f.shape[1] - 1) * k + len(h_ch)):
        raise ValueError(
            f"factors: a real prototype of whole branches and (S, l_rf) "
            f"station taps composing to g {g.shape}, got {h_ch.shape}, "
            f"{f.shape}")
    err = float(np.abs(_compose(
        np.asarray(h_ch, np.float64), np.asarray(f, np.complex128), k,
        None if stations is None else stations.slot_of) - g).max())
    if err > FACTORS_MATCH_REL * float(np.abs(g).max()):
        raise ValueError(
            f"factors do not compose to g: max error {err:.3g} against max "
            f"|g| {float(np.abs(g).max()):.3g}")


def _mixed_flop(g: np.ndarray, decim: int) -> int:
    """FLOP an output and capture of the shared and own-taps routes that
    ``composed_plan`` gives g without factors."""
    k, g_l = g.shape
    plan = composed_plan(g, decim)
    n_sh, n_own = len(plan.shared), len(plan.own)
    return (4 * g_l + 8 * k * n_sh if n_sh else 0) + 8 * g_l * n_own


def _two_stage_flop(k: int, decim: int, l_ch: int, l_rf: int,
                    s: int | None = None) -> int:
    """FLOP an output and capture of the two-stage role: the slot bank
    (l_ch real taps, then a direct K-point DFT row a slot, at the slot
    rate) and every station's l_rf complex taps (S stations, K by
    default)."""
    return decim * (4 * l_ch + 8 * k * k) + 8 * (k if s is None else s) * l_rf


def _two_stage_fits(k: int, decim: int, l_ch: int, l_rf: int,
                    s: int | None = None) -> bool:
    return (k in TWO_STAGE_SLOTS and l_ch <= TWO_STAGE_TAPS * k
            and l_rf <= TWO_STAGE_TAPS * decim
            and bool(_two_stage_tiles(k, decim, s)))


def _two_stage_plan(g, decim, h_ch, f, a_sp, twiddle, slot_of=None
                    ) -> ComposedPlan:
    s, g_l = g.shape
    k = twiddle.shape[0]
    slot_of = tuple(range(k)) if slot_of is None else slot_of
    ta = TWO_STAGE_TAPS
    h = np.zeros(ta * k)
    h[:len(h_ch)] = h_ch
    stage_a = (h.reshape(ta, k) / 128.0).astype(np.float32)
    fp = np.zeros((s, ta * decim), np.complex128)
    fp[:, :f.shape[1]] = f
    fp = fp.reshape(s, ta, decim).transpose(2, 1, 0)     # (decim, ta, S)
    stage_b = np.stack([fp.real, fp.imag], -1).astype(np.float32)
    return ComposedPlan(k, g_l, decim, a_sp, (), (), None, twiddle, None,
                        stage_a, stage_b, slot_of)


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


@dataclasses.dataclass(frozen=True)
class TwoStageGeometry:
    """How the two-stage role cuts one launch: a block is one capture's
    tile of ``tile`` outputs; stage A's K planes of ``pitch_a`` rows (odd),
    in the first ``a_elems`` float2 of shared memory, which stage B's taps
    and partial sums take over once stage A is done; u_r, then s_k, as
    stage B's decim planes of ``bp`` rows (odd), a slot's ``kp`` apart
    (odd), after them; stage B in ``ns`` slices of the half-planes, its
    (station, R outputs, slice) items ``K5_THREADS`` at a time; ``smem``
    bytes of dynamic shared memory."""

    tile: int
    n_tiles: int
    ns: int
    pitch_a: int
    a_elems: int
    bp: int
    kp: int
    smem: int


def _two_stage_tiles(k: int, decim: int, s: int | None = None) -> list:
    """(cost an output, tile, ns, pitch_a, a_elems, bp, kp, smem) of each
    tile whose block fits two to an SM, for S stations (K by default).
    The cost counts a thread's turns of work a block: stage A's groups of
    R outputs of a residue (R x 16 taps x 2 FMA), the DFT's slot samples
    (about 4 K log2 K + 2 K), stage B's half-planes (R x 8 taps x 4 FMA;
    S x tile / R x ns items, a turn for each K5_THREADS of them) and the
    staging, over the tile.  Where the block's threads cover S stations'
    groups, ns is as many slices as they allow; else 1."""
    ta, r, thr = TWO_STAGE_TAPS, K5_R, K5_THREADS
    s = k if s is None else s
    out = []
    for tile in range(r, 16 * r + 1, r):
        groups = tile // r
        if k * groups > thr:
            break
        ns = max(1, thr // (s * groups))
        passes = -(-s * groups * ns // thr)
        qb = tile + ta - 1
        bp = qb | 1
        kp = (decim * bp) | 1
        ms = decim * qb
        ms_pad = -(-ms // r) * r
        pitch_a = (ms_pad + ta - 1) | 1
        # stage B's taps and partial sums over the dead stage-A planes
        a_elems = max(k * pitch_a, decim * ta * s + ns * s * (tile + 1))
        smem = 8 * (a_elems + k * kp)
        if smem > K5_SMEM or (s == k and a_elems > k * pitch_a):
            continue
        turns = (-(-k * ms_pad // (r * thr)) * r * ta * 2
                 + -(-ms // thr) * (4 * k * int(math.log2(k)) + 2 * k)
                 + passes * -(-2 * decim // ns) * r * (ta // 2) * 4
                 + -(-k * (ms_pad + ta) // thr) * 6)
        out.append((turns / tile, tile, ns, pitch_a, a_elems, bp, kp, smem))
    return out


def two_stage_geometry(plan: ComposedPlan, n_cap: int, p_out: int,
                       n_sm: int = 132) -> TwoStageGeometry:
    """The tile of least cost an output whose grid gives two blocks per
    SM; else the narrowest tile."""
    opts = _two_stage_tiles(plan.k, plan.decim, plan.stations)
    fill = [o for o in opts if n_cap * -(-p_out // o[1]) >= 2 * n_sm]
    _, tile, ns, pitch_a, a_elems, bp, kp, smem = (min(fill) if fill
                                                    else opts[0])
    return TwoStageGeometry(tile, -(-p_out // tile), ns, pitch_a, a_elems,
                            bp, kp, smem)


_n_sm: dict = {}


def _sm_count(dev) -> int:
    if dev not in _n_sm:
        _n_sm[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _n_sm[dev]


def residual_mix(iq: torch.Tensor, mix_phase: torch.Tensor,
                 mix_ramp: torch.Tensor) -> torch.Tensor:
    """Each station's residual downconversion in stock ops: (I + jQ) *
    exp(j*(phase_j + ramp_j[m])) over iq (..., S, 2, M), mix_phase (S,),
    mix_ramp (S, M) (the NCO's angle at each sample, reduced mod 2 pi in
    float64 when built)."""
    ang = mix_phase[:, None] + mix_ramp
    c, sn = torch.cos(ang), torch.sin(ang)    # (S, M)
    i_in = iq[..., 0, :]
    q_in = iq[..., 1, :]
    return torch.stack([i_in * c - q_in * sn, i_in * sn + q_in * c], dim=-2)


def composed_channelize_u8(raw_u8: torch.Tensor, g: np.ndarray,
                           zi_raw: torch.Tensor, decim: int, factors=None,
                           stations: StationMap | None = None, mix=None
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

    ``factors``: optional ``(h_ch, f)`` that g is composed of
    (``composed_rf_factors``; checked against g once), which lets the
    kernel run the slot bank and each station's RF FIR apart where that is
    less work (``composed_plan``).

    ``stations``: g's rows are S stations over K slots (``composed_rf_
    factors`` with the same map; the decimation decim * K): outputs
    (..., S, 2, P), the two-stage role on a CUDA tensor, which needs the
    factors.

    ``mix``: optional ``(mix_phase, mix_ramp)``, (S,) and (S, P) float32
    on the input's device: the outputs come turned by each station's
    residual NCO, as ``residual_mix`` turns them.  The two-stage role on a
    CUDA tensor turns them in the kernel's epilogue; every other route
    (the mixed roles, the CPU) runs ``residual_mix`` after the bank.

    A CUDA tensor launches the kernel (``csrc/channelizer.cu``) or raises;
    the route (shared prototype + in-kernel DFT, own taps, or two stages)
    is chosen on the host from ``g`` and its factors (``composed_plan``).
    A CPU tensor runs ``composed_channelize_u8_ref``.
    """
    with annotate("rtsdr.channelize", route="composed") as span:
        if span:
            plan = composed_plan(g, decim, factors, stations)
            k = _slot_count(g, stations)
            fused = mix is not None and raw_u8.is_cuda and plan.two_stage
            span.add(captures=math.prod(raw_u8.shape[:-1]), slots=k,
                     shared=len(plan.shared), own=len(plan.own),
                     two_stage=g.shape[0] if plan.two_stage else 0,
                     taps=g.shape[1], mix=g.shape[0] if fused else 0,
                     **_span_stations(k, stations))
        return _composed_channelize_u8(raw_u8, g, zi_raw, decim, factors,
                                       stations, mix)


def _composed_channelize_u8(raw_u8, g, zi_raw, decim: int, factors=None,
                            stations: StationMap | None = None, mix=None):
    """The route's call; ``mix`` turns in the two-stage role's epilogue,
    by ``residual_mix`` after the bank on the others."""
    if not raw_u8.is_cuda:
        y, new_zi = composed_channelize_u8_ref(raw_u8, g, zi_raw, decim,
                                               stations=stations)
        return (y if mix is None else residual_mix(y, *mix)), new_zi
    k, g_l = _slot_count(g, stations), g.shape[1]
    n_st = g.shape[0]
    d = decim * k
    _check_composed(raw_u8, g, zi_raw, d)
    dev = raw_u8.device
    _cuda.check(raw_u8, "raw_u8", dtype=torch.uint8)
    _cuda.check(zi_raw, "zi_raw", dtype=torch.uint8, device=dev)
    if raw_u8.data_ptr() % 2 or zi_raw.data_ptr() % 2:
        raise ValueError("raw_u8 / zi_raw: must start at an even address")
    lead = tuple(raw_u8.shape[:-1])
    n_cap = math.prod(lead)
    n = raw_u8.shape[-1] // 2
    p_out = n // d
    plan = composed_plan(g, decim, factors, stations)
    n_sm = _sm_count(dev)
    y = torch.empty((*lead, n_st, 2, p_out), dtype=torch.float32,
                    device=dev)
    new_zi = torch.empty_like(zi_raw)
    on = _plan_on(g, plan, dev)
    if plan.two_stage:
        geo = derived_from(
            g, ("two_stage_geometry", decim, n_cap, p_out, n_sm),
            lambda: two_stage_geometry(plan, n_cap, p_out, n_sm))
        phase = ramp = None
        if mix is not None:
            phase = _cuda.check(mix[0], "mix_phase", (n_st,), torch.float32,
                                dev)
            ramp = _cuda.check(mix[1], "mix_ramp", (n_st, p_out),
                               torch.float32, dev)
        _cuda.launch(
            "rtsdr_channelize_two_stage", "channelizer.composed_two_stage",
            _cuda.ptr(raw_u8), _cuda.ptr(zi_raw), *map(_cuda.ptr, on),
            _cuda.ptr(phase), _cuda.ptr(ramp),
            _cuda.ptr(y), _cuda.ptr(new_zi), n_cap, n, k, n_st, g_l, decim,
            p_out, geo.tile, geo.n_tiles, geo.ns, geo.pitch_a, geo.a_elems,
            geo.bp, geo.kp, geo.smem)
        return y, new_zi
    geo = derived_from(
        g, ("composed_geometry", decim, n_cap, p_out, n_sm),
        lambda: composed_geometry(plan, n_cap, p_out, n_sm))
    _cuda.launch(
        "rtsdr_channelize_composed", "channelizer.composed",
        _cuda.ptr(raw_u8), _cuda.ptr(zi_raw), *map(_cuda.ptr, on),
        _cuda.ptr(y), _cuda.ptr(new_zi), n_cap, n, k, g_l, d,
        plan.a_sp, p_out, geo.tile, geo.n_tiles, geo.nb, geo.pitch,
        len(plan.shared), len(plan.own), geo.own_lanes, geo.n_og, geo.ns_sh,
        geo.ns_own, geo.g_sh, geo.g_own, geo.plane_elems, geo.smem)
    return (y if mix is None else residual_mix(y, *mix)), new_zi


def _plan_on(g: np.ndarray, plan: ComposedPlan, dev) -> tuple:
    """The plan's arrays on ``dev`` (made once per ``g``, route and
    device): the two-stage role's slot-bank taps, RF taps, twiddles and
    stations' slots; else the prototype
    planes, the twiddles, the shared stations, the own taps, the own
    stations (None where a route has no station)."""
    def f32(a):
        return None if a is None else torch.as_tensor(
            np.ascontiguousarray(a, np.float32)).to(dev)

    def i32(a):
        return None if not a else torch.as_tensor(
            np.asarray(a, np.int32)).to(dev)

    def build():
        if plan.two_stage:
            return (f32(plan.stage_a), f32(plan.stage_b), f32(plan.twiddle),
                    i32(plan.slot_of))
        return (f32(plan.proto), f32(plan.twiddle), i32(plan.shared),
                f32(plan.own_taps), i32(plan.own))

    return derived_from(
        g, ("composed_plan_on", plan.decim, plan.two_stage, str(dev)), build)


def channel_center_freqs(n_channels: int, fs: float) -> np.ndarray:
    """Center frequency of each output channel (Hz), wrapped to +-fs/2."""
    k = np.arange(n_channels)
    f = k * fs / n_channels
    return np.where(f >= fs / 2, f - fs, f)
