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
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rtsdr_tpu_torch.ops import _cuda
from rtsdr_tpu_torch.ops.coeffs import lowpass_taps
from rtsdr_tpu_torch.ops.fir import derived_from


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


def _g_on(g: np.ndarray, device) -> torch.Tensor:
    """(L, K, 2) float32 taps on ``device``, scaled by 1/128 (exact: the
    kernel multiplies them with un-normalized b-128 values), laid out tap
    major so that the K stations of one tap are contiguous."""
    def build():
        gt = g.T * (1.0 / 128.0)                                  # (L, K)
        return np.stack([gt.real, gt.imag], axis=-1)

    return _derived_from(g, ("kernel",), build, device)


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
    a CPU tensor runs ``composed_channelize_u8_ref``.
    """
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
    y = torch.empty((*lead, k, 2, p_out), dtype=torch.float32, device=dev)
    new_zi = torch.empty_like(zi_raw)
    _cuda.launch(
        "rtsdr_channelize_composed", "channelizer.composed",
        _cuda.ptr(raw_u8), _cuda.ptr(zi_raw), _cuda.ptr(_g_on(g, dev)),
        _cuda.ptr(y), _cuda.ptr(new_zi), math.prod(lead), n, k, g_l, d)
    return y, new_zi


def channel_center_freqs(n_channels: int, fs: float) -> np.ndarray:
    """Center frequency of each output channel (Hz), wrapped to +-fs/2."""
    k = np.arange(n_channels)
    f = k * fs / n_channels
    return np.where(f >= fs / 2, f - fs, f)
