"""Band scanner: one wideband capture -> per-channel station metrics.

Counterpart of ``rtsdr_tpu/pipeline/scan.py``: the PFB channelizer splits a
K-wide capture into K candidate stations, each runs only the RF front end +
FM discriminator, and Bartlett-PSD probes on the demodulated multiplex
classify activity per channel:

  * rssi_db      — mean baseband power at the channel rate (is there a
                   carrier in this slot at all?),
  * pilot_snr_db — 19 kHz pilot power over the multiplex noise floor
                   (an FM *stereo* broadcast),
  * rds_snr_db   — 57 kHz subcarrier power over the floor (RDS present).

One step per wideband block; all K channels scan together.  The RF
low-pass ↓10 of the 'iq' front end is the FIR-bank kernel on a CUDA
tensor; the channelizer product, the discriminator and the PSD probes are
stock tensor ops, as the reference leaves them to its compiler.
``make_band_scanner`` returns the eager step, as the JAX package's does;
the CLI compiles it without donation (``utils/jit.py::jit_fn``, one CUDA
graph replayed per block), as the JAX CLI jits it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rtsdr_tpu_torch.config import ReceiverConfig
from rtsdr_tpu_torch.device import resolve_device
from rtsdr_tpu_torch.ops.channelizer import (
    channelizer_taps,
    channelizer_zi_u8,
    pfb_channelize_u8,
)
from rtsdr_tpu_torch.ops.psd import estimate_psd, psd_freqs
from rtsdr_tpu_torch.pipeline.frontend import (
    FrontendState,
    frontend_init,
    make_frontend,
)


class ScanState(NamedTuple):
    chan_zi: torch.Tensor   # channelizer carried raw-byte tail
    fe: FrontendState       # per-channel RF front-end state


class ScanMetrics(NamedTuple):
    rssi_db: torch.Tensor   # (..., K)
    pilot_snr_db: torch.Tensor
    rds_snr_db: torch.Tensor


def _band_bins(freqs: np.ndarray, center: float, half_width: float,
               device) -> torch.Tensor:
    sel = np.nonzero(np.abs(freqs - center) <= half_width)[0]
    if sel.size == 0:
        raise ValueError(
            f"no PSD bin within {half_width} Hz of {center} Hz: nfft too small")
    return torch.as_tensor(sel, device=device)


def make_band_scanner(cfg: ReceiverConfig, n_rf_channels: int,
                      nfft: int = 1024, taps_per_branch: int = 16,
                      device="cuda"):
    """Build ``(init_fn, step_fn)``; ``step_fn(state, raw_u8) ->
    (ScanMetrics, state)`` over (K * cfg.block_size,) interleaved uint8
    at ``fs_w = K * cfg.rf.fs``."""
    dev = resolve_device(device)
    k = n_rf_channels
    h = np.asarray(channelizer_taps(k, taps_per_branch))
    fe_fn = make_frontend(cfg, impl="iq", device=dev)
    if_fs = cfg.rf.if_fs

    freqs = psd_freqs(nfft, if_fs)
    pilot_bins = _band_bins(freqs, 19e3, 500.0, dev)
    rds_bins = _band_bins(freqs, 57e3, 1500.0, dev)
    # noise floor: median of the FM multiplex band, away from DC
    floor_bins = _band_bins(freqs, 51.5e3, 48.5e3, dev)

    def init_fn() -> ScanState:
        return ScanState(chan_zi=channelizer_zi_u8(k, len(h), device=dev),
                         fe=frontend_init(cfg, (k,), device=dev))

    @torch.no_grad()
    def step_fn(state: ScanState, raw_u8: torch.Tensor):
        raw_iq, chan_zi = pfb_channelize_u8(raw_u8, h, state.chan_zi, k)
        i = raw_iq[..., 0, :]
        q = raw_iq[..., 1, :]
        rssi_db = 10.0 * torch.log10(torch.mean(i * i + q * q, dim=-1)
                                     + 1e-30)
        fm, fe = fe_fn(state.fe, raw_iq)
        _, psd = estimate_psd(fm, nfft, if_fs)          # (K, nfft//2) dB
        floor = _median(psd[..., floor_bins])
        pilot = psd[..., pilot_bins].amax(dim=-1) - floor
        rds = psd[..., rds_bins].amax(dim=-1) - floor
        return (ScanMetrics(rssi_db=rssi_db, pilot_snr_db=pilot,
                            rds_snr_db=rds),
                ScanState(chan_zi=chan_zi, fe=fe))

    return init_fn, step_fn


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis with the mean of the two middle values for
    an even count (``torch.median`` returns the lower one)."""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    return 0.5 * (s[..., (n - 1) // 2] + s[..., n // 2])


def classify(m, rssi_floor_db: float = -35.0, snr_db: float = 8.0) -> list:
    """Human verdict per channel from (block-averaged) ScanMetrics of host
    arrays.

    A slot is a *station* when its RSSI clears ``rssi_floor_db`` — an
    absolute threshold against normalized full scale: an empty slot of a
    uint8 capture sits at the quantization floor (~-50 dB; thermal noise
    in a real capture is somewhat higher), while any decodable carrier is
    tens of dB up.  Absolute, not relative to the quietest slot, so a
    fully-occupied band (or K=1) classifies correctly.  Pilot/RDS tags
    need ``snr_db`` over the multiplex floor.
    """
    rssi = np.asarray(m.rssi_db)
    pilot = np.asarray(m.pilot_snr_db)
    rds = np.asarray(m.rds_snr_db)
    out = []
    for c in range(rssi.shape[-1]):
        if rssi[c] < rssi_floor_db:
            out.append("empty")
            continue
        tags = ["station"]
        if pilot[c] >= snr_db:
            tags.append("stereo")
        if rds[c] >= snr_db:
            tags.append("rds")
        out.append("+".join(tags))
    return out
