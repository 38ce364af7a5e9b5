"""RF front end: uint8 ingest, IQ LPF + decimate to IF, FM discrimination.

Counterpart of ``rtsdr_tpu/pipeline/frontend.py``: deinterleave, 151-tap
LPF at Fc=100 kHz fused with the /10 decimator on both I and Q, then the
discriminator.  Coefficients are computed once at build time.

Four implementations:
  * 'split'  — normalize/deinterleave and the discriminator as tensor ops
               around a batched I+Q decimating FIR (``ops.fir``: the FIR-bank
               kernel on a CUDA tensor).
  * 'fused'  — ``ops.ingestfir.ingest_fir_demod``: one kernel consumes the
               raw interleaved uint8 directly.  'auto' is 'fused'.
  * 'iq'     — input is already float I/Q stacked as (..., 2, n) — the
               wideband channelizer's per-channel baseband
               (pipeline/wideband.py); skips normalize/deinterleave.
  * 'if'     — input is already RF-FILTERED AND DECIMATED float I/Q
               stacked as (..., 2, if_len) — the composed channelizer+RF
               kernel's output (ops.channelizer.composed_channelize_u8);
               only the discriminator runs here (the FIR state fields ride
               along untouched so the state tree keeps one shape across
               impls).
On a CUDA device all are float32 or building raises; on the CPU all run
the plain versions in any dtype (float64 for oracle parity).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rtsdr_tpu_torch.config import ReceiverConfig
from rtsdr_tpu_torch.device import require_kernel_dtype, resolve_device
from rtsdr_tpu_torch.ops import coeffs
from rtsdr_tpu_torch.ops.demod import demod_init, fm_discriminator
from rtsdr_tpu_torch.ops.fir import fir_decimate, fir_zi
from rtsdr_tpu_torch.ops.ingestfir import (
    ingest_fir_demod,
    normalize_deinterleave,
)


class FrontendState(NamedTuple):
    zi_i: torch.Tensor       # (..., rf_taps-1)
    zi_q: torch.Tensor
    prev_i: torch.Tensor     # (...,) discriminator state
    prev_q: torch.Tensor


def frontend_init(cfg: ReceiverConfig, batch_shape: tuple = (),
                  dtype=torch.float32, device="cuda") -> FrontendState:
    dev = resolve_device(device)
    pi, pq = demod_init(batch_shape, dtype, dev)
    return FrontendState(
        zi_i=fir_zi(cfg.rf.taps, batch_shape, dtype, dev),
        zi_q=fir_zi(cfg.rf.taps, batch_shape, dtype, dev),
        prev_i=pi,
        prev_q=pq,
    )


def rf_lpf_taps(cfg: ReceiverConfig):
    """The RF front-end LPF (single source of truth — the receiver's
    fused ingest paths consume the SAME design)."""
    return coeffs.lowpass_taps(cfg.rf.fs, cfg.rf.fc, cfg.rf.taps)


def make_frontend(cfg: ReceiverConfig, dtype=torch.float32,
                  impl: str = "auto", device="cuda"):
    """Returns ``frontend(state, raw_u8) -> (fm_demod, new_state)``.

    raw_u8: (..., block_size) interleaved uint8 (float (..., 2, n) stacked
    I/Q for 'iq' / 'if'); fm_demod: (..., if_len).
    """
    require_kernel_dtype(resolve_device(device), dtype)
    rf_h = rf_lpf_taps(cfg)
    decim = cfg.rf.decim
    if impl == "auto":
        impl = "fused"
    if impl not in ("fused", "split", "iq", "if"):
        raise ValueError(f"unknown frontend impl {impl!r}")

    def frontend(state: FrontendState, raw_u8: torch.Tensor):
        if impl == "if":
            fm, (pi, pq) = fm_discriminator(
                raw_u8[..., 0, :], raw_u8[..., 1, :],
                (state.prev_i, state.prev_q))
            return fm, state._replace(prev_i=pi.clone(), prev_q=pq.clone())
        if impl == "fused":
            fm, zi_i, zi_q, pi, pq = ingest_fir_demod(
                raw_u8, rf_h, state.zi_i, state.zi_q,
                state.prev_i, state.prev_q, decim)
            return fm, FrontendState(zi_i=zi_i, zi_q=zi_q,
                                     prev_i=pi, prev_q=pq)
        # 'iq': already float (..., 2, n)
        iq = raw_u8 if impl == "iq" else normalize_deinterleave(raw_u8, dtype)
        zi = torch.stack([state.zi_i, state.zi_q], dim=-2)
        iq_ds, zi_new = fir_decimate(iq, rf_h, zi, decim)
        fm, (pi, pq) = fm_discriminator(iq_ds[..., 0, :], iq_ds[..., 1, :],
                                        (state.prev_i, state.prev_q))
        return fm, FrontendState(zi_i=zi_new[..., 0, :].contiguous(),
                                 zi_q=zi_new[..., 1, :].contiguous(),
                                 prev_i=pi.clone(), prev_q=pq.clone())

    return frontend
