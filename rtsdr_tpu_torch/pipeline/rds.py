"""RDS DSP chain: 57 kHz subcarrier to RRC-filtered baseband.

Counterpart of ``rtsdr_tpu/pipeline/rds.py``, following the golden model
(model/fmRDSblock.py:154-204):

  extract BPF 54-60 kHz -> squaring nonlinearity -> BPF 113.5-114.5 kHz ->
  PLL at 114 kHz (nco_scale=0.5 -> coherent 57 kHz, phase_adjust tuned) ->
  I/Q mixers (x2) -> LPF 3 kHz -> rational resample x19/80 to 57 kS/s ->
  RRC matched filter.

On a CUDA tensor: the squaring fuses into the 114 kHz band-pass (FIR-bank
kernel, pre-op "square"), the loop is the PLL kernel, and mixers + 3 kHz LPF
+ resampler + RRC are ONE kernel (``ops/cuda_resample.py``).  I and Q
branches share filters via a stacked dim of 2.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rtsdr_tpu_torch.config import ReceiverConfig
from rtsdr_tpu_torch.device import resolve_device
from rtsdr_tpu_torch.ops import coeffs
from rtsdr_tpu_torch.ops.cuda_fir import fir_block_pre
from rtsdr_tpu_torch.ops.cuda_resample import resample_mul2_rrc
from rtsdr_tpu_torch.ops.fir import fir_block, fir_zi, resample_zi
from rtsdr_tpu_torch.ops.pll import PLLState, pll, pll_init


class RDSState(NamedTuple):
    extract_zi: torch.Tensor   # (..., taps-1)
    squared_zi: torch.Tensor   # (..., taps-1)
    pll: PLLState
    resamp_zi: torch.Tensor    # (..., 2, comb_taps-1) upsampled domain: the
    #                            3 kHz LPF is composed into the resampler's
    #                            anti-image filter (composed_resampler_taps)
    rrc_zi: torch.Tensor       # (..., 2, rrc_taps-1)


def composed_resampler_taps(cfg: ReceiverConfig) -> np.ndarray:
    """The 3 kHz LPF (IF rate) cascaded into the x``up`` anti-image filter.

    The golden model runs LPF then resample as separate passes
    (model/fmRDSblock.py:180-199).  Upsampling commutes with convolution,
    so zero-stuffing the LPF response to the dilated rate and convolving
    with the anti-image response gives ONE filter whose x-domain polyphase
    form does both: ~158 effective taps per output instead of 151, and the
    IF-rate LPF pass vanishes.  Exact: linear filters compose; coefficients
    are combined in float64.
    """
    r = cfg.rds
    if_fs = cfg.rf.if_fs
    lpf_h = np.asarray(coeffs.lowpass_taps(if_fs, r.lpf_fc, r.taps),
                       np.float64)
    anti_h = np.asarray(
        coeffs.lowpass_taps(if_fs * r.up, r.rrc_fs / 2, r.anti_img_taps),
        np.float64)
    lpf_u = np.zeros((r.taps - 1) * r.up + 1)
    lpf_u[::r.up] = lpf_h
    return np.convolve(lpf_u, anti_h)  # (taps-1)*up + anti_img_taps long


def rds_init(cfg: ReceiverConfig, batch_shape: tuple = (),
             dtype=torch.float32, device="cuda") -> RDSState:
    dev = resolve_device(device)
    r = cfg.rds
    comb_taps = (r.taps - 1) * r.up + r.anti_img_taps
    return RDSState(
        extract_zi=fir_zi(r.taps, batch_shape, dtype, dev),
        squared_zi=fir_zi(r.taps, batch_shape, dtype, dev),
        pll=pll_init(batch_shape, dtype, dev),
        resamp_zi=resample_zi(comb_taps, (*batch_shape, 2), dtype, dev),
        rrc_zi=fir_zi(r.rrc_taps, (*batch_shape, 2), dtype, dev),
    )


def make_rds(cfg: ReceiverConfig, pll_impl: str = "auto",
             pll_loop_div: int = 1):
    """Returns ``rds(state, fm_demod) -> ((rrc_i, rrc_q), new_state)``.

    fm_demod: (..., if_len); rrc outputs: (..., rds_len) at 57 kS/s.
    """
    r = cfg.rds
    if_fs = cfg.rf.if_fs
    extract_h = coeffs.bandpass_taps(if_fs, r.extract_lo, r.extract_hi, r.taps)
    squared_h = coeffs.bandpass_taps(if_fs, r.squared_lo, r.squared_hi, r.taps)
    comb_h = composed_resampler_taps(cfg)
    rrc_h = coeffs.rrc_taps(r.rrc_fs, r.rrc_taps, r.rrc_beta, r.symbol_rate)
    pcfg = r.pll

    def rds(state: RDSState, fm: torch.Tensor | None,
            extract: torch.Tensor | None = None,
            nco_pre: tuple | None = None,
            fm_tail: torch.Tensor | None = None):
        # the receiver may pass `extract` precomputed (3-fused with the
        # stereo pilot/channel band-passes over the same fm input — or
        # fused all the way into the ingest kernel, in which case fm is
        # None and only its tail arrives) and the carrier NCO precomputed
        # (PLL fused with the stereo pilot loop);
        # nco_pre = (nco_i, nco_q, pll_state, squared_zi)
        if extract is None:
            extract, extract_zi = fir_block(fm, extract_h, state.extract_zi)
        elif fm_tail is not None:
            extract_zi = fm_tail[..., -(r.taps - 1):]
        else:
            extract_zi = torch.cat(
                [state.extract_zi, fm], dim=-1)[..., -(r.taps - 1):]
        if nco_pre is not None:
            nco_i, nco_q, pll_state, squared_zi = nco_pre
        else:
            pre_pll, squared_zi = fir_block_pre(extract, squared_h,
                                                state.squared_zi, "square")
            nco_i, nco_q, pll_state = pll(
                pre_pll, state.pll, freq=pcfg.freq, fs=if_fs,
                nco_scale=pcfg.nco_scale, phase_adjust=pcfg.phase_adjust,
                norm_bandwidth=pcfg.norm_bandwidth, impl=pll_impl,
                loop_div=pll_loop_div)

        rrc, resamp_zi, rrc_zi = resample_mul2_rrc(
            extract, nco_i, nco_q, comb_h, state.resamp_zi, rrc_h,
            state.rrc_zi, r.up, r.down)

        new_state = RDSState(
            extract_zi=extract_zi.contiguous(), squared_zi=squared_zi,
            pll=pll_state, resamp_zi=resamp_zi, rrc_zi=rrc_zi)
        return (rrc[..., 0, :], rrc[..., 1, :]), new_state

    return rds
