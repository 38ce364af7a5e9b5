"""Mono + stereo audio chains.

Counterpart of ``rtsdr_tpu/pipeline/audio.py``, following the golden model
(model/fmMonoBlock.py:100-173):

  mono:   LPF 16 kHz + decimate 5   (mode 0)
  stereo: pilot BPF 18.5-19.5 kHz -> PLL (nco_scale=2 -> 38 kHz subcarrier)
          channel BPF 22-54 kHz -> mixer (x NCO x 2) -> LPF 16 kHz +
          decimate -> L = (mono+stereo)/2, R = (mono-stereo)/2

  mode 1: mono and the mixed stereo channel go through one stacked x24/125
          rational resampler (``ops.fir.fir_resample`` with ``up > 1``:
          stock tensor ops, as the reference leaves it to its compiler).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rtsdr_tpu_torch.config import ReceiverConfig
from rtsdr_tpu_torch.device import resolve_device
from rtsdr_tpu_torch.ops import coeffs
from rtsdr_tpu_torch.ops.cuda_fir import fir_bank_carried
from rtsdr_tpu_torch.ops.fir import (
    fir_block_bank,
    fir_resample,
    fir_zi,
    resample_zi,
)
from rtsdr_tpu_torch.ops.iir import deemphasize
from rtsdr_tpu_torch.ops.pll import PLLState, pll, pll_init


class AudioState(NamedTuple):
    mono_zi: torch.Tensor           # (..., mono_taps*up - 1) resampler domain
    pilot_zi: torch.Tensor | None   # (..., stereo_taps-1); None if mono-only
    chan_zi: torch.Tensor | None    # (..., stereo_taps-1)
    stereo_zi: torch.Tensor | None  # (..., mono_taps*up - 1) post-mix
    pll: PLLState | None
    deemph: torch.Tensor | None     # (..., 2) L/R de-emphasis IIR carry


def _audio_taps(cfg: ReceiverConfig) -> int:
    # Mode 1 scales tap count by the upsampling factor so the filter keeps
    # its transition width at the dilated rate.
    return cfg.mono.taps * cfg.mono.up


def audio_lpf_taps(cfg: ReceiverConfig):
    """The mono/stereo 16 kHz resampler LPF (single source of truth —
    the receiver's fused ingest+audio kernel consumes the SAME design)."""
    return coeffs.lowpass_taps(cfg.rf.if_fs * cfg.mono.up, cfg.mono.fc,
                               _audio_taps(cfg))


def audio_init(cfg: ReceiverConfig, batch_shape: tuple = (),
               dtype=torch.float32, enable_stereo: bool = True,
               deemphasis: float | None = None,
               device="cuda") -> AudioState:
    dev = resolve_device(device)
    taps = _audio_taps(cfg)
    de = (torch.zeros((*batch_shape, 2), dtype=dtype, device=dev)
          if deemphasis is not None else None)
    if not enable_stereo:
        return AudioState(mono_zi=resample_zi(taps, batch_shape, dtype, dev),
                          pilot_zi=None, chan_zi=None, stereo_zi=None,
                          pll=None, deemph=de)
    return AudioState(
        mono_zi=resample_zi(taps, batch_shape, dtype, dev),
        pilot_zi=fir_zi(cfg.stereo.taps, batch_shape, dtype, dev),
        chan_zi=fir_zi(cfg.stereo.taps, batch_shape, dtype, dev),
        stereo_zi=resample_zi(taps, batch_shape, dtype, dev),
        pll=pll_init(batch_shape, dtype, dev),
        deemph=de,
    )


def make_audio(cfg: ReceiverConfig, enable_stereo: bool = True,
               pll_impl: str = "auto", deemphasis: float | None = None,
               pll_loop_div: int = 1,
               stereo_blend: bool | tuple = False):
    """Returns ``audio(state, fm_demod) -> ((left, right, mono), new_state)``.

    fm_demod: (..., if_len); outputs at 48 kS/s: (..., audio_len).
    With ``enable_stereo=False`` only the mono chain runs and left = right
    = mono.  ``deemphasis``: optional FM de-emphasis time constant in
    seconds (75e-6 Americas / 50e-6 Europe) applied to L/R.

    ``stereo_blend``: fade stereo toward mono as the 19 kHz pilot
    weakens.  True = default thresholds, or a ``(lo, hi)`` tuple of
    pilot-RMS levels (in FM-demod units): the L-R signal scales linearly
    from 0 below ``lo`` to 1 above ``hi``.  Per-block, stateless.
    """
    blend_range = None
    if stereo_blend:
        blend_range = (0.02, 0.08) if stereo_blend is True else stereo_blend
        if not blend_range[1] > blend_range[0]:
            raise ValueError(
                f"stereo_blend thresholds need hi > lo, got {blend_range}")
    if_fs = cfg.rf.if_fs
    up, down = cfg.mono.up, cfg.mono.down
    # Resampler LPF cutoff: 16 kHz, designed at the dilated rate if_fs*up.
    mono_h = audio_lpf_taps(cfg)
    pilot_h = coeffs.bandpass_taps(if_fs, cfg.stereo.pilot_lo,
                                   cfg.stereo.pilot_hi, cfg.stereo.taps)
    chan_h = coeffs.bandpass_taps(if_fs, cfg.stereo.chan_lo,
                                  cfg.stereo.chan_hi, cfg.stereo.taps)
    pcfg = cfg.stereo.pll

    def audio(state: AudioState, fm: torch.Tensor | None,
              pilot: torch.Tensor | None = None,
              chan: torch.Tensor | None = None,
              nco_pre: tuple | None = None,
              mono_pre: tuple | None = None,
              fm_tail: torch.Tensor | None = None):
        # the receiver may pass the mono branch precomputed (LPF↓down
        # fused into the ingest+demod kernel, ops/ingestfir.py) as
        # mono_pre = (mono, new_mono_zi); fm is then None in the
        # mono-only configuration (it never left the kernel)
        if not enable_stereo:
            if mono_pre is not None:
                mono, mono_zi = mono_pre
            else:
                mono, mono_zi = fir_resample(fm, mono_h, state.mono_zi,
                                             up, down)
            out, de = _deemph(mono, mono, state.deemph)
            new_state = AudioState(mono_zi=mono_zi, pilot_zi=None,
                                   chan_zi=None, stereo_zi=None, pll=None,
                                   deemph=de)
            return (*out, mono), new_state

        # pilot + channel band-passes filter the SAME input, so they share
        # one overlap-save tail and one kernel launch (the input tile is
        # read once).  The receiver may pass them precomputed (3-fused
        # with the RDS extraction BPF).
        if pilot is None or chan is None:
            (pilot, chan), if_tail = fir_block_bank(fm, [pilot_h, chan_h],
                                                    state.pilot_zi)
        elif fm_tail is not None:
            if_tail = fm_tail[..., -(cfg.stereo.taps - 1):].contiguous()
        else:
            if_tail = torch.cat(
                [state.pilot_zi, fm],
                dim=-1)[..., -(cfg.stereo.taps - 1):].contiguous()

        # stereo pilot -> 38 kHz NCO (the receiver may pass the NCO
        # precomputed, fused with the RDS carrier loop in one kernel)
        if nco_pre is not None:
            nco, pll_state = nco_pre
        else:
            nco, _, pll_state = pll(
                pilot, state.pll, freq=pcfg.freq, fs=if_fs,
                nco_scale=pcfg.nco_scale, phase_adjust=pcfg.phase_adjust,
                norm_bandwidth=pcfg.norm_bandwidth, impl=pll_impl,
                delay_output=cfg.stereo.nco_delay, loop_div=pll_loop_div)

        # mix the stereo channel to baseband; mono and stereo share the
        # same 16 kHz resampler taps.  At up == 1 the mixer fuses INTO
        # the decimating filter (pre-op "mul2": on a CUDA tensor the mixed
        # stream is never written); otherwise both branches run as one
        # stacked resampler call.
        fused_mix = up == 1
        if mono_pre is not None:
            mono, mono_zi = mono_pre
        if fused_mix:
            if mono_pre is None:
                (mono,), mono_zi = fir_bank_carried(
                    fm, [mono_h], state.mono_zi, down)
            (stereo,), stereo_zi = fir_bank_carried(
                chan, [mono_h], state.stereo_zi, down, x2=nco, pre="mul2")
        elif mono_pre is not None:
            stereo, stereo_zi = fir_resample(
                2.0 * chan * nco, mono_h, state.stereo_zi, up, down)
        else:
            mixed = 2.0 * chan * nco
            pair = torch.stack([fm, mixed], dim=-2)
            pair_zi = torch.stack([state.mono_zi, state.stereo_zi], dim=-2)
            ys, zi2 = fir_resample(pair, mono_h, pair_zi, up, down)
            mono, stereo = ys[..., 0, :], ys[..., 1, :]
            mono_zi = zi2[..., 0, :].contiguous()
            stereo_zi = zi2[..., 1, :].contiguous()

        if blend_range is not None:
            lo, hi = blend_range
            p_rms = torch.sqrt(torch.mean(pilot * pilot, dim=-1,
                                          keepdim=True))
            blend = torch.clamp((p_rms - lo) * (1.0 / (hi - lo)), 0.0, 1.0)
            stereo = stereo * blend
        left = 0.5 * (mono + stereo)
        right = 0.5 * (mono - stereo)
        (left, right), de = _deemph(left, right, state.deemph)

        new_state = AudioState(mono_zi=mono_zi, pilot_zi=if_tail,
                               chan_zi=if_tail, stereo_zi=stereo_zi,
                               pll=pll_state, deemph=de)
        return (left, right, mono), new_state

    def _deemph(left, right, carry):
        if deemphasis is None:
            return (left, right), None
        lr = torch.stack([left, right], dim=-2)          # (..., 2, N)
        lr, carry = deemphasize(lr, carry, fs=cfg.audio_fs, tau=deemphasis)
        return (lr[..., 0, :], lr[..., 1, :]), carry

    return audio
