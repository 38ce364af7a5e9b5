"""Full receiver: one block-step over the whole signal-flow graph.

Counterpart of ``rtsdr_tpu/pipeline/receiver.py``: the complete graph is
ONE function

    step(state, raw_u8) -> (state, outputs)

run under ``torch.no_grad()`` (there is no gradient anywhere in this
system): ``make_receiver``'s step eagerly, ``Receiver``'s (``jit=True``)
compiled as one CUDA graph over donated state (``utils/jit.py``).  uint8 -> float conversion runs on the device: the host
transfers 1 byte per sample.

The complete mode-0 graph: front end, mono + stereo audio, RDS DSP, RDS
bit layer.  The fan-out of the demodulated signal to the audio and RDS
branches is two uses of one tensor.

With ``frontend_impl`` 'auto' or 'fused' the step takes the fused route
for any channel count: one ingest kernel for RF FIR + discriminator + mono
audio (emitting fm only when a later stage needs it), one FIR-bank launch
for the pilot / stereo-channel / RDS-extract band-passes (or, with
``fuse_if_bank``, those three inside the ingest kernel), one FIR-bank
launch for the squared 114 kHz band-pass, ONE PLL launch for the pilot and
the RDS carrier loops, one FIR-bank launch for the stereo mixer + LPF↓5,
one launch for the RDS mixers + resampler + RRC, then the bit layer in
stock tensor ops.  The route depends on the arguments only, never on the
dtype: on a CUDA device the receiver is float32 or building it raises, and
every stage that has a kernel launches it or raises; on the CPU the same
route runs the kernels' plain versions in any dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rtsdr_tpu_torch.config import ReceiverConfig
from rtsdr_tpu_torch.device import require_kernel_dtype, resolve_device
from rtsdr_tpu_torch.ops import coeffs
from rtsdr_tpu_torch.ops.cuda_fir import fir_block_pre
from rtsdr_tpu_torch.ops.cuda_pll import stacked_state
from rtsdr_tpu_torch.ops.fir import fir_block_bank
from rtsdr_tpu_torch.ops.ingestfir import ingest_fir_demod_audio
from rtsdr_tpu_torch.ops.pll import PLLState, pll
from rtsdr_tpu_torch.pipeline.audio import (
    AudioState,
    _audio_taps,
    audio_init,
    audio_lpf_taps,
    make_audio,
)
from rtsdr_tpu_torch.pipeline.frame import (
    FrameOutputs,
    FrameState,
    frame_init,
    make_frame,
)
from rtsdr_tpu_torch.pipeline.frontend import (
    FrontendState,
    frontend_init,
    make_frontend,
    rf_lpf_taps,
)
from rtsdr_tpu_torch.pipeline.rds import RDSState, make_rds, rds_init
from rtsdr_tpu_torch.utils.jit import CompiledStep


class ReceiverState(NamedTuple):
    frontend: FrontendState
    audio: AudioState
    rds: RDSState | None
    frame: FrameState | None


class ReceiverOutputs(NamedTuple):
    left: torch.Tensor    # (..., audio_len) 48 kS/s
    right: torch.Tensor
    mono: torch.Tensor
    rds: FrameOutputs | tuple | None   # tuple: (rrc_i, rrc_q)


def make_receiver(
    cfg: ReceiverConfig,
    batch_shape: tuple = (),
    dtype=torch.float32,
    *,
    enable_rds: bool | None = None,
    enable_frame: bool = True,
    enable_stereo: bool = True,
    offset_mode: str = "hold",
    use_abs_clock: bool = False,
    resync: bool = False,
    error_correct: bool = False,
    pll_impl: str = "auto",
    deemphasis: float | None = None,
    frontend_impl: str = "auto",
    resamp_impl: str = "auto",
    pll_loop_div: int = 1,
    stereo_blend: bool | tuple = False,
    derotate: bool = False,
    fuse_if_bank: bool | str = "auto",
    device="cuda",
):
    """Build ``(init_fn, step_fn)`` for the full receiver.

    ``batch_shape`` prepends channel dimensions: every state leaf and every
    input/output gains those leading dims, and all DSP runs batched (the
    multi-station use case).

    ``step_fn(state, raw_u8)``: raw_u8 is (..., block_size) interleaved
    uint8 IQ on ``device`` — or, with ``frontend_impl='iq'``, float
    (..., 2, iq_len) stacked I/Q (the wideband channelizer's per-channel
    output), with ``'if'`` float (..., 2, if_len) already filtered and
    decimated (the composed channelizer's).  Both take the unfused audio
    route: front end, then the stages below as separate launches.

    ``pll_loop_div``: run the PLL loop-filter recurrence every N-th sample
    with bandwidth-preserving gains (NCO still full-rate); not
    bit-identical to the golden model (see ops/pll.py).  1 (default) =
    golden parity.

    ``fuse_if_bank``: True runs the pilot / stereo-channel / RDS-extract
    band-passes inside the ingest kernel (the demodulated stream then never
    reaches device memory); False runs them as one FIR-bank launch over fm.
    "auto" is False at every channel count: on an NVIDIA H100 80GB HBM3
    (power limit 700 W) the fused step measured 0.2-1.1 % slower at 1,024
    and at 2,048 channels (the stage costs inside the ingest kernel what
    the FIR-bank kernel costs alone, and the saved fm traffic is small
    beside both; PERF.md).

    ``resamp_impl``: only "auto" — mixers + resampler + RRC go by the
    tensor's device (the kernel on a CUDA tensor, its plain version on a
    CPU tensor).
    """
    dev = resolve_device(device)
    require_kernel_dtype(dev, dtype)
    if enable_rds is None:
        enable_rds = cfg.rds is not None
    if enable_rds and cfg.rds is None:
        raise ValueError(f"mode {cfg.mode} has no RDS path")
    if resamp_impl != "auto":
        raise ValueError(
            f"resamp_impl={resamp_impl!r}: the port has one route, chosen "
            "by the tensor's device ('auto')")
    if fuse_if_bank not in (True, False, "auto"):
        raise ValueError(f"fuse_if_bank={fuse_if_bank!r}")

    frontend = make_frontend(cfg, dtype, impl=frontend_impl, device=dev)
    audio = make_audio(cfg, enable_stereo=enable_stereo,
                       pll_impl=pll_impl, deemphasis=deemphasis,
                       pll_loop_div=pll_loop_div,
                       stereo_blend=stereo_blend)

    # Fused ingest + RF FIR + discriminator + mono LPF↓down (one kernel,
    # ops/ingestfir.py): in the mono-only configuration the demodulated
    # stream is never written to device memory at all.
    rf_h = rf_lpf_taps(cfg)
    mono_h = audio_lpf_taps(cfg)
    fuse_audio = frontend_impl in ("auto", "fused") and cfg.mono.up == 1
    rds_fn = (make_rds(cfg, pll_impl=pll_impl, pll_loop_div=pll_loop_div)
              if enable_rds else None)

    # With both stereo and RDS on, three IF-rate band-passes (pilot,
    # stereo channel, RDS extraction) filter the SAME demodulated signal
    # with equal tap counts: one FIR-bank launch reads the input once for
    # all three.  The two PLL instances (stereo pilot x2, RDS carrier
    # x0.5) likewise run as ONE kernel launch with per-lane constants —
    # the sequential recurrence is the chain's latency floor, and two
    # loops side by side cost what one costs.
    if_bank_h = None
    fuse_pll = False
    squared_h = None
    if enable_stereo and enable_rds and cfg.stereo.taps == cfg.rds.taps:
        if_fs = cfg.rf.if_fs
        if_bank_h = [
            coeffs.bandpass_taps(if_fs, cfg.stereo.pilot_lo,
                                 cfg.stereo.pilot_hi, cfg.stereo.taps),
            coeffs.bandpass_taps(if_fs, cfg.stereo.chan_lo,
                                 cfg.stereo.chan_hi, cfg.stereo.taps),
            coeffs.bandpass_taps(if_fs, cfg.rds.extract_lo,
                                 cfg.rds.extract_hi, cfg.rds.taps),
        ]
        fuse_pll = cfg.stereo.nco_delay  # both loops use the delayed view
        if fuse_pll:
            squared_h = coeffs.bandpass_taps(if_fs, cfg.rds.squared_lo,
                                             cfg.rds.squared_hi, cfg.rds.taps)
            sp, rp = cfg.stereo.pll, cfg.rds.pll
            # config axis leads (shape (2, 1, ..., 1)): part 0 is the
            # pilot loop, part 1 the carrier loop
            b1 = (2,) + (1,) * len(batch_shape)
            pll_freqs = np.array([sp.freq, rp.freq]).reshape(b1)
            pll_bws = np.array(
                [sp.norm_bandwidth, rp.norm_bandwidth]).reshape(b1)
            pll_scales = np.array([sp.nco_scale, rp.nco_scale]).reshape(b1)
            pll_adjusts = np.array(
                [sp.phase_adjust, rp.phase_adjust]).reshape(b1)
    frame_fn = None
    if enable_rds and enable_frame:
        frame_fn = make_frame(cfg, offset_mode=offset_mode,
                              use_abs_clock=use_abs_clock, resync=resync,
                              error_correct=error_correct,
                              derotate=derotate)

    # the band-pass bank can share the ingest kernel's fm slots when its
    # look-back fits the halo that kernel computes anyway (stereo taps ==
    # audio taps)
    fuse_bank = (fuse_if_bank is True and if_bank_h is not None
                 and fuse_audio and _audio_taps(cfg) == cfg.stereo.taps)

    def init_fn() -> ReceiverState:
        return ReceiverState(
            frontend=frontend_init(cfg, batch_shape, dtype, dev),
            audio=audio_init(cfg, batch_shape, dtype,
                             enable_stereo=enable_stereo,
                             deemphasis=deemphasis, device=dev),
            rds=rds_init(cfg, batch_shape, dtype, dev) if enable_rds else None,
            frame=(frame_init(cfg, batch_shape, dtype, dev)
                   if frame_fn is not None else None),
        )

    @torch.no_grad()
    def step_fn(state: ReceiverState, raw_u8: torch.Tensor):
        mono_pre = None
        bank_pre = None
        fm_tail = None
        if fuse_audio:
            fe = state.frontend
            out = ingest_fir_demod_audio(
                raw_u8, rf_h, fe.zi_i, fe.zi_q, fe.prev_i, fe.prev_q,
                cfg.rf.decim, mono_h, state.audio.mono_zi, cfg.mono.down,
                emit_fm=(enable_stereo or enable_rds) and not fuse_bank,
                bank_h=if_bank_h if fuse_bank else None,
                bank_zi=state.audio.pilot_zi if fuse_bank else None)
            fm, mono, zi_i, zi_q, pi, pq, mono_zi = out[:7]
            if fuse_bank:
                bank_pre = out[7]
                fm_tail = mono_zi     # == the last taps-1 fm samples
            fe_state = FrontendState(zi_i=zi_i, zi_q=zi_q,
                                     prev_i=pi, prev_q=pq)
            mono_pre = (mono, mono_zi)
        else:
            fm, fe_state = frontend(state.frontend, raw_u8)

        pilot = chan = extract = None
        audio_nco = rds_nco = None
        if if_bank_h is not None:
            if bank_pre is not None:
                pilot, chan, extract = bank_pre
            else:
                (pilot, chan, extract), _ = fir_block_bank(
                    fm, if_bank_h, state.audio.pilot_zi)
            if fuse_pll:
                pre_pll, squared_zi = fir_block_pre(
                    extract, squared_h, state.rds.squared_zi, "square")
                # tuple input: the kernel reads pilot and pre_pll where
                # they lie; the (2, C, N) stacked pair is never made
                st2 = stacked_state((state.audio.pll, state.rds.pll))
                nco_i2, nco_q2, st2 = pll(
                    (pilot, pre_pll), st2, freq=pll_freqs, fs=cfg.rf.if_fs,
                    nco_scale=pll_scales, phase_adjust=pll_adjusts,
                    norm_bandwidth=pll_bws, impl=pll_impl,
                    loop_div=pll_loop_div)
                audio_nco = (nco_i2[0], PLLState(*(v[0] for v in st2)))
                rds_nco = (nco_i2[1], nco_q2[1],
                           PLLState(*(v[1] for v in st2)), squared_zi)
        (left, right, mono), au_state = audio(state.audio, fm,
                                              pilot=pilot, chan=chan,
                                              nco_pre=audio_nco,
                                              mono_pre=mono_pre,
                                              fm_tail=fm_tail)

        rds_state = None
        frame_state = None
        rds_out = None
        if rds_fn is not None:
            (rrc_i, rrc_q), rds_state = rds_fn(state.rds, fm, extract=extract,
                                               nco_pre=rds_nco,
                                               fm_tail=fm_tail)
            if frame_fn is not None:
                rds_out, frame_state = frame_fn(state.frame, rrc_i, rrc_q)
            else:
                rds_out = (rrc_i, rrc_q)

        new_state = ReceiverState(frontend=fe_state, audio=au_state,
                                  rds=rds_state, frame=frame_state)
        return new_state, ReceiverOutputs(left=left, right=right, mono=mono,
                                          rds=rds_out)

    return init_fn, step_fn


class Receiver:
    """Convenience wrapper: ``init()`` and ``step(state, raw_u8)`` on one
    device, the step compiled with its state donated (the JAX package's
    ``jax.jit(step, donate_argnums=0)``).

    ``jit=True`` (the default): ``step`` is a ``utils/jit.py::CompiledStep``.
    On a CUDA device it is captured once as a CUDA graph and replayed per
    block over one static state tree, which it updates in place: the state
    it returns is valid until it is passed back, a state passed after a
    later call raises, and any other state (``init()``, a loaded
    checkpoint) is copied in.  Its outputs belong to the caller.  A block
    passed as its own tensor is copied into the step's static input; a loop
    writes each block into ``rx.step.input_buffer(shape)`` instead and
    passes that, saving the copy::

        raw = rx.step.input_buffer((C, cfg.block_size))
        for block in blocks:
            raw.copy_(block, non_blocking=True)
            state, out = rx.step(state, raw)

    ``jit=False`` runs ``make_receiver``'s eager step, which returns a new
    state tree per step and updates nothing in place (for debugging: each
    stage's launches are then separate calls)."""

    def __init__(self, cfg: ReceiverConfig, batch_shape: tuple = (),
                 dtype=torch.float32, device="cuda", jit: bool = True,
                 **kwargs):
        self.cfg = cfg
        self.batch_shape = batch_shape
        self.device = resolve_device(device)
        self.init_fn, self.step = make_receiver(
            cfg, batch_shape, dtype, device=self.device, **kwargs)
        if jit:
            self.step = CompiledStep(
                self.init_fn, self.step, self.device,
                name=f"Receiver(mode {cfg.mode}, batch {tuple(batch_shape)})")

    def init(self) -> ReceiverState:
        return self.init_fn()
