"""Full receiver: one block-step over the whole signal-flow graph.

Counterpart of ``rtsdr_tpu/pipeline/receiver.py``: the complete graph is
ONE function

    step(state, raw_u8) -> (state, outputs)

run eagerly under ``torch.no_grad()`` (there is no gradient anywhere in
this system).  uint8 -> float conversion runs on the device: the host
transfers 1 byte per sample.

Ported so far: front end + mono + stereo (``enable_rds=False``).  The RDS
branch (RDS DSP, frame layer, group decode) is the next slice;
``enable_rds=True`` raises rather than running audio only.

With ``frontend_impl`` 'auto' or 'fused' the step takes the fused route
for any channel count: one ingest kernel for RF FIR + discriminator + mono
audio (emitting fm only when stereo needs it), one FIR-bank launch for the
pilot/channel band-pass pair, the PLL kernel, and one FIR-bank launch for
mixer + LPF↓5.  The route depends on the arguments only, never on the
dtype: on a CUDA device the receiver is float32 or building it raises, and
every stage that has a kernel launches it or raises; on the CPU the same
route runs the kernels' plain versions in any dtype.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from rtsdr_tpu_torch.config import ReceiverConfig
from rtsdr_tpu_torch.device import require_kernel_dtype, resolve_device
from rtsdr_tpu_torch.ops.ingestfir import ingest_fir_demod_audio
from rtsdr_tpu_torch.pipeline.audio import (
    AudioState,
    audio_init,
    audio_lpf_taps,
    make_audio,
)
from rtsdr_tpu_torch.pipeline.frontend import (
    FrontendState,
    frontend_init,
    make_frontend,
    rf_lpf_taps,
)


class ReceiverState(NamedTuple):
    frontend: FrontendState
    audio: AudioState
    rds: Any | None      # RDSState, with the RDS slice
    frame: Any | None    # FrameState, with the RDS slice


class ReceiverOutputs(NamedTuple):
    left: torch.Tensor    # (..., audio_len) 48 kS/s
    right: torch.Tensor
    mono: torch.Tensor
    rds: Any              # FrameOutputs | (rrc_i, rrc_q) | None


def make_receiver(
    cfg: ReceiverConfig,
    batch_shape: tuple = (),
    dtype=torch.float32,
    *,
    enable_rds: bool | None = None,
    enable_stereo: bool = True,
    pll_impl: str = "auto",
    deemphasis: float | None = None,
    frontend_impl: str = "auto",
    pll_loop_div: int = 1,
    stereo_blend: bool | tuple = False,
    device="cuda",
):
    """Build ``(init_fn, step_fn)`` for the receiver.

    ``batch_shape`` prepends channel dimensions: every state leaf and every
    input/output gains those leading dims, and all DSP runs batched (the
    multi-station use case).

    ``step_fn(state, raw_u8)``: raw_u8 is (..., block_size) interleaved
    uint8 IQ on ``device``.

    ``pll_loop_div``: run the PLL loop-filter recurrence every N-th sample
    with bandwidth-preserving gains (NCO still full-rate); not
    bit-identical to the golden model (see ops/pll.py).  1 (default) =
    golden parity.
    """
    dev = resolve_device(device)
    require_kernel_dtype(dev, dtype)
    if enable_rds is None:
        enable_rds = cfg.rds is not None
    if enable_rds and cfg.rds is None:
        raise ValueError(f"mode {cfg.mode} has no RDS path")
    if enable_rds:
        raise NotImplementedError(
            "the RDS branch (RDS DSP, frame layer, group decode) is not "
            "ported yet: it belongs to the RDS slice; build the receiver "
            "with enable_rds=False")

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

    def init_fn() -> ReceiverState:
        return ReceiverState(
            frontend=frontend_init(cfg, batch_shape, dtype, dev),
            audio=audio_init(cfg, batch_shape, dtype,
                             enable_stereo=enable_stereo,
                             deemphasis=deemphasis, device=dev),
            rds=None,
            frame=None,
        )

    @torch.no_grad()
    def step_fn(state: ReceiverState, raw_u8: torch.Tensor):
        mono_pre = None
        if fuse_audio:
            fe = state.frontend
            fm, mono, zi_i, zi_q, pi, pq, mono_zi = ingest_fir_demod_audio(
                raw_u8, rf_h, fe.zi_i, fe.zi_q, fe.prev_i, fe.prev_q,
                cfg.rf.decim, mono_h, state.audio.mono_zi, cfg.mono.down,
                emit_fm=enable_stereo)
            fe_state = FrontendState(zi_i=zi_i, zi_q=zi_q,
                                     prev_i=pi, prev_q=pq)
            mono_pre = (mono, mono_zi)
        else:
            fm, fe_state = frontend(state.frontend, raw_u8)

        (left, right, mono), au_state = audio(state.audio, fm,
                                              mono_pre=mono_pre)
        new_state = ReceiverState(frontend=fe_state, audio=au_state,
                                  rds=None, frame=None)
        return new_state, ReceiverOutputs(left=left, right=right, mono=mono,
                                          rds=None)

    return init_fn, step_fn


class Receiver:
    """Convenience wrapper: ``init()`` and ``step(state, raw_u8)`` on one
    device.  Each step returns a new state tree; nothing is updated in
    place."""

    def __init__(self, cfg: ReceiverConfig, batch_shape: tuple = (),
                 dtype=torch.float32, device="cuda", **kwargs):
        self.cfg = cfg
        self.batch_shape = batch_shape
        self.device = resolve_device(device)
        self.init_fn, self.step = make_receiver(
            cfg, batch_shape, dtype, device=self.device, **kwargs)

    def init(self) -> ReceiverState:
        return self.init_fn()
