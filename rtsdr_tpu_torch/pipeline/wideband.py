"""Wideband multi-station receiver: PFB channelizer + batched receivers.

Counterpart of ``rtsdr_tpu/pipeline/wideband.py``: one wideband capture at
``K x`` the mode's RF rate is split by the polyphase channelizer
(ops/channelizer.py) into K complex basebands at exactly the station rate,
and ALL K stations decode in one step through the standard batched
receiver (mono + stereo + RDS + frame sync per channel).  Channel k sits at
center frequency ``k * fs_w / K`` (wrapped;
ops.channelizer.channel_center_freqs).

Two front doors:
  * 'composed' — channelizer and per-station RF low-pass ↓10 as ONE complex
    FIR bank straight from the bytes (the hand-written kernel
    ``csrc/channelizer.cu`` on a CUDA tensor); the receivers start at the
    discriminator (``frontend_impl='if'``) and the off-grid residual NCO
    runs at the IF rate.
  * 'pfb' — the two-stage path: channelize to the channel rate (one banded
    matrix product, stock ops), mix there, per-station float RF FIR
    (``frontend_impl='iq'``: the FIR-bank kernel at stride 10).  It remains
    for ragged lengths, float64, and as the parity oracle.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rtsdr_tpu_torch.config import ReceiverConfig
from rtsdr_tpu_torch.device import require_kernel_dtype, resolve_device
from rtsdr_tpu_torch.ops.channelizer import (
    channelizer_taps,
    channelizer_zi,
    channelizer_zi_u8,
    composed_channelize_u8,
    composed_rf_taps,
    composed_zi_u8,
    pfb_channelize,
    pfb_channelize_u8,
)
from rtsdr_tpu_torch.ops.ingestfir import normalize_deinterleave
from rtsdr_tpu_torch.pipeline.frontend import rf_lpf_taps
from rtsdr_tpu_torch.pipeline.receiver import ReceiverState, make_receiver
from rtsdr_tpu_torch.utils.shards import step_shards


class WidebandState(NamedTuple):
    chan_zi: torch.Tensor    # channelizer carried input tail (bytes/complex)
    rx: ReceiverState | tuple  # batched per-channel receiver state (with
    #                            channel_sharding: one per shard)
    mix_phase: torch.Tensor | None = None  # (K,) carried residual-NCO phase

    def shard_axis(self, field: str) -> int:
        """The row axis of the shard tuple in ``field`` (only ``rx`` holds
        one): each shard's stations lie on the axis after the batch dims,
        ``chan_zi``'s (``(*batch, tail)``)."""
        return self.chan_zi.dim() - 1


class ShardedStages(NamedTuple):
    """The stages of a channel-sharded wideband step, which
    ``parallel/channels.py::compose_wideband`` compiles one part per device
    from: ``front(state, raw_u8) -> (iq, chan_zi, mix_phase)`` (the
    channelizer and the residual NCO) and each station shard's receiver
    step over its ``k_sh`` stations of ``iq``'s axis ``k_axis``."""

    front: object
    steps: tuple
    k_axis: int
    k_sh: int


def make_wideband_receiver(
    cfg: ReceiverConfig,
    n_rf_channels: int,
    batch_shape: tuple = (),
    dtype=torch.float32,
    taps_per_branch: int = 16,
    channel_sharding=None,
    channel_offsets_hz=None,
    channelizer_impl: str = "auto",
    device="cuda",
    **receiver_kwargs,
):
    """Build ``(init_fn, step_fn)`` for a K-channel wideband receiver.

    ``step_fn(state, raw_u8)``: raw_u8 is (..., K * cfg.block_size)
    interleaved uint8 IQ at ``fs_w = K * cfg.rf.fs`` on ``device``.
    Outputs are the standard ``ReceiverOutputs`` with a trailing (..., K)
    channel batch dim prepended to each leaf's time axis.

    ``channel_offsets_hz``: optional length-K residual frequency offset
    per slot — OFF-GRID station support.  A real band's 100/200 kHz
    raster does not align with the ``k * fs_w / K`` channel grid; slot k's
    baseband is post-mixed by ``exp(-2j*pi*offset_k*m/fs_ch)`` with a
    carried per-slot NCO phase so blocks chain continuously.  The PFB
    prototype passes stations up to ~±(0.45*fs_ch - 100 kHz) off-center.

    ``channelizer_impl``: 'composed', 'pfb', or 'auto' = 'composed' whenever
    the geometry allows it (float32, the per-channel block a multiple of 32
    and of the RF decimation, the IF block a multiple of 16) — never chosen
    by the channel count or by what happens to build.

    ``channel_sharding``: optional sequence of devices (repeats allowed,
    ``parallel/channels.py::make_wideband_sharded_receiver``): the K
    stations split into that many equal contiguous groups, each decoded on
    its device; the channelizer runs on ``device``.  ``state.rx`` is then a
    tuple of the groups' receiver states, and outputs are gathered on
    ``device`` in station order; ``step_fn.stages`` (``ShardedStages``)
    holds the step's stages.
    """
    dev = resolve_device(device)
    require_kernel_dtype(dev, dtype)
    k = n_rf_channels
    shard_devs = None
    if channel_sharding is not None:
        shard_devs = [resolve_device(d) for d in channel_sharding]
        for d in shard_devs:
            require_kernel_dtype(d, dtype)
        if not shard_devs or k % len(shard_devs):
            raise ValueError(f"{k} RF channels not divisible by "
                             f"{len(shard_devs)} shards")
    h = np.asarray(channelizer_taps(k, taps_per_branch))
    taps = len(h)

    offs = None
    if channel_offsets_hz is not None:
        offs = np.asarray(channel_offsets_hz, np.float64)
        if offs.shape != (k,):
            raise ValueError(f"need {k} offsets, got {offs.shape}")
        if not np.any(offs):
            offs = None

    cdtype = torch.complex64 if dtype == torch.float32 else torch.complex128
    # The raw-byte banded-matmul channelizer needs whole output blocks and
    # f32; the complex phase-plane path remains for ragged lengths and the
    # f64 oracle.
    m_per_block = cfg.block_size // 2  # per-channel samples per step
    use_u8 = dtype == torch.float32 and m_per_block % 32 == 0

    if channelizer_impl not in ("auto", "composed", "pfb"):
        raise ValueError(f"unknown channelizer_impl {channelizer_impl!r}")
    p_if = m_per_block // cfg.rf.decim
    composed_ok = (use_u8 and m_per_block % cfg.rf.decim == 0
                   and p_if % 16 == 0)
    if channelizer_impl == "auto":
        channelizer_impl = "composed" if composed_ok else "pfb"
    elif channelizer_impl == "composed" and not composed_ok:
        raise ValueError("geometry ineligible for the composed channelizer")
    use_composed = channelizer_impl == "composed"

    rx_kw = dict(frontend_impl="if" if use_composed else "iq",
                 **receiver_kwargs)
    if shard_devs is None:
        init_rx, step_rx = make_receiver(cfg, (*batch_shape, k), dtype,
                                         device=dev, **rx_kw)
    else:
        k_sh = k // len(shard_devs)
        shard_rx = [make_receiver(cfg, (*batch_shape, k_sh), dtype,
                                  device=d, **rx_kw) for d in shard_devs]
        k_axis = len(batch_shape)     # the station axis of every leaf

        def init_rx():
            return tuple(init() for init, _ in shard_rx)

        def step_rx(states, iq):
            return step_shards(
                [step for _, step in shard_rx], states,
                (iq.narrow(k_axis, g * k_sh, k_sh).to(d)
                 for g, d in enumerate(shard_devs)), dev, dim=k_axis)

    if use_composed:
        g_taps = composed_rf_taps(k, h, rf_lpf_taps(cfg), cfg.rf.decim,
                                  offsets_hz=offs, fs_ch=cfg.rf.fs)

    # per-sample NCO increment and its per-block phase advance are static
    # (offsets are config, not data), so the carried phase stays small
    # and float32-exact wrapping is done in float64 at build time
    if offs is not None:
        mix_step = -2.0 * np.pi * offs / cfg.rf.fs          # rad/sample
        blk_adv = torch.as_tensor(
            np.mod(mix_step * m_per_block, 2.0 * np.pi), dtype=dtype,
            device=dev)
        # NCO ramp reduced mod 2pi in float64 AT BUILD TIME: step*m is
        # data-independent, and evaluating it in f32 lets the angle grow
        # to |step|*m_per_block rad — at a 1 MHz residual offset that is
        # ~4e5 rad where the f32 ulp is 0.03 rad.  Reduced, the in-step
        # angle stays bounded by 4pi.
        # composed path: the shift is folded into the taps and the
        # residual NCO runs at the IF rate (decim x fewer samples)
        n_mix = p_if if use_composed else m_per_block
        step_mix = mix_step * (cfg.rf.decim if use_composed else 1)
        mix_ramp = torch.as_tensor(
            np.mod(np.asarray(step_mix, np.float64)[:, None]
                   * np.arange(n_mix, dtype=np.float64), 2.0 * np.pi),
            dtype=dtype, device=dev)

    def init_fn() -> WidebandState:
        if use_composed:
            chan_zi = composed_zi_u8(g_taps.shape[1], batch_shape, dev)
        elif use_u8:
            chan_zi = channelizer_zi_u8(k, taps, batch_shape, dev)
        else:
            chan_zi = channelizer_zi(k, taps, batch_shape, cdtype, dev)
        mix_phase = (torch.zeros((k,), dtype=dtype, device=dev)
                     if offs is not None else None)
        return WidebandState(chan_zi=chan_zi, rx=init_rx(),
                             mix_phase=mix_phase)

    @torch.no_grad()
    def front_fn(state: WidebandState, raw_u8: torch.Tensor):
        """The channelizer and the residual NCO: the receivers' input and
        the new ``chan_zi`` and ``mix_phase``."""
        if use_composed:
            raw_iq, chan_zi = composed_channelize_u8(
                raw_u8, g_taps, state.chan_zi, cfg.rf.decim)
        elif use_u8:
            raw_iq, chan_zi = pfb_channelize_u8(raw_u8, h, state.chan_zi, k)
        else:
            iq = normalize_deinterleave(raw_u8, dtype)
            x = torch.complex(iq[..., 0, :], iq[..., 1, :]).to(cdtype)
            y, chan_zi = pfb_channelize(x, h, state.chan_zi, k)
            # (..., M, K) -> (..., K, 2, M): per-channel stacked I/Q at
            # the station rate, the receiver's 'iq' frontend input
            y = torch.movedim(y, -1, -2)
            raw_iq = torch.stack([y.real, y.imag], dim=-2).to(dtype)
        mix_phase = state.mix_phase
        if offs is not None:
            # residual per-slot downconversion: (I + jQ) *
            # exp(j*(phase_k + step_k*m)), the ramp pre-reduced mod 2pi in
            # float64 (see mix_ramp above)
            ang = state.mix_phase[:, None] + mix_ramp
            c, s = torch.cos(ang), torch.sin(ang)     # (K, M)
            i_in = raw_iq[..., 0, :]
            q_in = raw_iq[..., 1, :]
            raw_iq = torch.stack([i_in * c - q_in * s,
                                  i_in * s + q_in * c], dim=-2)
            mix_phase = torch.remainder(state.mix_phase + blk_adv,
                                        2.0 * np.pi)
        return raw_iq, chan_zi, mix_phase

    @torch.no_grad()
    def step_fn(state: WidebandState, raw_u8: torch.Tensor):
        raw_iq, chan_zi, mix_phase = front_fn(state, raw_u8)
        rx_state, out = step_rx(state.rx, raw_iq)
        return WidebandState(chan_zi=chan_zi, rx=rx_state,
                             mix_phase=mix_phase), out

    if shard_devs is not None:
        step_fn.stages = ShardedStages(
            front_fn, tuple(step for _, step in shard_rx), k_axis, k_sh)
    return init_fn, step_fn
