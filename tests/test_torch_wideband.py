"""The wideband path as a whole: ``rtsdr_tpu_torch``'s 'iq' / 'if' front
ends and its wideband receiver (CPU, plain versions) against the JAX
package's with the same arguments on the same bytes, MODE0 at full width
(K x 307,200-byte blocks), K = 2.

Tolerances: front ends 5e-6 rad on FM-like I/Q (float32 FIR sums and atan2
of the two libraries); wideband audio 2e-4, the JAX test's own bound for its
composed route against its two-stage route (the channelizer's 2,656-term
float32 sums run in another order, and a discriminator, three FIRs and a
locked PLL follow); from a mid-stream state carried over with
``state_from_numpy`` the frame layer's integers equal by value and its
symbols within 1e-3 of their peak.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsdr_tpu.config import MODE0 as JMODE0
from rtsdr_tpu.pipeline import frontend as jfe
from rtsdr_tpu.pipeline import wideband as jwb
from rtsdr_tpu_torch.config import MODE0, MODE1
from rtsdr_tpu_torch.pipeline import frontend as tfe
from rtsdr_tpu_torch.pipeline import wideband as twb
from rtsdr_tpu_torch.pipeline.receiver import ReceiverState
from rtsdr_tpu_torch.utils import signals
from rtsdr_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

torch.set_num_threads(1)

K = 2
OFFSETS = [0.0, 150e3]       # the station sits 150 kHz off slot 1's center


def _tone_amp(x, f, fs=48e3):
    t = np.arange(len(x)) / fs
    return 2 * np.hypot(np.mean(x * np.cos(2 * np.pi * f * t)),
                        np.mean(x * np.sin(2 * np.pi * f * t)))


@pytest.fixture(scope="module")
def capture():
    """(3, K * block_size) u8: an RDS-bearing stereo station 150 kHz off
    the center of slot 1 of a K = 2 capture; slot 0 is empty."""
    n_blocks = 3
    words = signals.ps_station_words(16, 0x4D58, "WIDE RDS")
    wave = signals.rds_baseband(signals.encode_rds_blocks(words))
    raw = signals.wideband_capture_iq(
        n_blocks * MODE0.iq_len, K, {1: dict(rds_wave=wave)},
        MODE0.rf.fs, OFFSETS)
    return raw.reshape(n_blocks, K * MODE0.block_size)


@pytest.mark.parametrize("impl", ["iq", "if"])
def test_frontend_iq_and_if_match_jax(impl):
    """Float I/Q in (a constant-envelope FM signal), fm out, two blocks."""
    n = MODE0.iq_len if impl == "iq" else MODE0.if_len
    fs = MODE0.rf.fs if impl == "iq" else MODE0.rf.if_fs
    t = np.arange(2 * n) / fs
    rows = []
    for f_mod, dev in ((1.1e3, 60e3), (700.0, 40e3)):
        ph = dev / f_mod * np.sin(2 * np.pi * f_mod * t)
        rows.append(np.stack([0.7 * np.cos(ph), 0.7 * np.sin(ph)]))
    x = np.stack(rows).astype(np.float32)            # (2, 2, 2n)
    t_fn = tfe.make_frontend(MODE0, impl=impl, device="cpu")
    j_fn = jfe.make_frontend(JMODE0, impl=impl)
    t_state = tfe.frontend_init(MODE0, (2,), device="cpu")
    j_state = jfe.frontend_init(JMODE0, (2,))
    for b in range(2):
        blk = x[..., b * n:(b + 1) * n]
        t_fm, t_state = t_fn(t_state, torch.as_tensor(blk))
        j_fm, j_state = j_fn(j_state, jnp.asarray(blk))
        assert tuple(t_fm.shape) == (2, MODE0.if_len)
        np.testing.assert_allclose(t_fm.numpy(), np.asarray(j_fm), rtol=0,
                                   atol=5e-6)
        for name in t_state._fields:
            np.testing.assert_allclose(
                getattr(t_state, name).numpy(),
                np.asarray(getattr(j_state, name)), rtol=0, atol=1e-6,
                err_msg=name)
    if impl == "if":        # the FIR state rides along untouched
        assert not t_state.zi_i.any() and not t_state.zi_q.any()


def test_unknown_frontend_raises():
    with pytest.raises(ValueError, match="unknown frontend impl"):
        tfe.make_frontend(MODE0, impl="wide", device="cpu")


@pytest.mark.parametrize("impl", ["composed", "pfb"])
def test_wideband_audio_matches_jax_two_blocks(capture, impl):
    kw = dict(enable_rds=False, channel_offsets_hz=OFFSETS,
              channelizer_impl=impl)
    t_init, t_step = twb.make_wideband_receiver(MODE0, K, device="cpu", **kw)
    j_init, j_step = jwb.make_wideband_receiver(JMODE0, K, **kw)
    t_state, j_state = t_init(), j_init()
    assert isinstance(t_state, twb.WidebandState)
    assert t_state.chan_zi.dtype == torch.uint8
    assert tuple(t_state.chan_zi.shape) == j_state.chan_zi.shape
    for b in range(2):      # the second block carries mix_phase and tails
        t_state, t_out = t_step(t_state, torch.as_tensor(capture[b]))
        j_state, j_out = j_step(j_state, jnp.asarray(capture[b]))
        for name in ("left", "right", "mono"):
            t = getattr(t_out, name).numpy()
            assert t.shape == (K, MODE0.audio_len) and t.dtype == np.float32
            np.testing.assert_allclose(t, np.asarray(getattr(j_out, name)),
                                       rtol=0, atol=2e-4, err_msg=name)
        assert np.array_equal(t_state.chan_zi.numpy(),
                              np.asarray(j_state.chan_zi))
        np.testing.assert_allclose(t_state.mix_phase.numpy(),
                                   np.asarray(j_state.mix_phase), rtol=0,
                                   atol=1e-6)
    assert float(t_state.mix_phase[1]) != 0.0
    # the off-grid station decodes: its tones in slot 1, in stereo
    left, right = t_out.left.numpy()[1], t_out.right.numpy()[1]
    assert _tone_amp(left + right, 1.1e3) / 2 > 0.35
    assert _tone_amp(left - right, 2.3e3) > 0.6


def test_wideband_composed_equals_pfb_within_the_jax_bound(capture):
    outs = {}
    for impl in ("composed", "pfb"):
        init, step = twb.make_wideband_receiver(
            MODE0, K, enable_rds=False, channel_offsets_hz=OFFSETS,
            channelizer_impl=impl, pll_loop_div=4, device="cpu")
        _, out = step(init(), torch.as_tensor(capture[0]))
        outs[impl] = out.left.numpy()
    np.testing.assert_allclose(outs["composed"], outs["pfb"], rtol=0,
                               atol=2e-4)


def _frame_leaves_equal(t_fo, j_fo, what):
    for name in t_fo._fields:
        t = getattr(t_fo, name).numpy()
        j = np.asarray(getattr(j_fo, name))
        assert t.shape == j.shape, (what, name)
        if j.dtype.kind in "biu":
            assert np.array_equal(t, j), (what, name)
        else:
            np.testing.assert_allclose(
                t, j, rtol=0, atol=1e-3 * float(np.max(np.abs(j))),
                err_msg=f"{what} {name}")


def test_wideband_rds_from_converted_midstream_state(capture):
    """State carried across: the JAX wideband receiver runs block 0, its
    ``WidebandState`` goes through numpy into the port (``chan_zi`` bytes,
    the nested receiver state, ``mix_phase``), the bit layer restarts on
    both, and blocks 1 and 2 run in both: audio close, frame outputs equal
    by value."""
    kw = dict(channel_offsets_hz=OFFSETS, resync=True)
    t_init, t_step = twb.make_wideband_receiver(MODE0, K, device="cpu", **kw)
    j_init, j_step = jwb.make_wideband_receiver(JMODE0, K, **kw)
    j_state, _ = j_step(j_init(), jnp.asarray(capture[0]))
    j_state = j_state._replace(
        rx=j_state.rx._replace(frame=j_init().rx.frame))
    j_numpy = jax.tree.map(np.asarray, j_state)
    t_state = state_from_numpy(j_numpy, device="cpu")
    assert isinstance(t_state, twb.WidebandState)
    assert isinstance(t_state.rx, ReceiverState)
    assert t_state.chan_zi.dtype == torch.uint8
    back = state_to_numpy(t_state)
    assert np.array_equal(back.chan_zi, j_numpy.chan_zi)
    assert np.array_equal(back.mix_phase, j_numpy.mix_phase)
    assert np.array_equal(back.rx.rds.resamp_zi, j_numpy.rx.rds.resamp_zi)
    syncs = 0
    for b in (1, 2):
        t_state, t_out = t_step(t_state, torch.as_tensor(capture[b]))
        j_state, j_out = j_step(j_state, jnp.asarray(capture[b]))
        np.testing.assert_allclose(t_out.left.numpy(),
                                   np.asarray(j_out.left), rtol=0, atol=2e-4)
        _frame_leaves_equal(t_out.rds, j_out.rds, f"block {b}")
        syncs += int(t_out.rds.is_sync[1].sum())
        assert tuple(t_out.rds.syndrome_id.shape)[0] == K
    assert syncs >= 4           # slot 1's station is being decoded


def test_wideband_auto_rule_and_refusals():
    """'auto' is 'composed' whenever the geometry allows it (as in the JAX
    package), whatever the channel count; float64 takes the complex
    phase-plane path; sharding the channels takes a device per equal
    group of slots (parallel/channels.py drives it)."""
    for k in (1, 2, 16):
        init, _ = twb.make_wideband_receiver(MODE0, k, enable_rds=False,
                                             device="cpu")
        g_len = 150 * k + 16 * k
        assert tuple(init().chan_zi.shape) == (2 * (g_len - 1),)
        assert init().mix_phase is None
    init, _ = twb.make_wideband_receiver(MODE1, 2, device="cpu")
    assert init().rx.rds is None and init().chan_zi.dtype == torch.uint8
    init, step = twb.make_wideband_receiver(
        MODE0, 2, (), torch.float64, enable_rds=False, enable_stereo=False,
        device="cpu")
    assert init().chan_zi.dtype == torch.complex128
    with pytest.raises(ValueError, match="ineligible"):
        twb.make_wideband_receiver(MODE0, 2, (), torch.float64,
                                   channelizer_impl="composed", device="cpu")
    with pytest.raises(ValueError, match="channelizer_impl"):
        twb.make_wideband_receiver(MODE0, 2, channelizer_impl="fft",
                                   device="cpu")
    with pytest.raises(ValueError, match="need 2 offsets"):
        twb.make_wideband_receiver(MODE0, 2, channel_offsets_hz=[0.0],
                                   device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        twb.make_wideband_receiver(MODE0, 2, channel_sharding=["cpu"] * 3,
                                   device="cpu")
    init, _ = twb.make_wideband_receiver(
        MODE0, 2, enable_rds=False, channel_sharding=["cpu", "cpu"],
        device="cpu")
    rx = init().rx
    assert isinstance(rx, tuple) and len(rx) == 2
    assert rx[0].frontend.prev_i.shape == (1,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            twb.make_wideband_receiver(MODE0, 2)


def test_wideband_float64_path_close_to_float32(capture):
    outs = []
    for dtype in (torch.float32, torch.float64):
        init, step = twb.make_wideband_receiver(
            MODE0, K, (), dtype, enable_rds=False, enable_stereo=False,
            channel_offsets_hz=OFFSETS, device="cpu")
        _, out = step(init(), torch.as_tensor(capture[0]))
        assert out.mono.dtype == dtype
        outs.append(out.mono.double().numpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=2e-4)


@pytest.mark.parametrize("mode", [0, 1])
def test_synthesized_capture_decodes_in_its_slots(mode):
    """The wideband-capture synthesizer puts each station where it says:
    K = 4, stations in slots 1 (1.1 kHz) and 3 (0.7 kHz; mode 0): each tone
    decodes in its own slot and not in the other station's.  An empty slot
    is not silent — FM demodulation is amplitude-blind, so the neighbours'
    leak under the quantization noise demodulates to a partially coherent
    residual — but stays well apart from a live one (the JAX package's
    mode-1 test asserts the same separation).  In mode 1 (2.5 MS/s, x24/125
    audio) one station, as that test has it."""
    cfg = (MODE0, MODE1)[mode]
    k, n_blocks = 4, 2
    stations = {1: dict(mono_hz=1.1e3)}
    if mode == 0:
        stations[3] = dict(mono_hz=0.7e3)
    raw = signals.wideband_capture_iq(n_blocks * cfg.iq_len, k, stations,
                                      cfg.rf.fs)
    assert raw.dtype == np.uint8 and raw.shape == (n_blocks * k
                                                   * cfg.block_size,)
    init, step = twb.make_wideband_receiver(
        cfg, k, enable_rds=False, pll_loop_div=8, device="cpu")
    state = init()
    wbs = k * cfg.block_size
    for b in range(n_blocks):
        state, out = step(state, torch.as_tensor(raw[b * wbs:(b + 1) * wbs]))
    audio = out.left.numpy()
    assert audio.shape == (k, cfg.audio_len)
    a_11 = [_tone_amp(audio[ch], 1.1e3) for ch in range(k)]
    a_07 = [_tone_amp(audio[ch], 0.7e3) for ch in range(k)]
    assert a_11[1] > 0.35, a_11
    if mode == 0:
        assert a_07[3] > 0.35, a_07
        assert a_11[3] < 0.05 and a_07[1] < 0.05, (a_11, a_07)  # crosstalk
        assert max(a_11[0], a_11[2], a_07[0], a_07[2]) < 0.15, (a_11, a_07)
    else:
        assert a_11[3] < 0.12, a_11
