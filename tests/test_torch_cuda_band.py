"""K5's two-stage role over a station map (``csrc/channelizer.cu``:
several stations a slot): the CPU rehearsal of the kernel's plan, index for
index (``test_torch_cuda_channelizer.py::rehearse_two_stage``), held
against the plain version (``composed_channelize_u8_ref`` with the same
map) at the kernel's tolerance; and, marked ``gpu`` (they skip without a
card), the kernel itself on the dense band's plan, 38 stations over 8
slots, and on one station a slot at the same size, against the plain
version on the card, one launch a call, and one launch a step of the
compiled wideband receiver with the map.

The band plan: every second 200 kHz channel from 88.3 to 105.9 MHz but the
7 that lie on a slot edge, around 97.9 MHz at 8 x 2.4 MS/s, mapped to
slots and offsets as ``--wideband 8 --wideband-centers`` maps them: up to
5 stations a slot, at -0.8, -0.4, 0, +0.4 and +0.8 MHz from its centre.
"""

import numpy as np
import pytest
import torch

from rtsdr_tpu_torch import cli
from rtsdr_tpu_torch.config import MODE0
from rtsdr_tpu_torch.ops import channelizer as tch
from rtsdr_tpu_torch.pipeline.frontend import rf_lpf_taps
from test_torch_cuda_channelizer import (
    TOL_K5_REL,
    WB8_OFFSETS,
    rehearse_two_stage,
)

torch.set_num_threads(1)


def band_plan():
    """(slots, offsets) of the 38 stations, in frequency order."""
    edges = {895, 919, 943, 967, 991, 1015, 1039}       # 100 kHz units
    chans = [883 + 4 * i for i in range(45) if 883 + 4 * i not in edges]
    slots, offsets, err = cli._centers_to_offsets(
        MODE0, 8, ",".join(f"{(c - 979) * 100}k" for c in chans))
    assert err is None
    return slots, [float(o) for o in offsets]


def _factored(k, slots, offsets, decim=10):
    stations = tch.station_map(k, slots)
    g, factors = tch.composed_rf_factors(
        k, tch.channelizer_taps(k, 16), rf_lpf_taps(MODE0), decim,
        offsets_hz=offsets, fs_ch=MODE0.rf.fs, stations=stations)
    return g, factors, stations


def test_band_plan_shares_slots():
    slots, offsets = band_plan()
    assert len(slots) == 38 and max(np.bincount(slots)) == 5
    assert sorted(set(offsets)) == [-800e3, -400e3, 0.0, 400e3, 800e3]
    assert np.bincount(slots)[4] == 3           # 87.5, 87.9 below the band


@pytest.mark.parametrize("case", ["band38", "k4", "permuted"])
def test_two_stage_station_map_equals_plain(case):
    """The rehearsal of the kernel over a map: the dense band's 38 stations
    over 8 slots (stage B's items in one turn, tile 48, its taps and
    partial sums past the stage-A planes), 7 stations over 4 slots (one
    empty), and 8 stations one a slot in another order; two captures, 130
    outputs (a ragged last tile), a random byte tail."""
    if case == "band38":
        k, (slots, offsets) = 8, band_plan()
    elif case == "k4":
        k, slots = 4, [0, 0, 0, 1, 1, 3, 3]
        offsets = [-800e3, 0.0, 400e3, -400e3, 800e3, -400e3, 400e3]
    else:
        k, slots = 8, [3, 1, 0, 2, 7, 6, 5, 4]
        offsets = [WB8_OFFSETS[c] for c in slots]
    g, factors, stations = _factored(k, slots, offsets)
    plan = tch.composed_plan(g, 10, factors, stations)
    assert plan.two_stage and plan.slot_of == tuple(slots)
    assert plan.stage_b.shape == (10, 16, len(slots), 2)
    rng = np.random.default_rng(len(slots))
    d, p_out = 10 * k, 130
    zi = rng.integers(0, 256, (2, 2 * (g.shape[1] - 1)), np.uint8)
    raw = rng.integers(0, 256, (2, 2 * d * p_out), np.uint8)
    want, want_tail = tch.composed_channelize_u8_ref(
        torch.as_tensor(raw), g, torch.as_tensor(zi), 10, stations=stations)
    got, tail = rehearse_two_stage(raw, zi, g, 10, factors,
                                   stations=stations)
    tol = TOL_K5_REL * float(np.abs(g).sum(axis=1).max())
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=tol)
    assert np.array_equal(tail, want_tail.numpy())


def test_band38_geometry_two_blocks_an_sm():
    g, factors, stations = _factored(8, *band_plan())
    plan = tch.composed_plan(g, 10, factors, stations)
    geo = tch.two_stage_geometry(plan, 27, 15360)
    assert (geo.tile, geo.ns) == (48, 1)
    assert 2 * geo.smem <= 227 * 1024 and geo.a_elems > 8 * geo.pitch_a
    assert 27 * geo.n_tiles >= 2 * 132


def test_station_map_needs_the_two_stage_role():
    """The shared and own-taps roles take one station a slot: a map without
    g's factors, or a K the two-stage role lacks, raises."""
    g, factors, stations = _factored(8, *band_plan())
    with pytest.raises(ValueError, match="two-stage"):
        tch.composed_plan(g, 10, None, stations)
    g5, f5, st5 = _factored(5, [0, 0, 1, 2, 3, 4],
                            [-400e3, 400e3, 0.0, 0.0, 0.0, 0.0])
    with pytest.raises(ValueError, match="does not take"):
        tch.composed_plan(g5, 10, f5, st5)


# -------------------------------------------------- the kernel, on a card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["band38", "one_a_slot"])
def test_station_map_kernel_on_the_card(card, case):
    """The two-stage role at the dense band's cell shape (27 captures of 8
    x 307,200 bytes): 38 stations over 8 slots, and one station a slot
    (wideband8's plan, the identity map), against the plain version over
    two chained blocks: within TOL_K5_REL * max sum|g|, the byte tail
    exact, one launch a call."""
    from rtsdr_tpu_torch.ops import _cuda

    if case == "band38":
        g, factors, stations = _factored(8, *band_plan())
    else:
        g, factors, stations = _factored(8, range(8), WB8_OFFSETS)
        assert stations is None
    gen = torch.Generator(device=card).manual_seed(23)
    zi = tch.composed_zi_u8(g.shape[1], (27,), card)
    tol = TOL_K5_REL * float(np.abs(g).sum(axis=1).max())
    for _ in range(2):
        raw = torch.randint(0, 256, (27, 8 * MODE0.block_size),
                            generator=gen, device=card, dtype=torch.uint8)
        _cuda.reset_launch_counts()
        y, new_zi = tch.composed_channelize_u8(raw, g, zi, 10, factors,
                                               stations)
        assert _cuda.launch_counts() == {"channelizer.composed_two_stage": 1}
        want, want_zi = tch.composed_channelize_u8_ref(
            raw, g, zi, 10, block=32, stations=stations)
        torch.cuda.synchronize()
        assert tuple(y.shape) == (27, g.shape[0], 2, 15360)
        assert float((y - want).abs().max()) <= tol
        assert torch.equal(new_zi, want_zi)
        zi = new_zi
        del want


@pytest.mark.gpu
def test_band38_receiver_one_launch_a_step(card):
    """The compiled wideband receiver with the map: one K5 launch a step,
    38 stations a capture out."""
    from rtsdr_tpu_torch.ops import _cuda
    from rtsdr_tpu_torch.pipeline.wideband import make_wideband_receiver
    from rtsdr_tpu_torch.utils.jit import jit_step

    slots, offsets = band_plan()
    init, step = jit_step(*make_wideband_receiver(
        MODE0, 8, (2,), channel_offsets_hz=offsets, channel_slots=slots,
        enable_rds=False, device=card), card, name="band38")
    state = init()
    raw = torch.full((2, 8 * MODE0.block_size), 128, dtype=torch.uint8,
                     device=card)
    for _ in range(2):
        state, out = step(state, raw)
    _cuda.reset_launch_counts()
    for _ in range(3):
        state, out = step(state, raw)
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["channelizer.composed_two_stage"] == 3
    assert tuple(out.left.shape) == (2, 38, MODE0.audio_len)
