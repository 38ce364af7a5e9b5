"""K5's two-stage role over a station map (``csrc/channelizer.cu``:
several stations a slot): the CPU rehearsal of the kernel's plan, index for
index (``test_torch_cuda_channelizer.py::rehearse_two_stage``), held
against the plain version (``composed_channelize_u8_ref`` with the same
map) at the kernel's tolerance, with and without the residual NCO turned
in its epilogue (against the plain version followed by the stock mix,
``residual_mix``); and, marked ``gpu`` (they skip without a card), the
kernel itself on the dense band's plan, 38 stations over 8 slots, and on
one station a slot at the same size, against the plain version on the
card, with and without the epilogue's turn, one launch a call, and one
launch a step of the compiled wideband receiver with the map, whose
replay makes fewer device launches than with the NCO in stock ops.

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


def nco(offsets, p_out, carried, device="cpu"):
    """The residual NCO's (phase, ramp) at the IF rate as
    ``make_wideband_receiver`` builds them: each station's angle at P
    outputs reduced mod 2 pi in float64, then float32; a carried phase in
    [0, 2 pi) (``carried``) or zeros."""
    step = -2.0 * np.pi * np.asarray(offsets) / MODE0.rf.fs * MODE0.rf.decim
    ramp = np.mod(step[:, None] * np.arange(p_out), 2.0 * np.pi)
    phase = (np.random.default_rng(len(offsets)).uniform(
        0.0, 2.0 * np.pi, len(offsets)) if carried
        else np.zeros(len(offsets)))
    return (torch.as_tensor(phase.astype(np.float32)).to(device),
            torch.as_tensor(ramp.astype(np.float32)).to(device))


def _plan_of(case):
    """(slots, offsets) of the dense band or of wideband8's one a slot."""
    return band_plan() if case == "band38" else (list(range(8)), WB8_OFFSETS)


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


@pytest.mark.parametrize("case", ["band38", "wideband8"])
def test_two_stage_epilogue_mix_equals_plain_plus_stock_mix(case):
    """The rehearsal with the epilogue's turn, on the dense band's plan
    and on wideband8's, each station's carried phase not zero: within the
    kernel's tolerance of the plain version followed by the stock mix,
    which the wrapper's CPU route gives bit for bit."""
    slots, offsets = _plan_of(case)
    g, factors, stations = _factored(8, slots, offsets)
    rng = np.random.default_rng(24 + len(slots))
    d, p_out = 80, 130
    zi = torch.as_tensor(
        rng.integers(0, 256, (2, 2 * (g.shape[1] - 1)), np.uint8))
    raw = torch.as_tensor(rng.integers(0, 256, (2, 2 * d * p_out), np.uint8))
    phase, ramp = nco(offsets, p_out, carried=True)
    plain, _ = tch.composed_channelize_u8_ref(raw, g, zi, 10,
                                              stations=stations)
    want = tch.residual_mix(plain, phase, ramp)
    got, tail = rehearse_two_stage(raw.numpy(), zi.numpy(), g, 10, factors,
                                   stations=stations,
                                   mix=(phase.numpy(), ramp.numpy()))
    tol = TOL_K5_REL * float(np.abs(g).sum(axis=1).max())
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=tol)
    assert float((plain - want).abs().max()) > 100 * tol   # it turns
    y, new_zi = tch.composed_channelize_u8(raw, g, zi, 10, factors,
                                           stations, mix=(phase, ramp))
    assert torch.equal(y, want)
    assert np.array_equal(tail, new_zi.numpy())


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
@pytest.mark.parametrize("case", ["band38", "wideband8"])
def test_epilogue_mix_on_the_card(card, case):
    """K5 with the residual NCO at the cells' shapes (band38: 27 captures
    of 38 stations; wideband8: 128 captures, one a slot) over two chained
    blocks, the phase carried as the receiver carries it: within
    TOL_K5_REL * max sum|g| of the plain version followed by the stock
    mix, and of the kernel without it followed by the stock mix; one
    launch a call."""
    from rtsdr_tpu_torch.ops import _cuda

    slots, offsets = _plan_of(case)
    n_cap = 27 if case == "band38" else 128
    g, factors, stations = _factored(8, slots, offsets)
    p_out = MODE0.block_size // 2 // MODE0.rf.decim
    phase, ramp = nco(offsets, p_out, carried=True, device=card)
    adv = torch.as_tensor(np.mod(                   # a block's advance
        -2.0 * np.pi * np.asarray(offsets) / MODE0.rf.fs
        * (MODE0.block_size // 2), 2.0 * np.pi).astype(np.float32)).to(card)
    gen = torch.Generator(device=card).manual_seed(24)
    zi = tch.composed_zi_u8(g.shape[1], (n_cap,), card)
    tol = TOL_K5_REL * float(np.abs(g).sum(axis=1).max())
    for _ in range(2):
        raw = torch.randint(0, 256, (n_cap, 8 * MODE0.block_size),
                            generator=gen, device=card, dtype=torch.uint8)
        _cuda.reset_launch_counts()
        y, new_zi = tch.composed_channelize_u8(
            raw, g, zi, 10, factors, stations, mix=(phase, ramp))
        assert _cuda.launch_counts() == {"channelizer.composed_two_stage": 1}
        bare, _ = tch.composed_channelize_u8(raw, g, zi, 10, factors,
                                             stations)
        want, want_zi = tch.composed_channelize_u8_ref(
            raw, g, zi, 10, block=32, stations=stations)
        want = tch.residual_mix(want, phase, ramp)
        torch.cuda.synchronize()
        assert float((y - want).abs().max()) <= tol
        assert float((y - tch.residual_mix(bare, phase, ramp)).abs().max()
                     ) <= tol
        assert torch.equal(new_zi, want_zi)
        zi = new_zi
        phase = torch.remainder(phase + adv, 2.0 * np.pi)
        del want, bare


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["band38", "wideband8"])
def test_two_stage_without_mix_writes_the_bank(card, case):
    """Without ``mix`` the kernel writes what the bank gives: the same
    bits as with a phase and ramp of zeros (a turn by exp(j0), every
    product and sum exact)."""
    slots, offsets = _plan_of(case)
    g, factors, stations = _factored(8, slots, offsets)
    p_out = MODE0.block_size // 2 // MODE0.rf.decim
    zero = (torch.zeros(len(slots), device=card),
            torch.zeros((len(slots), p_out), device=card))
    gen = torch.Generator(device=card).manual_seed(25)
    zi = tch.composed_zi_u8(g.shape[1], (27,), card)
    raw = torch.randint(0, 256, (27, 8 * MODE0.block_size), generator=gen,
                        device=card, dtype=torch.uint8)
    y, new_zi = tch.composed_channelize_u8(raw, g, zi, 10, factors, stations)
    y0, new_zi0 = tch.composed_channelize_u8(raw, g, zi, 10, factors,
                                             stations, mix=zero)
    torch.cuda.synchronize()
    assert torch.equal(y, y0) and torch.equal(new_zi, new_zi0)


def _device_launches(fn, steps=3):
    """Device events (kernels, copies, fills) a call of ``fn`` in a
    profiler trace, counted as ``chip_smoke.py`` counts them."""
    from rtsdr_tpu_torch.utils import trace

    fn()
    torch.cuda.synchronize()
    with trace.profile() as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    n = 0
    for e in prof.key_averages():
        us = max((float(getattr(e, k)) for k in (
            "self_device_time_total", "self_cuda_time_total")
            if hasattr(e, k)), default=0.0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            n += e.count
    return n / steps


@pytest.mark.gpu
def test_band38_receiver_one_launch_a_step(card, monkeypatch):
    """The compiled wideband receiver with the map: one K5 launch a step,
    38 stations a capture out, and the ``rtsdr.channelize`` spans of the
    capture (its warm-ups and graph) read 38 stations turned in K5
    (``mix``); its replay makes at least 8 device launches fewer than the
    same step with the residual NCO in stock ops after K5 (the route
    before the fold: an add, cos, sin, four multiplies, a subtract, an add
    and a stack)."""
    from rtsdr_tpu_torch.ops import _cuda
    from rtsdr_tpu_torch.pipeline import wideband
    from rtsdr_tpu_torch.pipeline.wideband import make_wideband_receiver
    from rtsdr_tpu_torch.utils import trace
    from rtsdr_tpu_torch.utils.jit import jit_step

    slots, offsets = band_plan()
    raw = torch.full((2, 8 * MODE0.block_size), 128, dtype=torch.uint8,
                     device=card)

    def launches_a_step():
        init, step = jit_step(*make_wideband_receiver(
            MODE0, 8, (2,), channel_offsets_hz=offsets, channel_slots=slots,
            enable_rds=False, device=card), card, name="band38")
        held = [init()]

        def one():
            held[0], out = step(held[0], raw)
            return out

        trace.clear()
        with trace.profile():
            one()
        turned = {r["attrs"]["mix"] for r in trace.recorded()
                  if r["name"] == "rtsdr.channelize"}
        trace.clear()
        one()
        _cuda.reset_launch_counts()
        for _ in range(3):
            out = one()
        torch.cuda.synchronize()
        assert _cuda.launch_counts()["channelizer.composed_two_stage"] == 3
        assert tuple(out.left.shape) == (2, 38, MODE0.audio_len)
        return turned, _device_launches(one)

    def bank_then_stock_mix(*args):       # front_fn's call, mix last
        *bank, mix = args
        y, zi = tch.composed_channelize_u8(*bank)
        return tch.residual_mix(y, *mix), zi

    turned, fused = launches_a_step()
    assert turned == {38}
    monkeypatch.setattr(wideband, "composed_channelize_u8",
                        bank_then_stock_mix)
    turned, stock = launches_a_step()
    assert turned == {0}
    assert fused <= stock - 8, (fused, stock)
