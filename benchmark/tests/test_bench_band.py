"""The dense band's cell (``band38.resident27``) on the CPU at a small
size: the reference front (``reference/front_band.py``) against a dense
float64 computation written out here; the least-work count
(``roofline/band.py``) against ``roofline/channelizer.py``'s for one
station a slot; the driver's (capture, station) rows; the cell's rehearsal
and control; and planted faults of the wideband front, each reading
``correct`` false.

The faults are planted around ``make_wideband_receiver`` and the composed
channelizer where the driver's receiver calls them
(``rtsdr_tpu_torch.pipeline.wideband``), on a cut of the band (6 of its
stations, 3 in each of 2 slots) so that every stream's first blocks are
compared:

* ``slot_swap``: two stations of different slots take each other's slot;
* ``mix_phase``: the residual NCO's phase is not advanced, with station 0
  8 Hz off the raster (on it every offset turns whole cycles a block, and
  the fault is the same program there);
* ``rf_history``: one station's RF filter starts each block from a zero
  history (its row of the channelizer computed from a blank byte tail).
"""

import copy
import functools
import json

import numpy as np
import pytest
import torch

from benchmark import control
from benchmark.harness import check, core, drive
from benchmark.roofline import band as band_roof
from benchmark.roofline import channelizer as wb_roof
from benchmark.traffic import synth_market

CELL = "band38.resident27"
SEED = 2**32 + 3838
SMALL = {"captures": 1, "distinct_captures": 1, "ring_blocks": 2}
FAULTS = ("slot_swap", "mix_phase", "rf_history")
CUT = [0, 7, 15, 18, 26, 34]        # slot 0 and 5's -0.8 / -0.4 / 0 ... cut


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _config():
    return core.load_json(core.BENCH_DIR, "configs", "band38.json")


def _cut(config: dict) -> dict:
    """The band's stations ``CUT`` only."""
    config = copy.deepcopy(config)
    wb = config["wideband"]
    for key in ("stations_hz", "slots_of", "offsets_hz"):
        wb[key] = [wb[key][j] for j in CUT]
    return config


_MAKE_BAND = synth_market.make_band


@functools.lru_cache(maxsize=4)
def _ring(key: str):
    traffic, config, seed = json.loads(key)
    return _MAKE_BAND(traffic, config, seed)


def _cached_make_band(traffic, config, seed, device="cpu"):
    """``synth_market.make_band`` made once per traffic, configuration and
    seed in this test process (the tests' runs share their small rings)."""
    assert device == "cpu"
    return _ring(json.dumps([traffic, config, seed], sort_keys=True))


# --------------------------------------------------------- reference front

def _dense(raw_blocks, slot, offset, k, fs, taps_per_branch, n):
    """The front's I/Q written out: the prototype band-pass of ``slot``
    over every sample, every K-th kept, the offset mixed out by the
    angle computed directly in float64."""
    from benchmark.reference import golden

    h = golden.lowpass(k * fs, 0.45 * fs, k * taps_per_branch)
    bp = h * np.exp(2j * np.pi * slot * np.arange(len(h)) / k)
    iq = (np.concatenate(raw_blocks).astype(np.float64) - 128.0) / 128.0
    x = np.concatenate([np.zeros(len(h) - 1), iq[0::2] + 1j * iq[1::2]])
    m_all = len(raw_blocks) * n
    y = np.array([np.dot(bp, x[len(h) - 1 + k * m - np.arange(len(h))])
                  for m in range(m_all)])
    return y * np.exp(-2j * np.pi * offset * np.arange(m_all) / fs)


def test_front_equals_a_dense_float64_computation():
    """At K = 4, 4 taps a branch and 60 samples a block: three stations
    (two in one slot, one on its slot's centre) over three chained blocks
    equal the dense computation to 1e-12, the state carried."""
    from benchmark.reference import front_band

    k, n, fs = 4, 60, 2.4e6
    config = {"rf": {"fs": fs}, "block_size": 2 * n,
              "wideband": {"slots": k, "taps_per_branch": 4,
                           "slots_of": [1, 1, 3],
                           "offsets_hz": [-300000, 250000, 0]}}
    front = front_band.Front(config, "float64")
    rng = np.random.default_rng(4)
    raws = [rng.integers(0, 256, 2 * k * n, np.uint8) for _ in range(3)]
    state = front.init(3)
    got = []
    for b in range(3):
        state, i, q = front.step(state, [(raws[b], j) for j in range(3)],
                                 [(j, b) for j in range(3)])
        got.append(i + 1j * q)
    got = np.concatenate(got, axis=1)
    for j, (slot, off) in enumerate(zip([1, 1, 3], [-3e5, 2.5e5, 0.0])):
        want = _dense(raws, slot, off, k, fs, 4, n)
        assert np.max(np.abs(got[j] - want)) < 1e-12
    # another precision rounds
    f32 = front_band.Front(config, "float32")
    _, i32, _ = f32.step(f32.init(1), [(raws[0], 0)], [(0, 0)])
    assert 0 < np.max(np.abs(i32[0] - got[0, :n].real)) < 1e-6


def test_front_rebuilds_a_window_item_to_the_bit():
    config = _config()
    front = check.load_front(config, "float64")
    rng = np.random.default_rng(7)
    raws = [rng.integers(0, 256, 8 * 307200, np.uint8) for _ in range(4)]
    lanes = [0, 37]
    st = front.init(2)
    for b in range(4):
        st, i, q = front.step(st, [(raws[b], j) for j in lanes],
                              [(j, b) for j in range(2)])
    st2 = front.init(2)
    for b in (1, 2, 3):
        st2, i2, q2 = front.step(st2, [(raws[b], j) for j in lanes],
                                 [(j, b) for j in range(2)])
    assert np.array_equal(i, i2) and np.array_equal(q, q2)


# ----------------------------------------------------------- least work

def test_least_work_one_a_slot_equals_the_wideband_count():
    """``roofline/band.py`` on wideband8 (no ``slots_of``: one station a
    slot) counts what ``roofline/channelizer.py`` counts: the two-stage
    role's 19,904 FLOP an output and capture."""
    w8 = core.load_json(core.BENCH_DIR, "configs", "wideband8.json")
    assert band_roof.least_flop_per_output(w8) == \
        wb_roof.least_flop_per_output(w8) == 19904
    assert band_roof.least_flop(w8, 128) == wb_roof.least_flop(w8, 128)
    assert band_roof.least_bytes(w8, 128) == wb_roof.least_bytes(w8, 128)


def test_least_work_of_the_dense_band():
    """38 stations over 8 slots: the slot bank once a slot, 10 (4 x 128 +
    8 x 8^2) = 10,240, and 8 x 151 a station, 45,904, with the 8 centre
    stations cheaper on the composed prototype (4 x 1,328 + 8 x 8 x 8 =
    5,824 against 8 x 151 x 8 + ...): the least 52,304."""
    c = _config()
    assert band_roof.least_flop_per_output(c) == 52304
    d = band_roof.describe(c, 27)
    assert (d["slots"], d["stations"], d["per_slot"]) == (8, 38, 5)
    assert d["bytes"] == 27 * (8 * 307200 + 38 * 2 * 15360 * 4)


# ----------------------------------------------------------------- driver

def test_driver_rows_and_blocks():
    """Stream s decodes station ``s // captures`` of capture ``s %
    captures``; the window items, one in each eighth of the streams, take
    the -0.8 MHz edge first and the +0.8 MHz edge last."""
    from benchmark.drivers import band as driver

    m = driver.Market.__new__(driver.Market)
    m.ring = np.arange(3 * 4 * 5).reshape(3, 4, 5)
    m.capture_of, m.offset = np.arange(27) % 3, np.arange(27) % 4
    m.captures, m.stations = 27, 38
    assert [m.row(s) for s in (0, 26, 27, 1025)] == [
        (0, 0), (26, 0), (0, 1), (26, 37)]
    raw, j = m.block(28, 2)
    assert j == 1 and np.array_equal(raw, m.ring[1, (2 + 1) % 4])
    ctx = core.Ctx(cell={}, config={}, traffic={}, workload={"check": {
        "start_streams": 2, "start_blocks": 4, "window_items": 8,
        "pull_in_blocks": 2}}, seed=SEED, seconds=1.0, trace=False,
        device="cpu")
    samples = drive.Samples(ctx, 1026, rows=[m.row(s) for s in range(1026)])
    offs = _config()["wideband"]["offsets_hz"]
    got = [offs[m.row(c)[1]] for _, c in sorted(samples.pending,
                                                key=lambda p: p[1])]
    assert got[0] == -800000 and got[-1] == 800000
    assert len(set(_config()["wideband"]["slots_of"][m.row(c)[1]]
                   for _, c in samples.pending)) >= 5


# -------------------------------------------------------- the cell itself

def _load_json(config=None, workload=None):
    load = core.load_json
    if workload is not None:
        load = control.with_workload(load, CELL, workload)

    def load_json(*parts):
        if config is not None and parts[-2:] == ("configs", "band38.json"):
            return copy.deepcopy(config)
        return load(*parts)
    return load_json


def _execute(monkeypatch, config=None, workload=None, seconds=2.0):
    monkeypatch.setattr(core, "load_json", _load_json(config, workload))
    monkeypatch.setattr(synth_market, "make_band", _cached_make_band)
    return core.measure(CELL, SEED, seconds, False, device="cpu",
                        overrides=SMALL)


def test_rehearsal_and_control(monkeypatch):
    """The cell end to end on the plain versions (the cut band, every
    stream's first blocks): ``correct``; the control (the reference in
    bfloat16 in the program's place) is not."""
    workload = core.load_json(core.BENCH_DIR, "workloads", CELL + ".json")
    workload["check"]["start_streams"] = len(CUT)
    ctx, run = _execute(monkeypatch, _cut(_config()), workload)
    assert run.channels == len(CUT)
    result = core.finish(ctx, run)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"stations_rt", "setup_s"}
    bf16 = check.reference(ctx.config, "bfloat16", run.block_of, run.items)
    as_program = [dict(it, outputs=r) for it, r in zip(run.items, bf16)]
    numbers = check.compare(as_program, check.reference(
        ctx.config, "float64", run.block_of, as_program),
        ctx.workload["check"]["pull_in_blocks"])
    assert not check.judge(numbers, ctx.workload["limits"])[0], numbers


def plant(kind: str, setattr_) -> None:
    """Put the fault ``kind`` (module docstring) where the driver's
    receiver meets it."""
    from rtsdr_tpu_torch.ops.channelizer import composed_zi_u8
    from rtsdr_tpu_torch.pipeline import wideband

    if kind == "rf_history":
        good_ch = wideband.composed_channelize_u8

        def blank_history(raw, g, zi, *args):
            y, new_zi = good_ch(raw, g, zi, *args)
            y0, _ = good_ch(raw, g, composed_zi_u8(g.shape[1], zi.shape[:-1],
                                                   zi.device), *args)
            y[..., 1, :, :] = y0[..., 1, :, :]
            return y, new_zi
        setattr_(wideband, "composed_channelize_u8", blank_history)
        return
    good = wideband.make_wideband_receiver

    def faulty(cfg, k, *args, **kwargs):
        if kind == "slot_swap":
            slots = list(kwargs["channel_slots"])
            slots[0], slots[3] = slots[3], slots[0]
            kwargs["channel_slots"] = slots
            return good(cfg, k, *args, **kwargs)
        init, step = good(cfg, k, *args, **kwargs)

        def broken(state, raw):
            new, out = step(state, raw)
            return new._replace(mix_phase=state.mix_phase.clone()), out
        return init, broken
    setattr_(wideband, "make_wideband_receiver", faulty)


def _off_raster(config: dict) -> dict:
    """Station 0 8 Hz above the raster: 51,200.512 cycles of its offset
    a block."""
    config = copy.deepcopy(config)
    config["wideband"]["stations_hz"][0] += 8
    config["wideband"]["offsets_hz"][0] += 8
    return config


@pytest.mark.parametrize("kind", FAULTS)
def test_planted_fault_is_not_correct(kind, monkeypatch):
    workload = core.load_json(core.BENCH_DIR, "workloads", CELL + ".json")
    workload["check"]["start_streams"] = len(CUT)
    workload["check"]["window_items"] = 0
    config = _cut(_config())
    if kind == "mix_phase":
        config = _off_raster(config)
    plant(kind, monkeypatch.setattr)
    ctx, run = _execute(monkeypatch, config, workload, seconds=0.5)
    result = core.finish(ctx, run)
    assert not result["correct"], result["checks"]


def test_off_raster_station_without_fault_is_correct(monkeypatch):
    workload = core.load_json(core.BENCH_DIR, "workloads", CELL + ".json")
    workload["check"]["start_streams"] = len(CUT)
    workload["check"]["window_items"] = 0
    ctx, run = _execute(monkeypatch, _off_raster(_cut(_config())), workload,
                        seconds=0.5)
    result = core.finish(ctx, run)
    assert result["correct"], result["checks"]
