"""The wideband cell (``wideband8.resident128``) on the CPU at a small size
(2 captures x 8 slots, a few blocks): the reference front
(``reference/front_channelizer.py``) with the golden receiver against the
port's wideband receiver; the front's window-item rebuild; the driver's
(capture, slot) rows; the traffic's determinism and band plan; the cell's
rehearsal and control; and planted faults of the wideband front, each
reading ``correct`` false.

The faults are planted here, around ``make_wideband_receiver`` where the
driver looks it up (``rtsdr_tpu_torch.pipeline.wideband``):

* ``chan_zi``: the channelizer's byte tail is not carried (each step
  starts from the tail it was given);
* ``mix_phase``: the residual NCO's phase is not advanced;
* ``offset_sign``: slot 0's offset is mixed out with the wrong sign.

On the band plan's 200 kHz raster every offset turns a whole number of
cycles in a 64 ms block (200 kHz x 64 ms = 12,800), so the carried phase
is 0 at every block's start and a phase never advanced is the same
program there: its test moves slot 0's station 8 Hz off the raster
(12,800.512 cycles a block), where the carry decides every block.
"""

import copy

import numpy as np
import pytest
import torch

from benchmark import control
from benchmark.harness import check, core, drive
from benchmark.reference import golden
from benchmark.traffic import synth_band

CELL = "wideband8.resident128"
SEED = 2**31 + 1919
SMALL = {"captures": 2, "distinct_captures": 2, "ring_blocks": 4}
FAULTS = ("chan_zi", "mix_phase", "offset_sign")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _config():
    return core.load_json(core.BENCH_DIR, "configs", "wideband8.json")


def _traffic(**kw):
    return {**core.load_json(core.BENCH_DIR, "traffic", "band128.json"),
            **SMALL, **kw}


@pytest.fixture(scope="module")
def band():
    """The small ring: 2 distinct captures of 4 blocks."""
    ring, capture_of, offset, params, _ = synth_band.make_band(
        _traffic(), _config(), SEED)
    return ring, capture_of, offset, params


def _port_run(config, blocks, dtype, impl):
    """The port's wideband receiver over ``blocks`` (n, captures, bytes):
    each step's outputs on the host."""
    from rtsdr_tpu_torch.pipeline.wideband import make_wideband_receiver

    wb = config["wideband"]
    init, step = make_wideband_receiver(
        core.port_config(config), wb["slots"], (blocks.shape[1],), dtype,
        taps_per_branch=wb["taps_per_branch"],
        channel_offsets_hz=wb["offsets_hz"], channelizer_impl=impl,
        device="cpu", **core.receiver_kwargs(config))
    state = init()
    outs = []
    for b in range(len(blocks)):
        state, out = step(state, torch.as_tensor(blocks[b]))
        outs.append(out)
    return outs


def _golden_run(config, precision, captures, n_blocks):
    """The reference front and the golden receiver over every (capture,
    slot) lane from the initial state: each block's outputs."""
    k = config["wideband"]["slots"]
    lanes = [(c, s) for c in range(len(captures)) for s in range(k)]
    front = check.load_front(config, precision)
    rx = golden.Receiver(config, precision)
    fst, st = front.init(len(lanes)), rx.init(len(lanes))
    outs = []
    for b in range(n_blocks):
        fst, i, q = front.step(fst, [(captures[c][b], s) for c, s in lanes],
                               [(j, b) for j in range(len(lanes))])
        st, o = rx.step(st, i, q)
        outs.append(o)
    return lanes, outs


def test_pfb_route_in_float64_is_the_reference(band):
    """The port's ``pfb`` route in float64 (channelize at the slot rate,
    mix out the offset there, the RF low-pass in the receiver) gives the
    reference front and golden receiver's audio and RDS symbols to 1e-9,
    over 3 blocks of 2 captures x 8 slots."""
    ring = band[0]
    config = _config()
    blocks = np.stack([ring[:, b] for b in range(3)])   # (3, 2, bytes)
    outs = _port_run(config, blocks, torch.float64, "pfb")
    lanes, refs = _golden_run(config, "float64", ring, 3)
    worst = 0.0
    for out, ref in zip(outs, refs):
        for lane, (c, s) in enumerate(lanes):
            for got, want in ((out.left[c, s], ref["left"][lane]),
                              (out.right[c, s], ref["right"][lane])):
                worst = max(worst, float(np.max(np.abs(got.numpy() - want))))
            n_sym = int(out.rds.n_sym[c, s])
            sym = out.rds.symbols_i[c, s, :n_sym].numpy()
            ref_sym = ref["frame"][lane]["symbols"]
            assert n_sym == len(ref_sym)
            peak = float(np.max(np.abs(ref_sym)))
            worst = max(worst, float(np.max(np.abs(sym - ref_sym))) / peak)
    assert worst < 1e-9, worst


def test_composed_route_plain_version_within_the_cells_limits(band):
    """The ``composed`` route's plain version in float32, what the cell
    runs but for the kernel, held by the check against the reference over
    4 blocks of all 16 streams from the initial state, within the cell's
    limits (the symbols from ``pull_in_blocks`` on)."""
    from rtsdr_tpu_torch.io.stream import fetch_list

    ring = band[0]
    config = _config()
    blocks = np.stack([ring[:, b] for b in range(4)])
    outs = _port_run(config, blocks, torch.float32, "composed")
    k = config["wideband"]["slots"]
    streams = len(ring) * k
    items = []
    for s in range(streams):
        c, slot = s % len(ring), s // len(ring)
        items.append({"kind": "start", "stream": s, "blocks": [0, 1, 2, 3],
                      "outputs": [drive.host_outputs(
                          [t.numpy() for t in fetch_list(o)], (c, slot))
                          for o in outs]})
    refs = check.reference(config, "float64",
                           lambda s, b: (ring[s % len(ring)][b],
                                         s // len(ring)), items)
    workload = core.load_json(core.BENCH_DIR, "workloads", CELL + ".json")
    numbers = check.compare(items, refs, workload["check"]["pull_in_blocks"])
    correct, checks = check.judge(numbers, workload["limits"])
    assert correct, checks


def test_front_rebuilds_a_window_item_to_the_bit(band):
    """Blocks s - 2 and s - 1 through a fresh front give block s's I and
    Q as the front running from block 0 gave them, to the last bit: its
    memory is the input's tail, and the mixing phase is worked out from
    the block."""
    ring = band[0]
    config = _config()
    front = check.load_front(config, "float64")
    lanes = [(0, 0), (1, 3), (0, 5), (1, 6)]
    raws = [[(ring[c][b], s) for c, s in lanes] for b in range(4)]
    where = [[(j, b) for j in range(len(lanes))] for b in range(4)]
    st = front.init(len(lanes))
    chained = []
    for b in range(4):
        st, i, q = front.step(st, raws[b], where[b])
        chained.append((i, q))
    st = front.init(len(lanes))
    for b in (1, 2, 3):
        st, i, q = front.step(st, raws[b], where[b])
    assert np.array_equal(i, chained[3][0])
    assert np.array_equal(q, chained[3][1])
    # the rebuild is not trivially right: from nothing, block 3 parts
    _, i0, _ = front.step(front.init(len(lanes)), raws[3], where[3])
    assert np.max(np.abs(i0 - chained[3][0])) > 1e-3


def test_driver_rows_and_blocks(band):
    """Stream s decodes slot ``s // captures`` of capture ``s % captures``;
    what it carries at block b is that capture's ring block and its
    slot; the check's window items fall one in each slot."""
    from benchmark.drivers import wideband as driver

    ring, capture_of, offset, _ = band
    b = driver.Band.__new__(driver.Band)
    b.ring, b.capture_of, b.offset = ring, capture_of, offset
    b.captures, b.slots = 2, 8
    assert [b.row(s) for s in range(16)] == [
        (s % 2, s // 2) for s in range(16)]
    for s in (0, 5, 15):
        for blk in (0, 3, 6):
            raw, slot = b.block(s, blk)
            c = s % 2
            assert slot == s // 2
            assert np.array_equal(
                raw, ring[capture_of[c], (blk + offset[c]) % 4])
    ctx = core.Ctx(cell={}, config={}, traffic={}, workload={"check": {
        "start_streams": 2, "start_blocks": 4, "window_items": 8,
        "pull_in_blocks": 2}}, seed=SEED, seconds=1.0, trace=False,
        device="cpu")
    samples = drive.Samples(ctx, 16, rows=[b.row(s) for s in range(16)])
    slots = sorted(b.row(c)[1] for _, c in samples.pending)
    assert slots == list(range(8))


def test_synthesis_is_seeded_and_on_the_band_plan(band):
    """The same seed gives the same bytes, another seed others; each slot's
    strongest frequency of a block lies within 100 kHz of its station's
    raster frequency, and the stations' levels span the traffic's range."""
    ring, capture_of, offset, params = band
    config = _config()
    again = synth_band.make_band(_traffic(), config, SEED)
    assert np.array_equal(ring, again[0])
    assert np.array_equal(offset, again[2])
    assert ring.shape == (2, 4, 8 * 307200) and ring.dtype == np.uint8
    other = synth_band.make_band(_traffic(distinct_captures=1), config,
                                 SEED + 1)[0]
    assert not np.array_equal(ring[0], other[0])
    wb = config["wideband"]
    fs_w = wb["slots"] * config["rf"]["fs"]
    iq = (ring[0, 1].astype(np.float64) - 128.0) / 128.0
    x = (iq[0::2] + 1j * iq[1::2]).reshape(-1, 4096)
    psd = np.mean(np.abs(np.fft.fft(x * np.hanning(4096), axis=1)) ** 2, 0)
    freqs = np.fft.fftfreq(4096, 1.0 / fs_w)
    centre = wb["capture_center_hz"]
    for k, station in enumerate(wb["stations_hz"]):
        slot_centre = station - centre - wb["offsets_hz"][k]
        near = np.abs((freqs - slot_centre + fs_w / 2) % fs_w - fs_w / 2)
        in_slot = near < 0.5 * config["rf"]["fs"]
        peak = freqs[in_slot][np.argmax(psd[in_slot])]
        assert abs(peak - (station - centre)) < 100e3, (k, peak)
    cnr = [p["cnr_db"] for cap in params for p in cap]
    assert all(15.0 <= v <= 40.0 for v in cnr)
    assert [p["carrier_hz"] for p in params[0]] == [
        s - centre for s in wb["stations_hz"]]


def test_rehearsal_and_control():
    """The cell end to end on the plain versions: ``correct``; the control
    (the reference in bfloat16 in the program's place) is not."""
    ctx, run = core.measure(CELL, SEED, 4.0, False, device="cpu",
                            overrides=SMALL)
    assert any(it["kind"] == "window" for it in run.items)
    assert run.channels == 16
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
    """Put a wideband receiver with the fault ``kind`` (module docstring)
    where the driver builds it."""
    from rtsdr_tpu_torch.pipeline import wideband

    if kind not in FAULTS:
        raise ValueError(f"no fault {kind!r}")
    good = wideband.make_wideband_receiver

    def faulty(cfg, k, *args, **kwargs):
        if kind == "offset_sign":
            offs = np.array(kwargs["channel_offsets_hz"], np.float64)
            offs[0] = -offs[0]
            kwargs["channel_offsets_hz"] = offs
            return good(cfg, k, *args, **kwargs)
        init, step = good(cfg, k, *args, **kwargs)
        field = kind

        def broken(state, raw):
            new, out = step(state, raw)
            return new._replace(**{field: getattr(state, field).clone()}), out
        return init, broken
    setattr_(wideband, "make_wideband_receiver", faulty)


def _off_raster(config: dict) -> dict:
    """Slot 0's station 8 Hz above the raster: 12,800.512 cycles of its
    offset a block."""
    config = copy.deepcopy(config)
    config["wideband"]["stations_hz"][0] += 8
    config["wideband"]["offsets_hz"][0] += 8
    return config


def _load_json(config: dict | None = None, workload: dict | None = None):
    """``core.load_json`` giving ``config`` for the cell's configuration
    file and ``workload`` for its workload file where given."""
    load = core.load_json
    if workload is not None:
        load = control.with_workload(load, CELL, workload)

    def load_json(*parts):
        if config is not None and parts[-2:] == ("configs",
                                                 "wideband8.json"):
            return copy.deepcopy(config)
        return load(*parts)
    return load_json


def _execute(monkeypatch, config=None, workload=None) -> dict:
    monkeypatch.setattr(core, "load_json", _load_json(config, workload))
    return core.execute(CELL, SEED + 3, 3.0, False, device="cpu",
                        overrides={**SMALL, "distinct_captures": 1})


@pytest.mark.parametrize("kind", FAULTS)
def test_planted_fault_is_not_correct(kind, monkeypatch):
    """Each fault, its run's items from every stream's first 4 blocks and
    the window's, reads ``correct`` false (``mix_phase`` off the raster,
    module docstring)."""
    workload = core.load_json(core.BENCH_DIR, "workloads", CELL + ".json")
    workload["check"]["start_streams"] = 16
    config = _off_raster(_config()) if kind == "mix_phase" else None
    plant(kind, monkeypatch.setattr)
    result = _execute(monkeypatch, config, workload)
    assert not result["correct"], result["checks"]


def test_off_raster_station_without_fault_is_correct(monkeypatch):
    """The off-raster plan of the ``mix_phase`` fault's test, with the
    phase carried: ``correct`` (the fault, not the plan, is what reads
    false)."""
    result = _execute(monkeypatch, _off_raster(_config()))
    assert result["correct"], result["checks"]
