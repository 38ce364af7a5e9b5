"""Several stations a slot: the wideband receiver with ``channel_slots``
(``pipeline/wideband.py``) on the CPU, its plain versions, at K = 4 slots
of 2.4 MS/s with 8 stations on the 200 kHz raster, 1 to 3 a slot (one on
its slot's centre, one slot empty), one capture synthesized by the
benchmark's market generator (``benchmark/traffic/synth_market.py``).

* against the benchmark's reference, the dense band's front
  (``benchmark/reference/front_band.py``: each station's slot band-pass,
  every K-th sample, its offset mixed out, in float64) and the golden
  receiver, within the ``band38.resident27`` cell's limits, the bit layer
  exact;
* the ``pfb`` route against the ``composed`` route;
* ``channel_slots=None`` against a map that lists the slots in another
  order, bit for bit (one station a slot is the same program);
* planted faults read wrong: a station 8 Hz off the raster with its NCO
  phase not carried (on a card too, the NCO turned in K5's epilogue: a
  ``gpu`` test that skips without one), two stations' slots swapped;
* ``channel_sharding`` over 2 shards of the stations against the
  unsharded receiver;
* the CLI's ``--wideband-centers`` mapping of the dense band's 38 centres
  against the configuration file.

Stations are batch rows; the receivers run 3 blocks.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from benchmark.harness import check, core
from benchmark.traffic import synth_band, synth_market
from rtsdr_tpu_torch import cli
from rtsdr_tpu_torch.config import MODE0
from rtsdr_tpu_torch.pipeline.wideband import make_wideband_receiver

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 4
N_BLOCKS = 3
SEED = 2**33 + 23
# capture-relative centres: slot 0 (0 Hz) -0.8, 0, +0.4 MHz; slot 1 (+2.4)
# -0.4, +0.8; slot 3 (-2.4) -0.4, +0.4; slot 2 (-4.8) +0.4
CENTERS = "-800k,0,400k,2000k,3200k,-2800k,-2000k,-4400k"
SLOTS = [0, 0, 0, 1, 1, 3, 3, 2]
OFFSETS = [-800e3, 0.0, 400e3, -400e3, 800e3, -400e3, 400e3, 400e3]
COMPARED = [0, 1, 3, 4]         # an edge, the centre, two of one slot


def _config() -> dict:
    cfg = core.load_json(ROOT, "benchmark", "configs", "band38.json")
    wb = cfg["wideband"]
    wb["slots"] = K
    wb["stations_hz"] = [int(wb["capture_center_hz"] + 1e3 * float(c[:-1]))
                         if c.endswith("k") else int(wb["capture_center_hz"])
                         for c in CENTERS.split(",")]
    wb["slots_of"], wb["offsets_hz"] = SLOTS, [int(o) for o in OFFSETS]
    return cfg


@pytest.fixture(scope="module")
def capture():
    """(N_BLOCKS, K * block_size) u8: one capture of the 8 stations."""
    cfg = _config()
    traffic = {"distinct_captures": 1, "cnr_db": [25.0, 40.0],
               "detune_hz": 200.0}
    params = synth_market.station_params(traffic, cfg, SEED)[0]
    return synth_band.capture_iq(params, N_BLOCKS, cfg, SEED).numpy()


def _run(capture, n_blocks=N_BLOCKS, fault=None, **kw):
    """The port's receiver over the capture's blocks: each step's outputs;
    ``fault(old_state, new_state)`` may alter the state a step hands on."""
    cfg = _config()
    opts = dict(channel_offsets_hz=OFFSETS, channel_slots=SLOTS,
                device="cpu", **core.receiver_kwargs(cfg))
    opts.update(kw)
    init, step = make_wideband_receiver(MODE0, K, (1,), **opts)
    state, outs = init(), []
    for b in range(n_blocks):
        new, out = step(state,
                        torch.as_tensor(capture[b][None]).to(opts["device"]))
        state = new if fault is None else fault(state, new)
        outs.append(out)
    return outs


@pytest.fixture(scope="module")
def port(capture):
    return _run(capture)


def test_port_equals_the_reference_within_the_cells_limits(capture, port):
    """Stations of a shared slot, the centre and the ±0.8 MHz edge against
    the reference front and golden receiver from the initial state, held
    by the cell's check (symbols from its ``pull_in_blocks`` on; the bit
    layer exact)."""
    from rtsdr_tpu_torch.io.stream import fetch_list

    cfg = _config()
    workload = core.load_json(ROOT, "benchmark", "workloads",
                              "band38.resident27.json")
    items = [{"kind": "start", "stream": j, "blocks": list(range(N_BLOCKS)),
              "outputs": [drive_outputs(fetch_list(o), (0, j))
                          for o in port]} for j in COMPARED]
    refs = check.reference(cfg, "float64",
                           lambda j, b: (capture[b], j), items)
    numbers = check.compare(items, refs, workload["check"]["pull_in_blocks"])
    correct, checks = check.judge(numbers, workload["limits"])
    assert correct, checks
    assert numbers["frame_mismatch"] == 0
    assert all(it["outputs"][-1]["frame"]["n_sym"] > 0 for it in items)


def drive_outputs(arrays, row):
    from benchmark.harness import drive

    return drive.host_outputs([t.numpy() for t in arrays], row)


def test_pfb_route_equals_the_composed_route(capture, port):
    """The ``pfb`` route (each station's slot gathered at the slot rate,
    its offset mixed out there, the RF low-pass in the receiver) gives the
    composed route's audio within 2e-4 (the JAX package's bound between
    its two routes)."""
    pfb = _run(capture, 2, channelizer_impl="pfb")
    for a, b in zip(port[:2], pfb):
        assert tuple(b.left.shape) == (1, len(SLOTS), MODE0.audio_len)
        for x, y in ((a.left, b.left), (a.right, b.right)):
            assert float((x - y).abs().max()) < 2e-4


def test_one_station_a_slot_is_todays_program(capture):
    """``channel_slots=None`` (station k in slot k) against the same
    stations listed in another order through ``channel_slots``: each
    station's outputs equal bit for bit."""
    offs = [0.0, -400e3, 400e3, -400e3]
    order = [2, 0, 3, 1]
    kw = dict(enable_rds=False, enable_stereo=False)
    base = _run(capture, 2, channel_offsets_hz=offs, channel_slots=None,
                **kw)
    listed = _run(capture, 2, channel_offsets_hz=[offs[c] for c in order],
                  channel_slots=order, **kw)
    for a, b in zip(base, listed):
        assert tuple(a.mono.shape) == (1, K, MODE0.audio_len)
        assert torch.equal(a.mono[:, order], b.mono)


def _no_phase_carry(old, new):
    return new._replace(mix_phase=old.mix_phase.clone())


def test_mix_phase_carried_off_the_raster(capture):
    """Station 2 8 Hz off the raster (0.512 of a cycle a block): its NCO
    phase not carried reads wrong from the second block on, by far more
    than the cell's ``mono_err`` limit; on the raster (whole cycles a
    block) the same fault changes nothing."""
    kw = dict(enable_rds=False, enable_stereo=False)
    off = list(OFFSETS)
    off[2] += 8.0
    for offsets, wrong in ((off, True), (OFFSETS, False)):
        good = _run(capture, 2, channel_offsets_hz=offsets, **kw)
        bad = _run(capture, 2, fault=_no_phase_carry,
                   channel_offsets_hz=offsets, **kw)
        d = float((good[1].mono[0, 2] - bad[1].mono[0, 2]).abs().max())
        assert torch.equal(good[0].mono, bad[0].mono)
        assert (d > 100 * 5e-5) if wrong else d == 0.0


@pytest.mark.gpu
def test_mix_phase_carried_off_the_raster_in_the_kernel(capture):
    """The same fault through the CUDA composed route, where K5's
    two-stage role turns each station by its NCO in its epilogue: station
    2 8 Hz off the raster reads wrong without the carry, by more than
    100 x the cell's ``mono_err`` limit; on the raster the fault changes
    nothing."""
    from rtsdr_tpu_torch.ops import _cuda

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    kw = dict(enable_rds=False, enable_stereo=False, device="cuda")
    off = list(OFFSETS)
    off[2] += 8.0
    for offsets, wrong in ((off, True), (OFFSETS, False)):
        _cuda.reset_launch_counts()
        good = _run(capture, 2, channel_offsets_hz=offsets, **kw)
        assert _cuda.launch_counts()["channelizer.composed_two_stage"] == 2
        bad = _run(capture, 2, fault=_no_phase_carry,
                   channel_offsets_hz=offsets, **kw)
        d = float((good[1].mono[0, 2] - bad[1].mono[0, 2]).abs().max())
        assert torch.equal(good[0].mono, bad[0].mono)
        assert (d > 100 * 5e-5) if wrong else d == 0.0


def test_swapped_slots_read_wrong(capture, port):
    """Stations 0 and 3 (slots 0 and 1) with their slots swapped: both
    read another slot's spectrum, by far more than the limits; the others
    are unchanged."""
    slots = list(SLOTS)
    slots[0], slots[3] = slots[3], slots[0]
    bad = _run(capture, 1, channel_slots=slots)
    for j in range(len(SLOTS)):
        d = float((bad[0].left[0, j] - port[0].left[0, j]).abs().max())
        assert (d > 0.1) if j in (0, 3) else d == 0.0


def test_channel_sharding_over_stations(capture):
    """Two shards of 4 stations each give the unsharded receiver's audio
    bit for bit (mono receivers, 2 blocks)."""
    kw = dict(enable_rds=False, enable_stereo=False)
    whole = _run(capture, 2, **kw)
    sharded = _run(capture, 2, channel_sharding=["cpu", "cpu"], **kw)
    for a, b in zip(whole, sharded):
        assert tuple(b.mono.shape) == (1, len(SLOTS), MODE0.audio_len)
        assert torch.equal(a.mono, b.mono)


def test_centers_map_to_the_configurations_slots_and_offsets():
    """``--wideband 8 --wideband-centers`` with the dense band's 38
    stations gives the configuration's ``slots_of`` and ``offsets_hz``,
    one station a centre in the order given; a centre beyond its slot's
    passband is refused."""
    with open(os.path.join(ROOT, "benchmark", "configs", "band38.json")) as f:
        wb = json.load(f)["wideband"]
    spec = ",".join(f"{(hz - wb['capture_center_hz']) / 1e6:+.1f}M"
                    for hz in wb["stations_hz"])
    slots, offsets, err = cli._centers_to_offsets(MODE0, 8, spec)
    assert err is None
    assert slots == wb["slots_of"]
    assert np.array_equal(offsets, wb["offsets_hz"])
    _, _, err = cli._centers_to_offsets(MODE0, 8, spec + ",+1.2M")
    assert err.startswith("+1.2M is +1200 kHz from its nearest slot center")


def test_receiver_refuses_what_it_cannot_decode():
    with pytest.raises(ValueError, match="beyond the decodable"):
        make_wideband_receiver(MODE0, K, channel_slots=[0, 0],
                               channel_offsets_hz=[0.0, 1.15e6],
                               device="cpu")
    with pytest.raises(ValueError, match="need 2 offsets"):
        make_wideband_receiver(MODE0, K, channel_slots=[0, 0],
                               channel_offsets_hz=[0.0], device="cpu")
    with pytest.raises(ValueError, match="slot_of"):
        make_wideband_receiver(MODE0, K, channel_slots=[0, 4], device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        make_wideband_receiver(MODE0, K, channel_slots=[0, 0, 1],
                               channel_sharding=["cpu", "cpu"], device="cpu")
