"""The wideband receiver's spans (``utils/trace.py::annotate``): one
``rtsdr.channelize`` a channelizer call with its route, the stations on
each of its routes and those whose residual NCO the two-stage role turns
in its epilogue, on eager calls and at a compiled step's capture;
the CLI's wideband loop (``cli.py::_wideband_decode``) reading and
emitting each capture block under ``rtsdr.read`` and ``rtsdr.emit``; and
nothing recorded without a profiler session.  CPU only, the receivers
mono (``enable_rds=False, enable_stereo=False``): the spans do not depend
on the DSP."""

import sys

import numpy as np
import pytest
import torch

from rtsdr_tpu_torch import cli
from rtsdr_tpu_torch.config import MODE0
from rtsdr_tpu_torch.pipeline.wideband import make_wideband_receiver
from rtsdr_tpu_torch.utils import trace as tr
from rtsdr_tpu_torch.utils.jit import jit_step

K = 8
# a station a slot on the 200 kHz raster around 97.9 MHz: seven off their
# slot's centre, one on it
BAND_PLAN_HZ = [200e3, -600e3, 800e3, -200e3, 400e3, 0.0, -800e3, 600e3]
MONO = dict(device="cpu", enable_rds=False, enable_stereo=False)
WBS = K * MODE0.block_size
# route: (shared, own, two_stage, taps, mix) for the band plan: the
# composed route runs every station in two stages (the slot bank, then
# each station's RF FIR), a quarter of its own taps' work; on the CPU no
# kernel turns a station (``mix`` 0: the stock mix runs after the bank, as
# on ``pfb``; the card's count is ``test_torch_cuda_band.py``'s)
ROUTES = {"composed": (0, 0, K, (MODE0.rf.taps - 1) * K + 16 * K, 0),
          "pfb": (K, 0, 0, 16 * K, 0)}


@pytest.fixture(autouse=True)
def _fresh():
    tr.clear()
    yield
    tr.clear()


def _capture_blocks(n_blocks: int, captures: int = 2) -> torch.Tensor:
    rng = np.random.default_rng(19)
    return torch.as_tensor(rng.integers(0, 256, (n_blocks, captures, WBS),
                                        dtype=np.uint8))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_channelize_span_on_eager_calls(route):
    """Two eager steps over 2 captures: one ``rtsdr.channelize`` a step
    with the route, the captures, the slots, the stations on the shared
    prototype, on their own taps and on the two-stage role for the band
    plan, the bank's length, and the stations turned in K5's epilogue
    (none on the CPU)."""
    init, step = make_wideband_receiver(
        MODE0, K, (2,), channel_offsets_hz=BAND_PLAN_HZ,
        channelizer_impl=route, **MONO)
    state = init()
    blocks = _capture_blocks(2)
    with tr.profile():
        for b in range(2):
            state, _ = step(state, blocks[b])
    recs = [r for r in tr.recorded() if r["name"] == "rtsdr.channelize"]
    shared, own, two_stage, taps, mix = ROUTES[route]
    assert len(recs) == 2
    for r in recs:
        assert r["attrs"] == {"route": route, "captures": 2, "slots": K,
                              "shared": shared, "own": own,
                              "two_stage": two_stage, "taps": taps,
                              "mix": mix, "stations": K, "per_slot": 1}
        assert r["parent"] is None


@pytest.mark.parametrize("plan", ["one_offset", "no_offsets"])
def test_channelize_span_mix_off_the_two_stage_role(plan):
    """``mix`` is 0 where the epilogue turns nothing: one station off its
    slot's centre (the mixed roles, 7 shared and 1 own, less work than
    the two-stage role: the NCO runs after the bank), and no offsets (no
    NCO)."""
    offsets = [0.0] * K
    if plan == "one_offset":
        offsets[2] = 800e3
    init, step = make_wideband_receiver(
        MODE0, K, channel_offsets_hz=offsets, **MONO)
    with tr.profile():
        step(init(), _capture_blocks(1, 1)[0, 0])
    (chan,) = [r for r in tr.recorded() if r["name"] == "rtsdr.channelize"]
    want = (K - 1, 1, 0, 0) if plan == "one_offset" else (K, 0, 0, 0)
    assert tuple(chan["attrs"][a] for a in (
        "shared", "own", "two_stage", "mix")) == want


def test_channelize_span_at_the_capture():
    """A compiled wideband step's first call records the channelizer's
    span inside ``rtsdr.capture``; one capture, not a capture per
    warm-up."""
    init, step = jit_step(*make_wideband_receiver(
        MODE0, K, channel_offsets_hz=BAND_PLAN_HZ, **MONO), "cpu",
        name="wideband")
    state = init()
    with tr.profile():
        state, _ = step(state, _capture_blocks(1, 1)[0, 0])
    names = [r["name"] for r in tr.recorded()]
    assert names.count("rtsdr.capture") == 1
    (chan,) = [r for r in tr.recorded() if r["name"] == "rtsdr.channelize"]
    assert chan["parent"] == "rtsdr.capture"
    assert chan["attrs"]["captures"] == 1
    assert (chan["attrs"]["shared"], chan["attrs"]["own"],
            chan["attrs"]["two_stage"], chan["attrs"]["mix"]) == (0, 0, K, 0)


def _decode_file(path, monkeypatch, tmp_path) -> int:
    monkeypatch.chdir(tmp_path)
    with open(path, "rb") as f:
        monkeypatch.setattr(sys, "stdin", f)
        return cli._wideband_decode(
            MODE0, K, None, dict(MONO, device=torch.device("cpu"),
                                 channel_offsets_hz=BAND_PLAN_HZ))


@pytest.fixture
def capture_file(tmp_path):
    path = tmp_path / "band.iq"
    path.write_bytes(_capture_blocks(3, 1).numpy().tobytes())
    return path


def test_cli_wideband_loop_reads_and_emits_under_spans(
        capture_file, monkeypatch, tmp_path):
    """A 3-block capture file through the CLI's wideband loop under a
    session: each block read once under ``rtsdr.read`` (its bytes and the
    reader's backlog), one more read at the end with no bytes, and each
    block's drain one ``rtsdr.emit`` (``early`` 0) after the next block's
    read, its fetch's wait inside it."""
    with tr.profile():
        assert _decode_file(capture_file, monkeypatch, tmp_path) == 0
    recs = tr.recorded()
    reads = {r["block"]: r for r in recs if r["name"] == "rtsdr.read"}
    emits = {r["block"]: r for r in recs if r["name"] == "rtsdr.emit"}
    assert sorted(reads) == [0, 1, 2, 3] and sorted(emits) == [0, 1, 2]
    for b in range(3):
        assert reads[b]["attrs"]["bytes"] == WBS
        assert reads[b]["attrs"]["ready"] >= 1      # a file: blocks waiting
        assert emits[b]["attrs"] == {"early": 0}
        assert emits[b]["t0_ns"] >= reads[b + 1]["t1_ns"]
        (wait,) = [r for r in recs if r["name"] == "rtsdr.fetch_wait"
                   and r["block"] == b]
        assert wait["parent"] == "rtsdr.emit"
    assert reads[3]["attrs"]["bytes"] == 0
    assert sum(r["name"] == "rtsdr.channelize" for r in recs) == 3
    assert sorted(p.name for p in tmp_path.glob("channel*.wav")) == [
        f"channel{c}.wav" for c in range(K)]


def test_cli_wideband_loop_records_nothing_off(capture_file, monkeypatch,
                                               tmp_path):
    """Without a session the same run records nothing."""
    assert _decode_file(capture_file, monkeypatch, tmp_path) == 0
    assert tr.recorded() == [] and tr.dropped() == 0
