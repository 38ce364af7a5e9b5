"""The readers of the program's spans (``rtsdr_tpu_torch/utils/trace.py``):
``hold_ms_per_block.live`` and ``host_ms_per_step.resident`` on synthetic
records, and their silence where the record holds no such spans or the
program has no spans at all (a parent without them).

No traced ``core.measure`` run on the CPU here: the slice of a CPU run
needs the cell's whole window (the plain PLL loop takes about a second a
block), 26 s for ``mode0.resident1024`` and 68 s for ``mode0.live1`` at
the smallest traffic, past this file's 30 s."""

import pytest

from benchmark.harness import core
from rtsdr_tpu_torch.utils import trace as program_trace

MS = 1_000_000   # ns


class _Ctx:
    def __init__(self):
        self.info = []

    def note(self, **kv):
        self.info.append(kv)


def _run(trace):
    return core.Run(setup_s=1.0, window_s=20.0, channels=1, blocks_done=0,
                    attempted=0, failed=0, items=[], block_of=None,
                    memory_peak_bytes=0, trace=trace)


def _rec(name, block, t0_ms, t1_ms, parent=None, **attrs):
    return {"name": name, "t0_ns": int(t0_ms * MS), "t1_ns": int(t1_ms * MS),
            "parent": parent, "block": block, "attrs": attrs}


def _read(name, run, ctx, records, monkeypatch):
    monkeypatch.setattr(program_trace, "recorded", lambda: list(records))
    return core.load_module("metrics", name).read(run, ctx)


def _live_records(holds_ms):
    """The stream loop at 64 ms a block: block b read for 62 ms, then push
    0.1, replay 0.3, fetch start 0.2, then block b - 1's drain (the fetch's
    wait inside); block b's drain starts ``holds_ms[b]`` after its fetch
    start ended.  Block 0's read and push fell before the slice."""
    recs = []
    for b in range(len(holds_ms)):
        t = 64.0 * b
        if b > 0:
            recs.append(_rec("rtsdr.read", b, t, t + 62.0, bytes=307200))
            recs.append(_rec("rtsdr.push", b, t + 62.0, t + 62.1,
                             bytes=307200))
        recs.append(_rec("rtsdr.replay", b, t + 62.1, t + 62.4, launches=40))
        recs.append(_rec("rtsdr.fetch_start", b, t + 62.4, t + 62.6,
                         copies=13, bytes=27032))
    for b, hold in enumerate(holds_ms):
        t = 64.0 * b + 62.6 + hold
        recs.append(_rec("rtsdr.fetch_wait", b, t + 0.01, t + 0.02,
                         parent="rtsdr.emit"))
        recs.append(_rec("rtsdr.emit", b, t, t + 0.05))
    return recs


def test_hold_is_the_median_emit_start_after_fetch_start(monkeypatch):
    holds = [63.7, 63.9, 64.5, 63.8, 70.0]
    ctx = _Ctx()
    got = _read("hold_ms_per_block.live", _run({"window_s": 0.32}), ctx,
                _live_records(holds), monkeypatch)
    assert got == pytest.approx(63.9, abs=1e-6)
    (note,) = ctx.info
    spans = note["program_spans"]
    assert spans["blocks"] == 5
    assert spans["read_ms_per_block"] == pytest.approx(62.0)
    assert spans["push_replay_fetch_start_ms_per_block"] == pytest.approx(
        0.6)
    assert spans["read_share_of_window"] == pytest.approx(4 * 62.0 / 320.0)


def test_hold_skips_blocks_without_an_index_or_a_span(monkeypatch):
    recs = _live_records([60.0, 61.0, 62.0])
    # the slice began inside block 0: its spans carry no index
    recs = [dict(r, block=None) if r["block"] == 0 else r for r in recs]
    # block 2's drain came after the slice ended
    recs = [r for r in recs if not (r["block"] == 2
                                    and r["name"] == "rtsdr.emit")]
    got = _read("hold_ms_per_block.live", _run(None), _Ctx(), recs,
                monkeypatch)
    assert got == pytest.approx(61.0, abs=1e-6)


def _resident_records(steps):
    recs = []
    for k in range(steps):
        t = 3.5 * k
        recs.append(_rec("rtsdr.replay", None, t, t + 0.08, launches=152))
        recs.append(_rec("rtsdr.fetch_start", None, t + 0.08, t + 0.12,
                         copies=13, bytes=27_000_000))
        if k:
            recs.append(_rec("rtsdr.fetch_wait", None, t + 0.12, t + 3.4))
    return recs


def test_host_time_is_replay_and_fetch_start_over_the_steps(monkeypatch):
    ctx = _Ctx()
    trace = {"steps": 48, "window_s": 0.17}
    got = _read("host_ms_per_step.resident", _run(trace), ctx,
                _resident_records(48), monkeypatch)
    assert got == pytest.approx(0.12)
    (note,) = ctx.info
    spans = note["program_spans"]
    assert spans["captures"] == 0 and spans["replays"] == 48
    assert spans["replay_ms_per_step"] == pytest.approx(0.08)
    assert spans["launches_per_replay"] == 152
    assert spans["d2h_copies_per_step"] == 13
    assert spans["d2h_mb_per_step"] == pytest.approx(27.0)
    recs = _resident_records(48) + [_rec("rtsdr.capture", None, 0.0, 900.0)]
    ctx = _Ctx()
    _read("host_ms_per_step.resident", _run(trace), ctx, recs, monkeypatch)
    assert ctx.info[0]["program_spans"]["captures"] == 1


@pytest.mark.parametrize("name", ["hold_ms_per_block.live",
                                  "host_ms_per_step.resident"])
def test_silent_without_the_spans(name, monkeypatch):
    trace = {"steps": 48, "window_s": 0.17}
    others = [_rec("bench.step", None, 0.0, 1.0), _rec("rtsdr.read", 3,
                                                       1.0, 2.0)]
    for records in ([], others):
        ctx = _Ctx()
        assert _read(name, _run(trace), ctx, records, monkeypatch) is None
        assert ctx.info == []
    # a program without spans (the parent of the change that added them)
    monkeypatch.delattr(program_trace, "recorded")
    assert core.load_module("metrics", name).read(_run(trace), None) is None
