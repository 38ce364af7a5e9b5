"""``fetch_side_share.resident`` on synthetic records of the program's
spans: the share of ``rtsdr.fetch_start`` fetches marked ``side``, and
silence where no fetch carries the mark (a program that copies on the
step's stream, or has no spans)."""

import pytest

from benchmark.harness import core
from rtsdr_tpu_torch.utils import trace as program_trace

NAME = "fetch_side_share.resident"
MB27 = 27_303_936


class _Ctx:
    def __init__(self):
        self.info = []

    def note(self, **kv):
        self.info.append(kv)


def _rec(name, block, **attrs):
    return {"name": name, "t0_ns": block * 3_000_000,
            "t1_ns": block * 3_000_000 + 60_000, "parent": None,
            "block": block, "attrs": attrs}


def _read(records, monkeypatch, ctx=None):
    monkeypatch.setattr(program_trace, "recorded", lambda: list(records))
    return core.load_module("metrics", NAME).read(None, ctx)


@pytest.mark.parametrize("flags, share", [
    ([1] * 48, 100.0),
    ([0] * 4, 0.0),
    ([1, 1, 1, 0], 75.0),
])
def test_share_of_fetches_on_the_side_stream(flags, share, monkeypatch):
    recs = []
    for b, f in enumerate(flags):
        recs.append(_rec("rtsdr.replay", b, launches=181))
        recs.append(_rec("rtsdr.fetch_start", b, copies=13, bytes=MB27,
                         side=f))
        recs.append(_rec("rtsdr.fetch_wait", b))
    ctx = _Ctx()
    assert _read(recs, monkeypatch, ctx) == pytest.approx(share)
    assert ctx.info == [{"fetch_side": {"fetches": len(flags),
                                        "side": sum(flags)}}]


def test_fetches_without_the_mark_are_not_counted(monkeypatch):
    recs = [_rec("rtsdr.fetch_start", 0, copies=13, bytes=MB27),
            _rec("rtsdr.fetch_start", 1, copies=13, bytes=MB27, side=1),
            _rec("rtsdr.fetch_start", 2, copies=13, bytes=MB27, side=0),
            _rec("rtsdr.fetch_start", 3, copies=13, bytes=MB27, side=1)]
    assert _read(recs, monkeypatch) == pytest.approx(200.0 / 3)


def test_silent_without_the_mark(monkeypatch):
    # the parent's fetches: ``copies`` and ``bytes``, no ``side``
    recs = [_rec("rtsdr.replay", 0, launches=181),
            _rec("rtsdr.fetch_start", 0, copies=13, bytes=MB27),
            _rec("rtsdr.fetch_start", 1, copies=13, bytes=MB27)]
    for records in ([], recs):
        ctx = _Ctx()
        assert _read(records, monkeypatch, ctx) is None
        assert ctx.info == []
    # a program without spans at all
    monkeypatch.delattr(program_trace, "recorded")
    assert core.load_module("metrics", NAME).read(None, None) is None
