"""``emit_early_share.live`` on synthetic records of the program's spans:
the share of ``rtsdr.emit`` drains marked ``early``, and silence where no
drain carries the mark (a program that always holds, or has no spans)."""

import pytest

from benchmark.harness import core
from rtsdr_tpu_torch.utils import trace as program_trace

NAME = "emit_early_share.live"


class _Ctx:
    def __init__(self):
        self.info = []

    def note(self, **kv):
        self.info.append(kv)


def _rec(name, block, **attrs):
    return {"name": name, "t0_ns": block * 64_000_000,
            "t1_ns": block * 64_000_000 + 50_000, "parent": None,
            "block": block, "attrs": attrs}


def _read(records, monkeypatch, ctx=None):
    monkeypatch.setattr(program_trace, "recorded", lambda: list(records))
    return core.load_module("metrics", NAME).read(None, ctx)


@pytest.mark.parametrize("flags, share", [
    ([1] * 16, 100.0),
    ([0] * 4, 0.0),
    ([0, 0, 0, 1, 1, 1, 1, 1], 62.5),
])
def test_share_of_early_drains(flags, share, monkeypatch):
    recs = []
    for b, f in enumerate(flags):
        recs.append(_rec("rtsdr.read", b, bytes=307200, ready=0))
        recs.append(_rec("rtsdr.fetch_wait", b))
        recs.append(_rec("rtsdr.emit", b, early=f))
    ctx = _Ctx()
    assert _read(recs, monkeypatch, ctx) == pytest.approx(share)
    assert ctx.info == [{"emit_early": {"drains": len(flags),
                                        "early": sum(flags)}}]


def test_drains_without_the_mark_are_not_counted(monkeypatch):
    recs = [_rec("rtsdr.emit", 0), _rec("rtsdr.emit", 1, early=1),
            _rec("rtsdr.emit", 2, early=0), _rec("rtsdr.emit", 3, early=1)]
    assert _read(recs, monkeypatch) == pytest.approx(200.0 / 3)


def test_silent_without_the_mark(monkeypatch):
    # the parent's drains: no ``early`` attribute
    recs = [_rec("rtsdr.read", 0, bytes=307200), _rec("rtsdr.emit", 0),
            _rec("rtsdr.emit", 1)]
    for records in ([], recs):
        ctx = _Ctx()
        assert _read(records, monkeypatch, ctx) is None
        assert ctx.info == []
    # a program without spans at all
    monkeypatch.delattr(program_trace, "recorded")
    assert core.load_module("metrics", NAME).read(None, None) is None
