"""The program's spans (``rtsdr_tpu_torch/utils/trace.py::annotate``): off
and free of records without a profiler session; under one, each host-loop
boundary of ``StreamRunner`` and ``BatchRunner`` recorded once a block with
its block index and enclosing span, on the Chrome trace's clock; one
``rtsdr.capture`` per compiled step; the records' cap; and
``tools/torch_span_check.py``'s idle-time arithmetic.  CPU only, the
receivers mono (``enable_rds=False, enable_stereo=False``) to keep each
test short: the spans do not depend on the DSP."""

import json
import os
import pathlib
import sys
import threading

import pytest
import torch

from rtsdr_tpu_torch.config import MODE0
from rtsdr_tpu_torch.io.batch import BatchRunner
from rtsdr_tpu_torch.io.stream import StreamRunner
from rtsdr_tpu_torch.utils import trace as tr
from rtsdr_tpu_torch.utils.jit import jit_step
from rtsdr_tpu_torch.utils.signals import fm_multiplex_iq

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "tools"))
import torch_span_check as span_check  # noqa: E402

MONO = dict(device="cpu", enable_rds=False, enable_stereo=False)
PER_BLOCK = ("rtsdr.read", "rtsdr.push", "rtsdr.replay", "rtsdr.fetch_start",
             "rtsdr.fetch_wait", "rtsdr.emit")


@pytest.fixture(autouse=True)
def _fresh():
    tr.clear()
    yield
    tr.clear()


@pytest.fixture(scope="module")
def capture_bytes():
    return fm_multiplex_iq(6 * MODE0.iq_len).tobytes()


def _run_from_pipe(runner, data: bytes, **kw) -> dict:
    r_fd, w_fd = os.pipe()

    def fill():
        with os.fdopen(w_fd, "wb") as f:
            f.write(data)
    writer = threading.Thread(target=fill)
    writer.start()
    try:
        return runner.run(r_fd, emit=lambda pcm: None, **kw)
    finally:
        writer.join()
        os.close(r_fd)


def _warm_stream_runner(data):
    """A runner whose step has captured (its first call, outside any
    session), so that a traced run holds replays alone."""
    runner = StreamRunner(MODE0, **MONO)
    _run_from_pipe(runner, data[:MODE0.block_size])
    return runner


def _check_blocks(recs, n_blocks):
    """Each of ``n_blocks`` blocks has the six spans once, in the loop's
    order, the fetch's wait inside the block's drain; every read carries
    the reader's backlog (``ready``) and every drain ``early``.  Block b's
    drain starts after block b + 1's read ends when it was held
    (``early`` 0: the one-block hold), and ends before that read starts
    when it was drained early (``early`` 1)."""
    by_block: dict = {}
    for r in recs:
        by_block.setdefault(r["block"], []).append(r)
    for b in range(n_blocks):
        spans = {r["name"]: r for r in by_block[b]}
        assert sorted(spans) == sorted(PER_BLOCK), (b, by_block[b])
        assert len(by_block[b]) == len(PER_BLOCK)
        order = [spans[n]["t0_ns"] for n in PER_BLOCK[:4]]
        assert order == sorted(order)
        wait, emit = spans["rtsdr.fetch_wait"], spans["rtsdr.emit"]
        assert wait["parent"] == "rtsdr.emit"
        assert emit["t0_ns"] <= wait["t0_ns"] <= wait["t1_ns"] <= emit["t1_ns"]
        assert all(spans[n]["parent"] is None for n in PER_BLOCK
                   if n != "rtsdr.fetch_wait")
        assert all(r["t0_ns"] <= r["t1_ns"] for r in by_block[b])
        assert emit["attrs"]["early"] in (0, 1)
        assert spans["rtsdr.read"]["attrs"]["ready"] >= 0
        assert emit["t0_ns"] >= spans["rtsdr.fetch_start"]["t1_ns"]
        nxt = {r["name"]: r for r in by_block.get(b + 1, [])}
        if emit["attrs"]["early"]:
            assert emit["t1_ns"] <= nxt["rtsdr.read"]["t0_ns"]
        else:
            assert emit["t0_ns"] >= nxt["rtsdr.read"]["t1_ns"]
    # the read that met the end of the stream: one more, with no bytes
    eof = by_block.get(n_blocks, [])
    assert [r["name"] for r in eof] == ["rtsdr.read"]
    assert eof[0]["attrs"]["bytes"] == 0
    return by_block


def test_off_without_a_session(capture_bytes):
    """With no profiler session, ``annotate`` returns the one shared no-op
    object, and a 4-block run records nothing."""
    assert tr.annotate("rtsdr.read", block=3, bytes=5) is tr.OFF
    assert tr.annotate("probe") is tr.OFF
    assert not tr.OFF and tr.OFF.block is None
    with tr.annotate("rtsdr.push") as span:
        span.add(bytes=1)
    assert span is tr.OFF
    runner = StreamRunner(MODE0, **MONO)
    stats = _run_from_pipe(runner, capture_bytes[:4 * MODE0.block_size])
    assert stats["blocks"] == 4
    assert tr.recorded() == [] and tr.dropped() == 0


def test_stream_runner_spans_under_trace(capture_bytes, tmp_path):
    """Under ``trace()``, a 6-block run records each host-loop span once a
    block; the exported Chrome trace holds them by name, each event's
    ``ts`` + ``baseTimeNanoseconds`` within 1 ms of its record's start."""
    runner = _warm_stream_runner(capture_bytes)
    tr.clear()
    with tr.trace(str(tmp_path)):
        stats = _run_from_pipe(runner, capture_bytes)
    assert stats["blocks"] == 6
    recs = tr.recorded()
    by_block = _check_blocks(recs, 6)
    # a pipe's reader at the end: nothing had arrived, or the end
    assert by_block[6][0]["attrs"]["ready"] in (0, -1)
    assert not any(r["name"] == "rtsdr.capture" for r in recs)
    for b in range(6):
        spans = {r["name"]: r for r in by_block[b]}
        assert spans["rtsdr.read"]["attrs"]["bytes"] == MODE0.block_size
        assert set(spans["rtsdr.read"]["attrs"]) == {"bytes", "ready"}
        assert set(spans["rtsdr.emit"]["attrs"]) == {"early"}
        if not spans["rtsdr.emit"]["attrs"]["early"]:
            # held because the next block was waiting (or the stream had
            # ended): nothing took it from the reader before its read
            nxt = {r["name"]: r for r in by_block[b + 1]}
            assert nxt["rtsdr.read"]["attrs"]["ready"] != 0
        assert spans["rtsdr.push"]["attrs"] == {"bytes": MODE0.block_size}
        fetch = spans["rtsdr.fetch_start"]["attrs"]
        assert fetch == {"copies": 2, "bytes": 2 * 3072 * 4, "side": 0}
        assert spans["rtsdr.replay"]["attrs"] == {
            "launches": sum(runner.rx.step.per_step.values())}

    (path,) = tmp_path.glob("*.json")
    doc = json.loads(path.read_text())
    base = doc["baseTimeNanoseconds"]
    events = [e for e in doc["traceEvents"]
              if e.get("name", "").startswith("rtsdr.") and e.get("ph") == "X"]
    names = {r["name"] for r in recs}
    for name in names:
        ev = sorted(float(e["ts"]) * 1e3 + base for e in events
                    if e["name"] == name)
        rec = sorted(r["t0_ns"] for r in recs if r["name"] == name)
        assert len(ev) == len(rec), name
        assert max(abs(a - b) for a, b in zip(ev, rec)) < 1e6, name


def test_batch_runner_spans_under_trace(capture_bytes, tmp_path):
    """A 2-fd ``BatchRunner.run``: the same spans once a block, the read
    over both streams."""
    path = tmp_path / "c.iq"
    path.write_bytes(capture_bytes[:4 * MODE0.block_size])
    with open(path, "rb") as f0, open(path, "rb") as f1:
        with BatchRunner(MODE0, [f0.fileno(), f1.fileno()],
                         **MONO) as runner:
            with tr.profile():
                stats = runner.run(emit=lambda c, left, right: None)
    assert stats == {"blocks": 4, "stations": 2}
    recs = [r for r in tr.recorded() if r["name"] != "rtsdr.capture"]
    # the first block's replay is the capture on the CPU (the body runs
    # there once): block 0 has its capture in place of its replay
    caps = [r for r in tr.recorded() if r["name"] == "rtsdr.capture"]
    assert [r["block"] for r in caps] == [0]
    recs.append(dict(caps[0], name="rtsdr.replay"))
    recs.sort(key=lambda r: r["t0_ns"])
    by_block = _check_blocks(recs, 4)
    read = {r["name"]: r for r in by_block[0]}["rtsdr.read"]
    assert read["attrs"]["bytes"] == 2 * MODE0.block_size
    # files: a next block to read until the end
    ready = {r["block"]: r["attrs"]["ready"] for r in recs
             if r["name"] == "rtsdr.read"}
    assert all(ready[b] >= 1 for b in range(4)) and ready[4] in (1, -1)
    # the BatchRunner holds every block
    assert all(r["attrs"] == {"early": 0} for r in recs
               if r["name"] == "rtsdr.emit")


def _counting_step():
    def init():
        return (torch.zeros(3),)

    def step(state, raw):
        return (state[0] + raw.float().mean(),), state[0] * 2
    return jit_step(init, step, "cpu", name="counting")


def test_one_capture_at_the_first_call():
    """A compiled step's first call is one ``rtsdr.capture``; every later
    call one ``rtsdr.replay`` carrying the launches of ``per_step``."""
    init, step = _counting_step()
    raw = torch.ones(8, dtype=torch.uint8)
    state = init()
    with tr.profile():
        for _ in range(4):
            state, _ = step(state, raw)
    names = [r["name"] for r in tr.recorded()]
    assert names == ["rtsdr.capture"] + ["rtsdr.replay"] * 3
    assert all(r["attrs"] == {"launches": sum(step.per_step.values())}
               for r in tr.recorded()[1:])
    tr.clear()
    with tr.profile():
        state, _ = step(state, raw)
    assert [r["name"] for r in tr.recorded()] == ["rtsdr.replay"]


def test_block_index_and_parent():
    """A span given a block sets it for those that follow on its thread;
    one without takes its parent's, else the last given; the parent is the
    innermost open span."""
    with tr.profile():
        with tr.annotate("a", block=7):
            pass
        with tr.annotate("b"):
            with tr.annotate("c", block=2, n=1):
                with tr.annotate("d"):
                    pass
        with tr.annotate("e"):
            pass
    got = {r["name"]: (r["block"], r["parent"], r["attrs"])
           for r in tr.recorded()}
    assert got == {"a": (7, None, {}), "b": (7, None, {}),
                   "c": (2, "b", {"n": 1}), "d": (2, "c", {}),
                   "e": (2, None, {})}
    assert [r["name"] for r in tr.recorded()] == ["a", "d", "c", "b", "e"]


def test_cap_drops_and_counts(monkeypatch):
    """Records beyond ``CAP`` are dropped and counted; ``clear`` resets."""
    monkeypatch.setattr(tr, "CAP", 3)
    with tr.profile():
        for i in range(5):
            with tr.annotate("s", block=i):
                pass
    assert [r["block"] for r in tr.recorded()] == [0, 1, 2]
    assert tr.dropped() == 2
    tr.clear()
    assert tr.recorded() == [] and tr.dropped() == 0


def test_span_check_idle_arithmetic():
    """``tools/torch_span_check.py``'s device idle time and the share of it
    under the reads: busy intervals merged over streams, the gaps inside
    the wall, the overlap with the (merged) reads."""
    busy = span_check.union([(10, 20), (15, 30), (50, 60), (58, 70),
                             (90, 120)])
    assert busy == [(10, 30), (50, 70), (90, 120)]
    idle = span_check.gaps(busy, 0, 100)
    assert idle == [(0, 10), (30, 50), (70, 90)]
    assert span_check.gaps(busy, 12, 25) == []
    reads = [(0, 5), (32, 48), (40, 49), (60, 95)]
    assert span_check.covered(idle, reads) == 5 + 17 + 20
