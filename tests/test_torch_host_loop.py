"""The host loop every runner goes through
(``rtsdr_tpu_torch/io/staging.py::run_blocks``), driven by scripted
sources: fixed blocks and a fixed sequence of ``ready()`` answers, with no
pipe and no thread, so that the order of reads and drains, each span's
attributes and the blocks each drain is given are fixed by the script
alone.  Cases: the early rule on and off, ``max_blocks``, no profiler
session, and ``io/batch.py::RowReader`` over three streams that ends on
row 1."""

import numpy as np
import pytest
import torch

from rtsdr_tpu_torch.io.batch import RowReader
from rtsdr_tpu_torch.io.staging import run_blocks
from rtsdr_tpu_torch.utils import trace as tr

B = 8   # bytes a block
CPU = torch.device("cpu")


class Scripted:
    """A reader of fixed blocks whose ``ready()`` answers are scripted;
    each read and each end is logged."""

    def __init__(self, blocks, ready, log):
        self.blocks = list(blocks)
        self.answers = list(ready)
        self.log = log

    def ready(self) -> int:
        return self.answers.pop(0)

    def read_block_into(self, buf) -> bool:
        if not self.blocks:
            self.log.append("end")
            return False
        buf[:] = self.blocks.pop(0)
        self.log.append("read")
        return True


def _block(value):
    return np.full(B, value, np.uint8)


# read r / drain d of block b; "end": the read that met the end.
# spans: (name, block, attrs) of every rtsdr.read and rtsdr.emit, in order
CASES = {
    "early": dict(
        rows=1, early=True, session=True, max_blocks=None,
        # read 0, after step 0, read 1, after step 1, ..., the end's read
        ready=[1, 0, 0, 1, 1, -1, -1], n_blocks=3,
        order=["read", "d0", "read", "read", "d1", "end", "d2"],
        spans=[("read", 0, {"bytes": B, "ready": 1}),
               ("emit", 0, {"early": 1}),
               ("read", 1, {"bytes": B, "ready": 0}),
               ("read", 2, {"bytes": B, "ready": 1}),
               ("emit", 1, {"early": 0}),
               ("read", 3, {"bytes": 0, "ready": -1}),
               ("emit", 2, {"early": 0})]),
    "held": dict(
        rows=1, early=False, session=True, max_blocks=None,
        ready=[1, 0, 1, -1], n_blocks=3,
        order=["read", "read", "d0", "read", "d1", "end", "d2"],
        spans=[("read", 0, {"bytes": B, "ready": 1}),
               ("read", 1, {"bytes": B, "ready": 0}),
               ("emit", 0, {"early": 0}),
               ("read", 2, {"bytes": B, "ready": 1}),
               ("emit", 1, {"early": 0}),
               ("read", 3, {"bytes": 0, "ready": -1}),
               ("emit", 2, {"early": 0})]),
    "max_blocks": dict(
        rows=1, early=True, session=True, max_blocks=2,
        ready=[1, 1, 1, 0], n_blocks=3,
        order=["read", "read", "d0", "d1"],
        spans=[("read", 0, {"bytes": B, "ready": 1}),
               ("read", 1, {"bytes": B, "ready": 1}),
               ("emit", 0, {"early": 0}),
               ("emit", 1, {"early": 1})]),
    "early_off_session": dict(
        rows=1, early=True, session=False, max_blocks=None,
        # only the rule asks, once after each step
        ready=[0, 1, -1], n_blocks=3,
        order=["read", "d0", "read", "read", "d1", "end", "d2"],
        spans=[]),
    "batch_ends_on_row_1": dict(
        rows=3, early=False, session=True, max_blocks=None,
        # per row: 2, 1 and 2 blocks; each row's answers at reads 0 and 1
        ready=[[2, 1], [1, -1], [3, 1]], n_blocks=[2, 1, 2],
        order=["read"] * 3 + ["read", "end", "d0"],
        spans=[("read", 0, {"bytes": 3 * B, "ready": 1}),
               ("read", 1, {"bytes": B, "ready": -1}),
               ("emit", 0, {"early": 0})]),
}


@pytest.fixture(autouse=True)
def _fresh():
    tr.clear()
    yield
    tr.clear()


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_blocks_order_spans_and_drains(case):
    """The loop's reads and drains in the script's order; ``bytes`` and
    ``ready`` on every ``rtsdr.read`` (the end's read: the bytes taken
    before the end), ``early`` on every ``rtsdr.emit``; one drain a
    stepped block, given that block's arrays; every scripted ``ready()``
    asked, and no more."""
    c = CASES[case]
    log = []
    if c["rows"] == 1:
        blocks = [_block(b + 1) for b in range(c["n_blocks"])]
        source = Scripted(blocks, c["ready"], log)
        readers = [source]
        shape = (B,)
    else:
        readers = [Scripted([_block(10 * r + b + 1) for b in range(n)],
                            c["ready"][r], log)
                   for r, n in enumerate(c["n_blocks"])]
        source = RowReader(readers, B)
        shape = (c["rows"], B)
    steps = []

    def step(state, raw):
        steps.append(state)
        return state + 1, (raw.clone(),)

    drained = []

    def drain(arrays):
        (got,) = arrays
        b = len(drained)
        log.append(f"d{b}")
        drained.append(got.copy())

    def run():
        return run_blocks(source, step, 0, shape, CPU, lambda out: out,
                          drain, max_blocks=c["max_blocks"],
                          early=c["early"])
    if c["session"]:
        with tr.profile():
            n = run()
    else:
        n = run()

    n_stepped = sum(o.startswith("d") for o in c["order"])
    assert n == n_stepped and steps == list(range(n_stepped))
    assert log == c["order"]
    assert [(r["name"].removeprefix("rtsdr."), r["block"], r["attrs"])
            for r in tr.recorded()
            if r["name"] in ("rtsdr.read", "rtsdr.emit")] == c["spans"]
    assert all(not r.answers for r in readers)
    assert len(drained) == n
    for b, got in enumerate(drained):
        if c["rows"] == 1:
            want = _block(b + 1)
        else:
            want = np.stack([_block(10 * r + b + 1)
                             for r in range(c["rows"])])
        np.testing.assert_array_equal(got, want)
