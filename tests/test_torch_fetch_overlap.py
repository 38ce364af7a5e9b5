"""``io/staging.py::Fetcher``: a block's outputs snapshotted into one packed
buffer, then one copy to the host, the arrays numpy views of a packed host
buffer in two slots used in turns.

On the CPU the snapshot is the host buffer itself, so these tests hold the
layout (offsets, dtypes, shapes, the slots' alternation, new buffers for a
new shape) and the span's attributes.  The tests marked ``gpu`` hold what
only a card has: the side stream's copy equal to ``.cpu()``, the
next-but-one snapshot held back behind a copy that still reads its slot,
the step's next kernel starting before the copy ends, and ``Feeder``'s
staging buffer not refilled before its step read it.  On a card:
``python -m pytest --noconftest tests/test_torch_fetch_overlap.py -m gpu``.
"""

import time

import numpy as np
import pytest
import torch

from rtsdr_tpu_torch.io import staging
from rtsdr_tpu_torch.io.staging import (
    ALIGN, ALONE_BYTES, Fetcher, packed_offsets)
from rtsdr_tpu_torch.utils import trace as tr

CPU = torch.device("cpu")


def _leaves(case: str, device="cpu", seed: int = 0) -> tuple:
    """Tensors of float32, int32 and bool, of mixed shapes."""
    g = torch.Generator().manual_seed(seed)

    def f32(*shape):
        return torch.randn(shape, generator=g)

    def i32(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=g,
                             dtype=torch.int32)

    def flag(*shape):
        return torch.randint(0, 2, shape, generator=g).bool()

    sets = {
        # a 0-d and a one-element leaf among odd sizes
        "mixed": (f32(3, 5), i32(7), flag(4, 3), i32(), f32(1)),
        # io/stream.py::fetch_list at C = 2: left, right, the bit layer
        "receiver": (f32(2, 3072), f32(2, 3072), i32(2), f32(2, 152),
                     f32(2, 152), i32(2), i32(2, 77), flag(2, 77),
                     flag(2, 77), i32(2, 77), flag(2, 77), i32(2, 77),
                     flag(2, 77)),
        # one-byte leaves that end off ALIGN, a 0-d bool, an empty leaf,
        # a leaf that is a transposed view
        "ragged": (flag(1), flag(3), torch.tensor(True), f32(0, 4),
                   f32(5, 3).t(), i32(1, 1)),
        # leaves of ALONE_BYTES and more, copied alone, among small ones
        "wide": (i32(5), f32(30, 1024), flag(2, 3), f32(1024, 30).t(),
                 f32(2, 4)),
    }
    return tuple(t.to(device) for t in sets[case])


def _changed(tensors) -> None:
    """Overwrite every tensor with other values, as the next step would."""
    for t in tensors:
        if t.dtype == torch.bool:
            t.logical_not_()
        else:
            t.add_(1)


def _assert_fetched(arrays, tensors) -> None:
    assert len(arrays) == len(tensors)
    for a, t in zip(arrays, tensors):
        want = t.cpu().numpy()
        assert isinstance(a, np.ndarray)
        assert a.dtype == want.dtype and a.shape == want.shape
        np.testing.assert_array_equal(a, want)


CASES = ["mixed", "receiver", "ragged", "wide"]


@pytest.fixture(autouse=True)
def _no_records():
    tr.clear()
    yield
    tr.clear()


@pytest.mark.parametrize("case", CASES)
def test_fetched_arrays_equal_the_tensors(case):
    """Every leaf's dtype, shape and values, each at an offset that is a
    multiple of ``ALIGN`` (at least 16 bytes) from the first."""
    tensors = _leaves(case)
    f = Fetcher(CPU)
    arrays = f.wait(f.start(tensors))
    _assert_fetched(arrays, tensors)
    offsets, nbytes = packed_offsets(tensors)
    assert ALIGN >= 16 and all(o % ALIGN == 0 for o in offsets)
    assert nbytes % ALIGN == 0
    assert nbytes >= sum(t.numel() * t.element_size() for t in tensors)
    if case == "wide":
        assert sum(t.numel() * t.element_size() >= ALONE_BYTES
                   for t in tensors) == 2
    # one host buffer holds them all, each leaf at its offset
    base = arrays[0].ctypes.data
    for a, o in zip(arrays, offsets):
        assert a.size == 0 or a.ctypes.data - base == o


@pytest.mark.parametrize("case", CASES)
def test_wait_gives_the_values_at_start(case):
    """The sources overwritten after ``start`` (as the next replay
    overwrites a compiled step's outputs): ``wait`` gives the old values."""
    tensors = _leaves(case)
    before = [t.clone() for t in tensors]
    f = Fetcher(CPU)
    ticket = f.start(tensors)
    _changed(tensors)
    _assert_fetched(f.wait(ticket), before)


@pytest.mark.parametrize("case", CASES)
def test_arrays_live_until_the_next_but_one_start(case):
    """Block b's arrays stay intact through block b + 1's ``start`` and
    take block b + 2's values at its ``start``: two slots, in turns."""
    tensors = _leaves(case)
    f = Fetcher(CPU)
    blocks, arrays = [], []
    for _ in range(3):
        blocks.append([t.clone() for t in tensors])
        arrays.append(f.wait(f.start(tensors)))
        if len(arrays) == 2:
            _assert_fetched(arrays[0], blocks[0])
        _changed(tensors)
    _assert_fetched(arrays[1], blocks[1])
    _assert_fetched(arrays[2], blocks[2])
    _assert_fetched(arrays[0], blocks[2])
    for a0, a2 in zip(arrays[0], arrays[2]):
        assert a0.size == 0 or np.shares_memory(a0, a2)
    assert not any(np.shares_memory(a0, a1)
                   for a0, a1 in zip(arrays[0], arrays[1]))


def _reshaped(tensors, how: str) -> tuple:
    first, *rest = tensors
    if how == "shape":
        first = torch.cat([first.reshape(-1), first.reshape(-1)])
    elif how == "dtype":
        first = first.to(torch.float64)
    else:                       # "count": one leaf fewer
        return tuple(rest)
    return (first, *rest)


@pytest.mark.parametrize("how", ["shape", "dtype", "count"])
@pytest.mark.parametrize("case", CASES)
def test_new_shape_gets_new_buffers(case, how):
    """A slot whose leaves change shape, dtype or number is built anew:
    the earlier block's arrays keep their values, the new ones are right."""
    tensors = _leaves(case)
    f = Fetcher(CPU)
    first = f.wait(f.start(tensors))
    kept = [a.copy() for a in first]
    f.wait(f.start(tensors))
    other = _reshaped(tensors, how)
    _changed(other)
    got = f.wait(f.start(other))
    _assert_fetched(got, other)
    for a, k in zip(first, kept):
        np.testing.assert_array_equal(a, k)
        assert not any(np.shares_memory(a, b) for b in got if a.size)
    # back to the first layout: the other slot still has it, this one is
    # built anew again
    _assert_fetched(f.wait(f.start(tensors)), tensors)
    _changed(tensors)
    _assert_fetched(f.wait(f.start(tensors)), tensors)


@pytest.mark.parametrize("case", CASES)
def test_fetch_start_span(case):
    """``rtsdr.fetch_start``: ``copies`` the leaves, ``bytes`` their sum,
    ``side`` 0 on the CPU; ``rtsdr.fetch_wait`` on the same block."""
    tensors = _leaves(case)
    f = Fetcher(CPU)
    with tr.profile():
        f.wait(f.start(tensors))
    recs = tr.recorded()
    (start,) = [r for r in recs if r["name"] == "rtsdr.fetch_start"]
    assert start["attrs"] == {
        "copies": len(tensors),
        "bytes": sum(t.numel() * t.element_size() for t in tensors),
        "side": 0}
    (wait,) = [r for r in recs if r["name"] == "rtsdr.fetch_wait"]
    assert wait["t0_ns"] >= start["t1_ns"]


# -------------------------------------------------------------- on a card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: streams and events have no CPU form")
    return torch.device("cuda", torch.cuda.current_device())


def _sleep_on(stream, ms: float) -> None:
    """Hold ``stream`` for about ``ms`` (at up to 2 GHz)."""
    with torch.cuda.stream(stream):
        torch.cuda._sleep(int(ms * 2e6))


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_card_fetch_equals_cpu(card, case):
    """The arrays equal ``.cpu()`` of each leaf, block after block, with
    the sources overwritten after each ``start``; ``side`` 1."""
    tensors = _leaves(case, card)
    f = Fetcher(card)
    pending, want = None, None
    with tr.profile():
        for _ in range(4):
            now = [t.cpu() for t in tensors]
            ticket = f.start(tensors)
            _changed(tensors)
            if pending is not None:
                _assert_fetched(f.wait(pending), want)
            pending, want = ticket, now
        _assert_fetched(f.wait(pending), want)
    starts = [r for r in tr.recorded() if r["name"] == "rtsdr.fetch_start"]
    assert [r["attrs"]["side"] for r in starts] == [1] * 4
    assert all(r["attrs"]["copies"] == len(tensors) for r in starts)


@pytest.mark.gpu
def test_card_next_but_one_snapshot_waits_for_the_copy(card):
    """The side stream held before block 0's copy: block 2's snapshot,
    which writes block 0's slot, must wait until that copy has read it.
    A second hold before block 2's copy keeps block 0's host arrays
    unwritten while they are read."""
    tensors = _leaves("receiver", card)
    side = staging._side_stream(card)
    f = Fetcher(card)
    blocks, tickets = [], []
    torch.cuda.synchronize()
    _sleep_on(side, 200)                 # holds block 0's copy back
    for b in range(3):
        if b == 2:
            _sleep_on(side, 200)         # holds block 2's copy back
        blocks.append([t.cpu() for t in tensors])
        tickets.append(f.start(tensors))
        _changed(tensors)
    snap2 = torch.cuda.Event()
    snap2.record()                       # after block 2's snapshot
    time.sleep(0.05)
    assert not snap2.query(), "block 2's snapshot ran before block 0's copy"
    _assert_fetched(f.wait(tickets[0]), blocks[0])
    _assert_fetched(f.wait(tickets[1]), blocks[1])
    _assert_fetched(f.wait(tickets[2]), blocks[2])


@pytest.mark.gpu
def test_card_copy_overlaps_the_next_kernel(card):
    """A kernel queued on the step's stream right after ``start`` begins
    before the copy to the host ends: the copy runs beside it."""
    g = torch.Generator(device=card).manual_seed(3)
    # about 27 MB, as the outputs of 1,024 stations
    tensors = (torch.randn((1024, 3072), generator=g, device=card),
               torch.randn((1024, 3072), generator=g, device=card),
               torch.randint(0, 2, (1024, 77), generator=g,
                             device=card).bool())
    f = Fetcher(card)
    f.wait(f.start(tensors))             # buffers made, warm
    f.wait(f.start(tensors))
    side = staging._side_stream(card)
    began, copied = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    ticket = f.start(tensors)
    began.record()                       # the step's stream: next kernel
    torch.cuda._sleep(int(2e6))
    copied.record(side)                  # the side stream: after the copy
    f.wait(ticket)
    torch.cuda.synchronize()
    ahead_ms = began.elapsed_time(copied)
    assert ahead_ms > 0.05, (
        f"the next kernel began {ahead_ms:.3f} ms before the copy ended")


@pytest.mark.gpu
def test_card_feeder_input_not_refilled_before_its_step(card):
    """``run_blocks`` with a step held by ``_sleep`` before it reads its
    input: every step sees its own block, so no staging buffer was
    refilled before the step it feeds had read it."""
    n_blocks, nbytes = 8, 1 << 20

    class Source:
        def __init__(self):
            self.b = 0

        def ready(self):
            return 1

        def read_block_into(self, buf):
            if self.b == n_blocks:
                return False
            buf[:] = self.b + 1
            self.b += 1
            return True

    def step(state, raw):
        torch.cuda._sleep(int(20e6))     # about 10 ms before the read
        return state, (raw.clone(),)

    seen = []

    def drain(arrays):
        (got,) = arrays
        seen.append((int(got.min()), int(got.max())))

    n = staging.run_blocks(Source(), step, None, (nbytes,), card,
                           lambda out: out, drain)
    assert n == n_blocks
    assert seen == [(b + 1, b + 1) for b in range(n_blocks)]
