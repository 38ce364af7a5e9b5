"""Host<->device staging and the one host loop that drives it.

Eager PyTorch launches return before the device finishes, so the host
loop overlaps with device compute as long as no call blocks.  Two things
would block: a pageable host->device copy, and fetching a block's outputs
after the NEXT block's kernels were enqueued on the same stream.  So:

  * ``Feeder`` copies each input block into one of TWO pinned staging
    buffers, alternated per block, and issues a ``non_blocking`` copy to
    the device.  Buffer b is free again by iteration b+2: draining block
    b's outputs on iteration b+1 waits for the fetch's event F, which
    follows its snapshot's event E, which follows block b's step, and
    that step consumed the input.
  * ``Fetcher`` snapshots block b's outputs right after block b's step,
    on the step's stream: device-to-device copies into a packed device
    buffer (two, alternated per block; each tensor a view at an
    ``ALIGN``-byte offset; a copy of its own for a tensor of
    ``ALONE_BYTES`` or more, one copy launch a dtype for the others),
    then event E.  A side stream, one per
    device, waits on E and makes ONE device-to-host copy of the packed
    buffer into a pinned buffer of the same layout, then event F.  The
    host arrays are numpy views of that pinned buffer.  So the copy to
    the host runs beside block b+1's step on the device, which has
    nothing to wait for but the snapshot; ``wait`` on iteration b+1
    blocks until F.  Before block b+2's snapshot writes the buffer that
    block b's copy reads, the step's stream waits on that copy's F.

On the CPU device the snapshot is the host buffer itself, in the same
packed layout and alternation, with no streams or events.

``run_blocks`` is the loop every runner goes through (``StreamRunner``,
``BatchRunner``, the CLI's wideband decode): read, push, step, start the
fetch, drain the block before.  Each call is a span of ``utils/trace.py``
(``rtsdr.read``, ``rtsdr.push``, ``rtsdr.fetch_start``,
``rtsdr.fetch_wait``, ``rtsdr.emit``).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from rtsdr_tpu_torch.utils.jit import borrowing
from rtsdr_tpu_torch.utils.trace import annotate


class Feeder:
    """numpy uint8 blocks -> device tensors through pinned staging.

    ``into``: a device tensor each block is copied into (a compiled step's
    static input buffer, ``utils/jit.py``), in place of a new tensor per
    block; the step that reads it is enqueued after the copy, and the next
    copy after that step, on the same stream."""

    def __init__(self, shape: tuple, device: torch.device, into=None):
        self.device = device
        self.cuda = device.type == "cuda"
        self._bufs = [torch.empty(shape, dtype=torch.uint8,
                                  pin_memory=self.cuda) for _ in range(2)]
        self._slot = 0
        self.into = into
        self.nbytes = self._bufs[0].nbytes

    def staging(self) -> np.ndarray:
        """The next staging buffer as a numpy view (fill it, then call
        ``push``)."""
        self._slot ^= 1
        return self._bufs[self._slot].numpy()

    def push(self) -> torch.Tensor:
        """Device tensor of the buffer ``staging`` last handed out."""
        buf = self._bufs[self._slot]
        with annotate("rtsdr.push", bytes=self.nbytes):
            if self.into is not None:
                return self.into.copy_(buf, non_blocking=True)
            if not self.cuda:
                return buf.clone()
            return buf.to(self.device, non_blocking=True)


class Ticket(NamedTuple):
    """A fetch under way: the event after its copies (None on the CPU),
    the host arrays, and the block it serves (``utils/trace.py``; None
    while no session records)."""
    event: object
    arrays: tuple
    block: int | None


#: bytes to which each tensor's offset in a fetch's packed buffers is
#: rounded up (the device allocator's own alignment)
ALIGN = 256
#: a tensor of at least this many bytes is snapshotted by a copy of its
#: own; smaller ones share one fused copy kernel a dtype, which spares the
#: host a call each.  The fused kernel runs one thread block per 64 Ki
#: elements, so on a tensor of a few hundred KB it is slower than a copy
#: (on an H100, the 13 outputs of 1,024 stations: 36 us of device time a
#: fetch by 13 copies, 56 by one kernel a dtype; of one station: 217 us
#: of host a fetch by 13 copies, 108 by one kernel a dtype)
ALONE_BYTES = 1 << 16


def packed_offsets(tensors) -> tuple[tuple, int]:
    """The byte offsets of ``tensors`` packed in turn into one buffer,
    each a multiple of ``ALIGN``, and the buffer's size."""
    offsets, end = [], 0
    for t in tensors:
        offsets.append(end)
        end += -(-t.numel() * t.element_size() // ALIGN) * ALIGN
    return tuple(offsets), end


def _views(buf: torch.Tensor, tensors, offsets) -> tuple:
    """Views of the byte buffer ``buf`` with the dtype and shape of each
    of ``tensors``, at its offset."""
    return tuple(buf[o:o + t.numel() * t.element_size()]
                 .view(t.dtype).view(t.shape)
                 for t, o in zip(tensors, offsets))


@functools.cache
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream that a device's fetches copy to the host on, made
    once."""
    return torch.cuda.Stream(device)


class _Events(tuple):
    """The events of one fetch's copies from several devices, waited on
    as one."""

    def synchronize(self) -> None:
        for e in self:
            e.synchronize()


class _Slot:
    """One block's fetch of the tensors on one device: the packed snapshot
    on the device (the host buffer itself on the CPU), the pinned host
    buffer and the host arrays (numpy views of it); on a CUDA device the
    event after the last copy that read the snapshot (None before it)."""

    def __init__(self, tensors: list, device: torch.device):
        self.key = [(t.dtype, t.shape) for t in tensors]
        offsets, nbytes = packed_offsets(tensors)
        cuda = device.type == "cuda"
        self.host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=cuda)
        self.dev = self.done = None
        if cuda:
            self.side = _side_stream(device)
            self.dev = torch.empty(nbytes, dtype=torch.uint8, device=device)
            # freed while a copy may still read it: not reused before then
            self.dev.record_stream(self.side)
        targets = _views(self.host if self.dev is None else self.dev,
                         tensors, offsets)
        # (place, target) of each tensor copied alone; one copy launch a
        # dtype for the others: (their places, their targets)
        self.alone = []
        by_dtype: dict = {}
        for i, (t, v) in enumerate(zip(tensors, targets)):
            if v.nbytes >= ALONE_BYTES:
                self.alone.append((i, v))
            else:
                by_dtype.setdefault(t.dtype, ([], []))
                by_dtype[t.dtype][0].append(i)
                by_dtype[t.dtype][1].append(v)
        self.groups = list(by_dtype.values())
        self.arrays = tuple(v.numpy()
                            for v in _views(self.host, tensors, offsets))

    def fill(self, tensors: list):
        """Snapshot ``tensors`` and queue the copy to the host; the event
        after that copy (None on the CPU)."""
        if self.dev is not None:
            step = torch.cuda.current_stream(self.dev.device)
            if self.done is not None:
                step.wait_event(self.done)   # the last copy has read it
        for i, target in self.alone:
            target.copy_(tensors[i])
        for idx, targets in self.groups:
            torch._foreach_copy_(targets, [tensors[i] for i in idx])
        if self.dev is None:
            return None
        snapped = torch.cuda.Event()
        snapped.record(step)
        self.side.wait_event(snapped)
        with torch.cuda.stream(self.side):
            self.host.copy_(self.dev, non_blocking=True)
        # an event of this copy alone: a ticket waits on its own block
        self.done = torch.cuda.Event()
        self.done.record(self.side)
        return self.done


class Fetcher:
    """Device outputs -> host numpy arrays, one block behind the device:
    a snapshot on the step's stream, one copy to the host beside the next
    step (module docstring).  The tensors' own devices decide the route,
    a snapshot and a side stream for each device they lie on, not
    ``device`` (the step's, as its callers name it)."""

    def __init__(self, device: torch.device):
        self._slots: list = [{}, {}]   # per block in turn: device -> _Slot
        self._slot = 0

    def start(self, tensors: tuple) -> Ticket:
        """Begin fetching ``tensors``; returns a ticket for ``wait``."""
        with annotate("rtsdr.fetch_start", copies=len(tensors)) as span:
            event, arrays = self._start(tensors)
            if span:
                span.add(bytes=sum(a.nbytes for a in arrays),
                         side=int(event is not None))
        return Ticket(event, arrays, span.block)

    def _start(self, tensors: tuple):
        self._slot ^= 1
        slots = self._slots[self._slot]
        by_device: dict = {}
        for i, t in enumerate(tensors):
            by_device.setdefault(t.device, []).append(i)
        arrays: list = [None] * len(tensors)
        events = []
        for device, idx in by_device.items():
            leaves = [tensors[i] for i in idx]
            slot = slots.get(device)
            if slot is None or slot.key != [(t.dtype, t.shape)
                                            for t in leaves]:
                slot = slots[device] = _Slot(leaves, device)
            done = slot.fill(leaves)
            if done is not None:
                events.append(done)
            for i, a in zip(idx, slot.arrays):
                arrays[i] = a
        event = (None if not events else events[0] if len(events) == 1
                 else _Events(events))
        return event, tuple(arrays)

    @staticmethod
    def wait(ticket: Ticket) -> tuple:
        """Block until the ticket's copies are done; the host arrays (valid
        until the next-but-one ``start``)."""
        with annotate("rtsdr.fetch_wait", block=ticket.block):
            if ticket.event is not None:
                ticket.event.synchronize()
        return ticket.arrays


def run_blocks(source, step, state, shape: tuple, device: torch.device,
               fetch: Callable, drain: Callable, *,
               max_blocks: int | None = None, early: bool = False) -> int:
    """Step ``step`` over the blocks of ``source`` until it ends or
    ``max_blocks`` have been read; returns the blocks stepped.

    ``source``: ``read_block_into(buf)`` fills a staging buffer of
    ``shape``, False at the end (``taken``, where the source has it: the
    bytes it read before the end); ``ready()``, the whole blocks waiting
    (``runtime.BlockReader``, ``io/batch.py::RowReader``).  Each block is
    read under ``rtsdr.read`` (``bytes``, and ``ready`` asked only while a
    session records), pushed, stepped (``utils/jit.py::borrowing`` of
    ``step``, taken at each call), and its fetch of ``fetch(outputs)``
    started; then the block before is drained: ``drain(host arrays)``
    under ``rtsdr.emit`` while this block computes.  ``early``: after the
    step, drain at once when ``source.ready()`` is 0 (the next block has
    not arrived: holding this one would make it wait for it), span
    attribute ``early`` 1; otherwise each block is held until the next has
    been read (``early`` 0)."""
    step, into = borrowing(step, shape)
    feeder = Feeder(shape, device, into)
    fetcher = Fetcher(device)

    def finish(ticket, early):
        with annotate("rtsdr.emit", block=ticket.block, early=early):
            drain(fetcher.wait(ticket))

    n_blocks = 0
    pending = None  # ticket for the previous block's outputs
    while max_blocks is None or n_blocks < max_blocks:
        with annotate("rtsdr.read", block=n_blocks,
                      bytes=feeder.nbytes) as span:
            if span:
                span.add(ready=source.ready())
            got = source.read_block_into(feeder.staging())
            if not got:
                span.add(bytes=getattr(source, "taken", 0))
        if not got:
            break
        state, out = step(state, feeder.push())
        ticket = fetcher.start(fetch(out))
        if pending is not None:
            finish(pending, 0)  # overlap: emit block b-1 while b computes
        pending = ticket
        n_blocks += 1
        if early and source.ready() == 0:
            finish(pending, 1)
            pending = None
    if pending is not None:
        finish(pending, 0)
    return n_blocks
