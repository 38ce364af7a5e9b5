"""Host<->device staging for the streaming loops.

Eager PyTorch launches return before the device finishes, so the host
loop overlaps with device compute as long as no call blocks.  Two things
would block: a pageable host->device copy, and fetching a block's outputs
after the NEXT block's kernels were enqueued on the same stream.  So:

  * ``Feeder`` copies each input block into one of TWO pinned staging
    buffers, alternated per block, and issues a ``non_blocking`` copy to
    the device.  Buffer b is free again by iteration b+2: draining block
    b's outputs on iteration b+1 waits for an event recorded after block
    b's step, and that step consumed the input.
  * ``Fetcher`` enqueues the device->host copies of block b's outputs
    right after block b's step (before block b+1 is enqueued) into
    alternating pinned buffers and records an event; ``wait`` on iteration
    b+1 blocks only until those copies are done — block b+1 keeps
    computing meanwhile.

On the CPU device both degrade to plain tensor/numpy copies.

Each call is a span of ``utils/trace.py`` (``rtsdr.push``,
``rtsdr.fetch_start``, ``rtsdr.fetch_wait``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

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


class Fetcher:
    """Device outputs -> host numpy arrays, one block behind the device."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._bufs: list = [None, None]
        self._slot = 0

    def start(self, tensors: tuple) -> Ticket:
        """Begin fetching ``tensors``; returns a ticket for ``wait``."""
        with annotate("rtsdr.fetch_start", copies=len(tensors)) as span:
            event, arrays = self._start(tensors)
            if span:
                span.add(bytes=sum(a.nbytes for a in arrays))
        return Ticket(event, arrays, span.block)

    def _start(self, tensors: tuple):
        if not self.cuda:
            # copies: a compiled step's outputs are its own buffers, which
            # the next step overwrites
            return None, tuple(t.numpy().copy() for t in tensors)
        self._slot ^= 1
        bufs = self._bufs[self._slot]
        if (bufs is None or len(bufs) != len(tensors)
                or any(b.shape != t.shape or b.dtype != t.dtype
                       for b, t in zip(bufs, tensors))):
            bufs = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         for t in tensors)
            self._bufs[self._slot] = bufs
        for b, t in zip(bufs, tensors):
            b.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return event, tuple(b.numpy() for b in bufs)

    @staticmethod
    def wait(ticket: Ticket) -> tuple:
        """Block until the ticket's copies are done; the host arrays (valid
        until the next-but-one ``start``)."""
        with annotate("rtsdr.fetch_wait", block=ticket.block):
            if ticket.event is not None:
                ticket.event.synchronize()
        return ticket.arrays
