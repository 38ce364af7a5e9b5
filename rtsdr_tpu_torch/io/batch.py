"""Multi-fd batched streaming: N capture streams -> ONE batched device step.

Counterpart of ``rtsdr_tpu/io/batch.py``: each fd gets its own prefetching
C++ BlockReader (one producer thread per fd), the N blocks land in the
rows of one pinned staging array (``BlockReader.read_block_into`` — no
per-block allocations), and the device sees a single (N, block_size)
``non_blocking`` transfer per step.  Two staging buffers alternate per
block and output fetch/emission of block b overlaps block b+1's compute
(``io/staging.py`` says why two are sufficient).  Unlike the
single-station ``StreamRunner``, the loop holds block b until block b+1
is read even when b+1 has not arrived: a rule that drains early would
have to ask all N readers.  The reader loop and each block's drain are
spans of ``utils/trace.py`` (``rtsdr.read``, ``rtsdr.emit`` with
``early`` = 0).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from rtsdr_tpu_torch.config import ReceiverConfig
from rtsdr_tpu_torch.io.staging import Feeder, Fetcher
from rtsdr_tpu_torch.io.stream import fetch_list, fetched_frame
from rtsdr_tpu_torch.pipeline.receiver import Receiver
from rtsdr_tpu_torch.runtime import BlockReader
from rtsdr_tpu_torch.utils.jit import borrowing
from rtsdr_tpu_torch.utils.trace import annotate


class BatchRunner:
    """N byte streams decoded as one channel-batched receiver.  ``jit``
    (default True) and the other ``kwargs`` go to ``Receiver``, as in
    ``StreamRunner``."""

    def __init__(self, cfg: ReceiverConfig, fds: list[int],
                 dtype=torch.float32, device="cuda", jit: bool = True,
                 **kwargs):
        self.cfg = cfg
        self.n = len(fds)
        self.rx = Receiver(cfg, (self.n,), dtype, device=device, jit=jit,
                           **kwargs)
        self.readers = [BlockReader(fd, cfg.block_size) for fd in fds]
        shape = (self.n, cfg.block_size)
        self._step, into = borrowing(self.rx.step, shape)
        self._feeder = Feeder(shape, self.rx.device, into)
        self._fetcher = Fetcher(self.rx.device)
        self.blocks_read = 0     # the streams' blocks read so far

    def close(self) -> None:
        for r in self.readers:
            r.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def read_batch(self) -> torch.Tensor | None:
        """Fill the next staging buffer from all N readers and start its
        transfer; None when ANY stream hits EOF (streams advance in
        lock-step, as the batched state requires)."""
        buf = self._feeder.staging()
        with annotate("rtsdr.read", block=self.blocks_read,
                      bytes=self._feeder.nbytes) as span:
            if span:    # the whole batches waiting in every reader
                span.add(ready=min(r.ready() for r in self.readers))
            for c, r in enumerate(self.readers):
                if not r.read_block_into(buf[c]):
                    span.add(bytes=c * self.cfg.block_size)
                    return None
        self.blocks_read += 1
        return self._feeder.push()

    def run(
        self,
        emit: Callable[[int, np.ndarray, np.ndarray], None] | None = None,
        rds_hook: Callable[[int, object], None] | None = None,
        max_blocks: int | None = None,
    ) -> dict:
        """Process blocks until EOF on any stream; returns stats.

        emit(channel, left, right): per-station float audio per block.
        rds_hook(channel, FrameOutputs): per-station frame outputs as host
        arrays (already sliced to the channel — feed a GroupDecoder, print
        events, ...).
        """
        state = self.rx.init()
        n_blocks = 0
        pending = None

        def drain(ticket):
            if ticket is None:
                return
            with annotate("rtsdr.emit", block=ticket.block, early=0):
                # ONE device->host fetch per output leaf, then row slices
                arrays = self._fetcher.wait(ticket)
                left, right = arrays[:2]
                rds = fetched_frame(arrays) if rds_hook is not None else None
                for c in range(self.n):
                    if emit is not None:
                        emit(c, left[c], right[c])
                    if rds is not None:
                        rds_hook(c, type(rds)(*(leaf[c] for leaf in rds)))

        while max_blocks is None or n_blocks < max_blocks:
            batch = self.read_batch()
            if batch is None:
                break
            state, out = self._step(state, batch)
            ticket = self._fetcher.start(
                fetch_list(out) if rds_hook is not None
                else (out.left, out.right))
            drain(pending)   # overlap: emit block b-1 while b computes
            pending = ticket
            n_blocks += 1
        drain(pending)
        return {"blocks": n_blocks, "stations": self.n}
