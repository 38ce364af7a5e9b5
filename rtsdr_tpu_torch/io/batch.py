"""Multi-fd batched streaming: N capture streams -> ONE batched device step.

Counterpart of ``rtsdr_tpu/io/batch.py``: each fd gets its own prefetching
C++ BlockReader (one producer thread per fd), the N blocks land in the
rows of one pinned staging array (``RowReader``, through
``BlockReader.read_block_into`` — no per-block allocations), and the
device sees a single (N, block_size) ``non_blocking`` transfer per step,
in the host loop of ``io/staging.py::run_blocks``.  Unlike the
single-station ``StreamRunner``, the loop holds block b until block b+1
is read even when b+1 has not arrived: a rule that drains early would
have to ask all N readers.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from rtsdr_tpu_torch.config import ReceiverConfig
from rtsdr_tpu_torch.io.staging import run_blocks
from rtsdr_tpu_torch.io.stream import fetch_list, station_outputs
from rtsdr_tpu_torch.pipeline.receiver import Receiver
from rtsdr_tpu_torch.runtime import BlockReader


class RowReader:
    """N readers as one source of ``run_blocks``: a block is a row from
    each, read in lock-step (as the batched state requires), and the end
    comes when ANY stream ends."""

    def __init__(self, readers: list, block_size: int):
        self.readers = readers
        self.block_size = block_size
        self.taken = 0      # bytes read in the read that met the end

    def ready(self) -> int:
        """The whole batches waiting in every reader: the least of them."""
        return min(r.ready() for r in self.readers)

    def read_block_into(self, buf: np.ndarray) -> bool:
        for c, r in enumerate(self.readers):
            if not r.read_block_into(buf[c]):
                self.taken = c * self.block_size
                return False
        return True


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

    def close(self) -> None:
        for r in self.readers:
            r.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

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
        def drain(arrays):
            # ONE device->host fetch per output leaf, then row slices
            for c in range(self.n):
                left, right, fo = station_outputs(arrays, c)
                if emit is not None:
                    emit(c, left, right)
                if fo is not None:
                    rds_hook(c, fo)

        blocks = run_blocks(
            RowReader(self.readers, self.cfg.block_size), self.rx.step,
            self.rx.init(), (self.n, self.cfg.block_size), self.rx.device,
            fetch_list if rds_hook is not None
            else lambda out: (out.left, out.right),
            drain, max_blocks=max_blocks)
        return {"blocks": blocks, "stations": self.n}
