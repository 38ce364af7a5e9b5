"""Host streaming loop: fd -> prefetching reader -> device step -> emitter.

Counterpart of ``rtsdr_tpu/io/stream.py``.  The host loop pipelines three
things: the C++ reader thread prefetches stdin blocks, eager launches
return before the device finishes, and output fetch/emission of block b
happens while block b+1 computes (``io/staging.py``).

``format_rds_events`` arrives with the frame layer (RDS slice).
"""

from __future__ import annotations

from typing import Callable

import torch

from rtsdr_tpu_torch.config import ReceiverConfig
from rtsdr_tpu_torch.io.staging import Feeder, Fetcher
from rtsdr_tpu_torch.pipeline.receiver import Receiver
from rtsdr_tpu_torch.runtime import BlockReader, emit_int16_interleave


class StreamRunner:
    """Single-station streaming receiver over a byte stream."""

    def __init__(self, cfg: ReceiverConfig, dtype=torch.float32,
                 device="cuda", **kwargs):
        self.cfg = cfg
        self.rx = Receiver(cfg, (), dtype, device=device, **kwargs)

    def run(
        self,
        fd_in: int,
        emit: Callable[[bytes], None] | None = None,
        max_blocks: int | None = None,
        audio_scale: float | None = None,
    ) -> dict:
        """Process blocks until EOF; returns summary stats.

        emit: called with interleaved int16 stereo bytes per block.
        """
        cfg = self.cfg
        scale = cfg.audio_scale if audio_scale is None else audio_scale
        state = self.rx.init()
        feeder = Feeder((cfg.block_size,), self.rx.device)
        fetcher = Fetcher(self.rx.device)
        n_blocks = 0
        pending = None  # ticket for the previous block's outputs

        def drain(ticket):
            if ticket is None:
                return
            left, right = fetcher.wait(ticket)
            if emit is not None:
                emit(emit_int16_interleave(left, right, scale).tobytes())

        with BlockReader(fd_in, cfg.block_size) as reader:
            while max_blocks is None or n_blocks < max_blocks:
                if not reader.read_block_into(feeder.staging()):
                    break
                state, out = self.rx.step(state, feeder.push())
                ticket = fetcher.start((out.left, out.right))
                drain(pending)  # overlap: emit block b-1 while b computes
                pending = ticket
                n_blocks += 1
        drain(pending)
        return {"blocks": n_blocks}
