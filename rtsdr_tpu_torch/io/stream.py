"""Host streaming loop: fd -> prefetching reader -> device step -> emitter.

Counterpart of ``rtsdr_tpu/io/stream.py``.  The host loop pipelines three
things: the C++ reader thread prefetches stdin blocks, eager launches
return before the device finishes, and, while the input runs ahead of the
loop, output fetch/emission of block b happens while block b+1 computes
(``io/staging.py``).  When the next block has not arrived (a live
source), block b is drained at once rather than a block period later.  A
block's frame outputs come to the host with its audio, as one fetch.  A
block's read and its drain are spans of ``utils/trace.py``
(``rtsdr.read``, ``rtsdr.emit``), each carrying the block's index; the
read also the reader's backlog when it began (``ready``), the drain
whether it came before the next block's read (``early``).  A pipe the
loop reads is made to hold a whole block, so that a writer's block
arrives in one read.
"""

from __future__ import annotations

import fcntl
import os
import stat
from typing import Callable

import numpy as np
import torch

from rtsdr_tpu_torch.config import ReceiverConfig
from rtsdr_tpu_torch.io.staging import Feeder, Fetcher
from rtsdr_tpu_torch.pipeline.frame import SYNDROME_NAMES, FrameOutputs
from rtsdr_tpu_torch.pipeline.receiver import Receiver
from rtsdr_tpu_torch.runtime import BlockReader, emit_int16_interleave
from rtsdr_tpu_torch.utils.jit import borrowing
from rtsdr_tpu_torch.utils.trace import annotate


def format_rds_events(frame_out) -> list[str]:
    """Render one station's frame-sync events (a ``FrameOutputs`` of host
    arrays) as the reference's stderr lines (src/fm_radio.cpp:652-712)."""
    lines = []
    n_w = int(frame_out.n_windows)
    sid = np.asarray(frame_out.syndrome_id)
    sync = np.asarray(frame_out.is_sync)
    fp = np.asarray(frame_out.is_false_pos)
    pos = np.asarray(frame_out.positions)
    resync = np.asarray(frame_out.is_resync)
    corr = np.asarray(frame_out.corrected)
    for w in range(n_w):
        if sid[w]:
            name = SYNDROME_NAMES[int(sid[w]) - 1]
            fixed = " (corrected)" if corr[w] else ""
            if sync[w]:
                lines.append(
                    f"Syndrome {name} at position {int(pos[w])}{fixed}")
            elif fp[w]:
                lines.append(
                    f"False positive Syndrome {name} at position {int(pos[w])}")
        if resync[w]:
            lines.append("~~~~~Re-Sync~~~~~")
    return lines


def hold_a_block(fd: int, nbytes: int) -> None:
    """Let the pipe that ``fd`` reads hold ``nbytes`` (one block), so that
    a block written at once arrives in one read instead of in turns of
    writer and reader a pipe's 64 KiB at a time.  A file or a terminal, a
    pipe that holds as much already, or a system that refuses is left as
    it is."""
    try:
        if (stat.S_ISFIFO(os.fstat(fd).st_mode)
                and fcntl.fcntl(fd, fcntl.F_GETPIPE_SZ) < nbytes):
            fcntl.fcntl(fd, fcntl.F_SETPIPE_SZ, nbytes)
    except (OSError, AttributeError):
        pass


def fetch_list(out) -> tuple:
    """The tensors of a step's outputs that the host loops fetch: left,
    right, then the frame outputs' leaves when the bit layer ran."""
    if isinstance(out.rds, FrameOutputs):
        return (out.left, out.right, *out.rds)
    return (out.left, out.right)


def fetched_frame(arrays: tuple):
    """``FrameOutputs`` of host arrays from what ``fetch_list`` fetched
    (None without the bit layer)."""
    return FrameOutputs(*arrays[2:]) if len(arrays) > 2 else None


class StreamRunner:
    """Single-station streaming receiver over a byte stream.  ``jit``
    (default True) and the other ``kwargs`` go to ``Receiver``: compiled,
    each block is copied straight into the step's static input and its
    outputs are fetched from the step's own buffers before the next step
    is enqueued.

    A block's outputs are drained after the next block's step is queued
    when that block is already waiting in the reader, and at once when it
    is not: the loop follows its input, with the same work and the same
    output either way."""

    def __init__(self, cfg: ReceiverConfig, dtype=torch.float32,
                 device="cuda", jit: bool = True, **kwargs):
        self.cfg = cfg
        self.rx = Receiver(cfg, (), dtype, device=device, jit=jit, **kwargs)

    def run(
        self,
        fd_in: int,
        emit: Callable[[bytes], None] | None = None,
        rds_log: Callable[[str], None] | None = None,
        max_blocks: int | None = None,
        audio_scale: float | None = None,
        frame_hook: Callable | None = None,
    ) -> dict:
        """Process blocks until EOF; returns summary stats.

        emit: called with interleaved int16 stereo bytes per block.
        rds_log: called per RDS frame-sync event line.
        frame_hook: called with each block's FrameOutputs as host arrays
        (e.g. a pipeline.groups.GroupDecoder.feed for payload decoding).
        """
        cfg = self.cfg
        scale = cfg.audio_scale if audio_scale is None else audio_scale
        state = self.rx.init()
        step, into = borrowing(self.rx.step, (cfg.block_size,))
        feeder = Feeder((cfg.block_size,), self.rx.device, into)
        fetcher = Fetcher(self.rx.device)
        n_blocks = 0
        n_syncs = 0
        n_false_pos = 0
        n_corrected = 0
        pending = None  # ticket for the previous block's outputs

        def drain(ticket, early=0):
            nonlocal n_syncs, n_false_pos, n_corrected
            if ticket is None:
                return
            with annotate("rtsdr.emit", block=ticket.block, early=early):
                arrays = fetcher.wait(ticket)
                if emit is not None:
                    emit(emit_int16_interleave(arrays[0], arrays[1],
                                               scale).tobytes())
                fo = fetched_frame(arrays)
                if fo is None:
                    return
                if rds_log is not None:
                    for line in format_rds_events(fo):
                        rds_log(line)
                if frame_hook is not None:
                    frame_hook(fo)
                # count accepted (26-spaced) syncs and false positives
                # separately: a log line is not necessarily a sync
                n_w = int(fo.n_windows)
                n_syncs += int(np.sum(fo.is_sync[:n_w]))
                n_false_pos += int(np.sum(fo.is_false_pos[:n_w]))
                n_corrected += int(np.sum(fo.corrected[:n_w]))

        hold_a_block(fd_in, cfg.block_size)
        with BlockReader(fd_in, cfg.block_size) as reader:
            while max_blocks is None or n_blocks < max_blocks:
                with annotate("rtsdr.read", block=n_blocks,
                              bytes=cfg.block_size) as span:
                    if span:
                        span.add(ready=reader.ready())
                    got = reader.read_block_into(feeder.staging())
                    if not got:
                        span.add(bytes=0)
                if not got:
                    break
                state, out = step(state, feeder.push())
                ticket = fetcher.start(fetch_list(out))
                drain(pending)  # overlap: emit block b-1 while b computes
                pending = ticket
                n_blocks += 1
                if reader.ready() == 0:
                    # the next block has not arrived: holding this one
                    # would make it wait for it
                    drain(pending, early=1)
                    pending = None
        drain(pending)
        return {"blocks": n_blocks, "rds_events": n_syncs,
                "rds_false_positives": n_false_pos,
                "rds_corrected": n_corrected}
