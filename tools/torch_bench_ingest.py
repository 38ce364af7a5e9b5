#!/usr/bin/env python3
"""Host ingest into the port's batched step: N pipes -> the rows of one
pinned staging array -> (``--device``) the compiled step's input buffer.

    python3 tools/torch_bench_ingest.py [--pipes 1 2 4 8 16 64]
        [--blocks 400] [--block-size 307200] [--device] [--copy-rows 1024]
        [--out FILE] [--cpu]

Counterpart of ``tools/bench_ingest.py``.  Each of N pipes is fed by a
writer thread (``os.write`` of a pre-made block in a loop: the pipe, the
reader and the staging, not synthesis) and read by one of the port's
``runtime.BlockReader``s (the C++ producer thread and its slot pool); the
N blocks of a step land in the rows of one pinned staging array handed out
by ``io/staging.py::Feeder``, as ``io/batch.py::RowReader`` fills it in
``BatchRunner``'s loop.  Pipe p sends its own two blocks in turn, so a row that took
another pipe's bytes, or a stale block, shows: each run checks the last
step's rows against what was written (``check_every`` checks every
step).  Reports per N the blocks and bytes read, aggregate GB/s, station
equivalents (GB/s / 4.8 MB/s, one MODE0 station's I/Q rate) and the
per-pipe rate against the first N's (1.0 = linear), with the thread
counts and the pipe's buffer size.

``--device`` extends the path as the JAX tool's flag does: ``Feeder.push``
copies each staging array into the static input buffer of a compiled
function (``utils/jit.py::jit_fn`` of a sum over the whole buffer, the
counterpart of ``_touch``) and replays it; a staging buffer is refilled
only after the step that read it has run.

``copy_vs_step`` (with ``--device``, at ``--copy-rows`` rows): the
host-to-device copy of one (rows, 307,200) block from pinned memory into a
device buffer, by CUDA events, and the compiled MODE0 step at that width
in the same process (``tools/torch_scaling_sweep.py::slope_seconds``, the
block written once into its input buffer).  ``BatchRunner`` makes the copy
and the step one after the other on one stream, so the larger of the two
sets its pace.

One JSON line per measurement with the card's name and power limit;
``--out`` also writes them to a file.  ``--cpu`` runs without a card
(staging not pinned, no ``--device``).
"""

from __future__ import annotations

import argparse
import fcntl
import json
import os
import resource
import statistics
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtsdr_tpu_torch.config import MODE0  # noqa: E402
from rtsdr_tpu_torch.io.staging import Feeder  # noqa: E402
from rtsdr_tpu_torch.runtime import BlockReader, have_native  # noqa: E402
from rtsdr_tpu_torch.utils.jit import jit_fn  # noqa: E402

#: one MODE0 station's I/Q bytes per second: 2.4 MS/s x 2 bytes
STATION_BYTES_PER_S = 2 * MODE0.rf.fs
PIPES = (1, 2, 4, 8, 16, 64)
F_GETPIPE_SZ = getattr(fcntl, "F_GETPIPE_SZ", 1032)


def _writer(fd: int, blocks: tuple, n_blocks: int) -> None:
    try:
        for b in range(n_blocks):
            view = memoryview(blocks[b % 2])
            while view:
                view = view[os.write(fd, view):]
    except BrokenPipeError:
        pass
    finally:
        os.close(fd)


def _touch(x: torch.Tensor) -> torch.Tensor:
    # the cheapest function that reads the whole buffer
    return x.sum(dtype=torch.int64)


def _room_for_fds(n: int) -> None:
    """Raise the soft limit on open files to ``n`` (within the hard limit):
    each pipe holds two descriptors until its writer closes one."""
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft != resource.RLIM_INFINITY and soft < n:
        resource.setrlimit(resource.RLIMIT_NOFILE, (
            n if hard == resource.RLIM_INFINITY else min(n, hard), hard))


def run_one(n_pipes: int, n_blocks: int, block_size: int, device=None,
            check_every: bool = False, seed: int = 0) -> dict:
    """N pipes x ``n_blocks`` blocks through ``BlockReader``s into the
    rows of a ``Feeder``'s staging array; ``device``: a CUDA device to
    extend the path to (``Feeder.push`` into a compiled function's input
    buffer), a pinned staging array without going there (``"pinned"``) or
    None (plain host memory)."""
    rng = np.random.default_rng(seed)
    blocks = [tuple(rng.integers(0, 256, block_size, dtype=np.uint8)
                    for _ in range(2)) for _ in range(n_pipes)]
    _room_for_fds(2 * n_pipes + 256)
    pipes = [os.pipe() for _ in range(n_pipes)]
    pipe_bytes = fcntl.fcntl(pipes[0][1], F_GETPIPE_SZ)
    threads = [threading.Thread(target=_writer, args=(w, blocks[p], n_blocks),
                                daemon=True)
               for p, (_, w) in enumerate(pipes)]
    readers = [BlockReader(r, block_size) for r, _ in pipes]
    shape = (n_pipes, block_size)
    cuda = device not in (None, "pinned")
    staging_dev = torch.device("cuda" if device == "pinned" else
                               device if cuda else "cpu")
    fn = out = None
    if cuda:
        fn = jit_fn(_touch, staging_dev, name="ingest touch")
        fn.borrowed(torch.zeros(shape, dtype=torch.uint8,
                                device=staging_dev))          # the capture
        into = fn.static_args()[0]
    else:
        into = None
    feeder = Feeder(shape, staging_dev, into)
    in_flight: list = []      # events of the steps reading each buffer
    got = 0
    wrong_rows = 0
    full = None               # the staging buffer of the last whole step
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    try:
        while True:
            if len(in_flight) == 2:         # the buffer about to be refilled
                in_flight.pop(0).synchronize()
            buf = feeder.staging()
            if not all(r.read_block_into(buf[c])
                       for c, r in enumerate(readers)):
                break
            full = buf
            if check_every:
                wrong_rows += sum(not np.array_equal(buf[c], blocks[c][got % 2])
                                  for c in range(n_pipes))
            if cuda:
                out = fn.borrowed(feeder.push())
                ev = torch.cuda.Event()
                ev.record()
                in_flight.append(ev)
            got += 1
        if cuda:
            torch.cuda.synchronize(staging_dev)
        dt = time.perf_counter() - t0
        last = (got - 1) % 2
        last_ok = got > 0 and all(np.array_equal(full[c], blocks[c][last])
                                  for c in range(n_pipes))
        device_sum_ok = None
        if cuda and got:
            want = int(sum(int(blocks[c][last].sum(dtype=np.int64))
                           for c in range(n_pipes)))
            device_sum_ok = int(out.item()) == want
    finally:
        for r in readers:
            r.close()
        for r, _ in pipes:
            os.close(r)
    for t in threads:
        t.join(timeout=60)
    n_bytes = got * n_pipes * block_size
    return {"pipes": n_pipes, "blocks": got, "blocks_written": n_blocks,
            "bytes": n_bytes, "bytes_written": n_pipes * n_blocks * block_size,
            "seconds": dt, "gb_per_s": n_bytes / 1e9 / dt,
            "stations_equiv": n_bytes / dt / STATION_BYTES_PER_S,
            "last_rows_equal_written": last_ok,
            "wrong_rows": wrong_rows if check_every else None,
            "device_sum_equal": device_sum_ok,
            "device": str(staging_dev) if cuda else None,
            "staging_pinned": staging_dev.type == "cuda",
            "threads": {"writers": n_pipes,
                        "reader_producers": n_pipes if have_native() else 0},
            "writer_threads_alive_after": sum(t.is_alive() for t in threads),
            "pipe_buffer_bytes": pipe_bytes, "native_reader": have_native()}


def copy_vs_step(rows: int = 1024, device="cuda", reps: int = 10) -> dict:
    """The host-to-device copy of a (rows, block) uint8 block from pinned
    memory, by CUDA events (median of ``reps``), beside the compiled full
    MODE0 step at ``rows`` channels in the same process."""
    from torch_scaling_sweep import slope_seconds

    from rtsdr_tpu_torch.pipeline.receiver import Receiver

    dev = torch.device(device)
    host = torch.randint(0, 256, (rows, MODE0.block_size),
                         dtype=torch.uint8).pin_memory()
    dst = torch.empty(host.shape, dtype=torch.uint8, device=dev)
    times = []
    for i in range(reps + 2):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        dst.copy_(host, non_blocking=True)
        b.record()
        b.synchronize()
        if i >= 2:
            times.append(a.elapsed_time(b))
    copy_ms = statistics.median(times)
    copied_equal = bool(torch.equal(dst.cpu(), host))
    rx = Receiver(MODE0, (rows,), device=dev)
    step_ms = slope_seconds(rx.step, rx.init, dst, repeats=3) * 1e3
    del rx
    n_bytes = host.numel()
    return {"copy_vs_step": {
        "rows": rows, "block_bytes": n_bytes, "h2d_copy_ms": copy_ms,
        "h2d_copy_ms_all": times, "h2d_gb_per_s": n_bytes / copy_ms / 1e6,
        "copied_equal": copied_equal, "step_ms": step_ms,
        "step": "compiled MODE0 (stereo + RDS + frame), input in its buffer",
        "serial_ms": copy_ms + step_ms,
        "pace_set_by": "copy" if copy_ms > step_ms else "step",
        "batch_runner_realtime_multiple_if_host_keeps_up":
            rows * MODE0.iq_len / MODE0.rf.fs / ((copy_ms + step_ms) / 1e3)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--pipes", type=int, nargs="+", default=PIPES)
    ap.add_argument("--blocks", type=int, default=400,
                    help="blocks per pipe per measurement")
    ap.add_argument("--block-size", type=int, default=MODE0.block_size)
    ap.add_argument("--device", action="store_true",
                    help="extend the path through Feeder.push into a "
                         "compiled function's input buffer, and time the "
                         "copy against the step")
    ap.add_argument("--copy-rows", type=int, default=1024)
    ap.add_argument("--cpu", action="store_true",
                    help="no card: plain host staging")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.cpu and args.device:
        ap.error("--cpu takes no --device")
    card = None
    if not args.cpu:
        if not torch.cuda.is_available():
            print("no CUDA device (--cpu runs without one)", file=sys.stderr)
            return 1
        from rtsdr_tpu_torch.utils.profiling import card_name_and_power_limit

        card = card_name_and_power_limit()
    target = None if args.cpu else "cuda" if args.device else "pinned"
    lines, base = [], None
    for n in args.pipes:
        r = run_one(n, args.blocks, args.block_size, device=target)
        if base is None:
            base = r["gb_per_s"] / n
        r["scaling_eff"] = (r["gb_per_s"] / n) / base
        r["card"] = card
        lines.append(r)
        print(json.dumps(r), flush=True)
    if args.device:
        r = copy_vs_step(args.copy_rows)
        r["card"] = card
        lines.append(r)
        print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for r in lines:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
