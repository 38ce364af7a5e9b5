"""The traffic's writer process: it writes a cell's stream into a pipe,
apart from the process under test (no shared interpreter lock).

    python3 benchmark/traffic/feeder.py

reads one JSON header line and then the ring's bytes (``shape``, u8) from
standard input, writes, and prints one JSON line of what it did.  Header:

``mode`` "air": one stream, ``fds[0]``.  Once the ring is read it prints
"ready" and reads ``t0`` (a line) from standard input; block b is written
in one write when its last byte is due, at ``t0 + (b + 1) * period`` on
``CLOCK_MONOTONIC`` (the last 2 ms spun), for b < ``n_blocks``; it prints
each block's lateness (write start minus due time, seconds).

The stream writes ring block ``(b + offset[0]) % ring_blocks`` of station
``station[0]`` at its block b.  A pipe closed by the reader ends the
writer; the pipe is closed before the process ends.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

SPIN_S = 0.002


def _write_all(fd: int, buf: memoryview) -> None:
    while buf:
        n = os.write(fd, buf)
        buf = buf[n:]


def air(fd: int, ring: np.ndarray, station: int, offset: int, t0: float,
        period: float, n_blocks: int) -> dict:
    n_ring = ring.shape[1]
    late = []
    try:
        for b in range(n_blocks):
            due = t0 + (b + 1) * period
            # sleep to within SPIN_S of the due time, then spin: a sleep
            # alone wakes 0.6 ms late, and late by up to tens of ms at times
            wait = due - SPIN_S - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            while time.monotonic() < due:
                pass
            late.append(time.monotonic() - due)
            _write_all(fd, memoryview(ring[station, (b + offset) % n_ring]))
    except BrokenPipeError:
        pass
    finally:
        os.close(fd)
    return {"late_s": late}


def main() -> int:
    head = json.loads(sys.stdin.buffer.readline())
    shape = tuple(head["shape"])
    n = int(np.prod(shape))
    data = bytearray(n)
    view = memoryview(data)
    got = 0
    while got < n:
        k = sys.stdin.buffer.readinto(view[got:])
        if not k:
            raise SystemExit("feeder: the ring ended early")
        got += k
    ring = np.frombuffer(data, np.uint8).reshape(shape)
    if head["mode"] != "air":
        raise SystemExit(f"feeder: no mode {head['mode']!r}")
    print("ready", flush=True)
    t0 = float(sys.stdin.buffer.readline())
    out = air(head["fds"][0], ring, head["station"][0], head["offset"][0],
              t0, head["period"], head["n_blocks"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
