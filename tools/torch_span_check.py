#!/usr/bin/env python3
"""The program's spans (``utils/trace.py::annotate``) on the card: what a
span costs, whether the spans sit on the trace's clock, and where the live
loop's device idle time goes.

    python3 tools/torch_span_check.py [cost] [live] [host] [file]
        [--lead 8] [--blocks 24] [--steps 48] [--warm-steps 300]
        [--out FILE] [--keep DIR]

The parts named run in that order (``cost``, ``live`` and ``host`` when
none is named).

``cost``: microseconds a span, ``annotate`` with no profiler session (the
shared no-op), inside a ``utils/trace.py::profile`` session (the region
and its record), and a bare ``torch.profiler.record_function`` with no
session, for comparison.

The receivers are the benchmark cells' (MODE0 with ``resync``).

``live``: one ``StreamRunner`` at MODE0, reading a
pipe that a writer thread fills at the air rate (one block every 64 ms,
in one write when due).  Its step is captured by a short run first; then
``--lead`` blocks, then ``--blocks`` more, all under
``utils/trace.py::trace``.  From the Chrome trace and the spans' records,
over the wall from the first traced block's ``rtsdr.read`` to the last
``rtsdr.emit``:

* ``clock_ms``: each record's start against its Chrome trace event's
  (``ts`` + ``baseTimeNanoseconds``), the largest difference;
* ``h2d_after_push_us``: each block's host-to-device copy on the card
  after the start of the ``rtsdr.push`` that issued it (>= 0 on one
  clock; a negative reading bounds how far the device's events sit
  early);
* ``idle_ms`` and ``idle_under_read``: the device's idle time (the
  complement of the union of every stream's kernels, copies and memsets)
  and the share of it that a ``rtsdr.read`` event covers;
* ``hold_ms`` (``emit`` start after ``fetch_start`` end, a block),
  ``read_ms``, ``block_ms`` (a block's spans, the fetch's wait inside
  ``emit``) and ``span_ms`` (each span), medians;
* ``latency_ms``: a block's emit after its write returned, median and
  largest over the traced blocks; ``early_share``: the traced blocks'
  drains made before the next block's read (``rtsdr.emit``'s ``early``;
  None for a runner whose drains carry no such mark).

``file``: the same runner over a regular file of ``FILE_BLOCKS``
blocks written ``FILE_REPEAT`` times over, with no profiler session:
blocks a second, the rate of a stream whose input is always ahead of the
loop, in ``FILE_REPS`` runs as the runner goes (``held``: every block held
for the next) and as many with every block drained at once (``drain``:
``BlockReader.ready`` pinned to 0, the runner's other route), in turns;
and ``early_share`` in one more run inside a session of the host (0 when
every block was held).

``host``: the resident loop (``benchmark/drivers/resident.py``'s) at C = 1
and C = 1,024, ``--steps`` steps each: the host's time in the compiled
step's call and in ``Fetcher.start`` with no session, inside a profiler
session of the host alone, inside one of the host and the card, and
inside one scheduled as the ``--trace 1`` slice's (``--warm-steps``
steps warming up before the recorded ones), beside the spans' own
durations: what recording adds to the host time that
``host_ms_per_step.resident`` reads.

Prints one JSON line a part; ``--out`` also writes them to a file.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtsdr_tpu_torch.config import MODE0  # noqa: E402
from rtsdr_tpu_torch.io.stream import StreamRunner  # noqa: E402
from rtsdr_tpu_torch.utils import trace as tr  # noqa: E402
from rtsdr_tpu_torch.utils.signals import fm_multiplex_iq  # noqa: E402

AIR_S = 0.064
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union(spans) -> list:
    """The union of ``(t0, t1)`` intervals, sorted and merged."""
    merged: list = []
    for t0, t1 in sorted(spans):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return [(a, b) for a, b in merged]


def gaps(busy, t0, t1) -> list:
    """The intervals of ``[t0, t1]`` outside the merged ``busy``."""
    out, at = [], t0
    for a, b in busy:
        if b <= t0 or a >= t1:
            continue
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < t1:
        out.append((at, t1))
    return out


def covered(intervals, cover) -> float:
    """The length of ``intervals`` (disjoint) that ``cover`` overlaps."""
    cover = union(cover)
    return sum(max(0.0, min(b, d) - max(a, c))
               for a, b in intervals for c, d in cover)


def per_span_us(fn, n: int) -> float:
    t0 = time.perf_counter()
    fn(n)
    return (time.perf_counter() - t0) / n * 1e6


def spans_off(n: int) -> None:
    for _ in range(n):
        with tr.annotate("rtsdr.probe", bytes=1):
            pass


def bare_region(n: int) -> None:
    for _ in range(n):
        with torch.profiler.record_function("rtsdr.probe"):
            pass


def cost(n_off: int, n_on: int) -> dict:
    spans_off(1000)
    off = min(per_span_us(spans_off, n_off) for _ in range(3))
    bare = min(per_span_us(bare_region, n_on) for _ in range(3))
    with tr.profile():
        spans_off(100)
        on = min(per_span_us(spans_off, n_on) for _ in range(3))
    tr.clear()
    return {"part": "cost", "off_us": off, "on_us": on,
            "record_function_no_session_us": bare}


def live(n_lead: int, n_blocks: int, keep: str | None = None) -> dict:
    bs = MODE0.block_size
    data = fm_multiplex_iq((n_lead + n_blocks) * MODE0.iq_len)
    blocks = data.reshape(-1, bs)
    runner = StreamRunner(MODE0, resync=True)

    written, emitted = [], []

    def writer(fd, blocks, period):
        with os.fdopen(fd, "wb", buffering=0) as f:
            t0 = time.monotonic()
            for b, blk in enumerate(blocks):
                wait = t0 + (b + 1) * period - time.monotonic()
                if wait > 0:
                    time.sleep(wait)
                f.write(blk.tobytes())
                written.append(time.monotonic())

    def run(blocks, period):
        written.clear()
        emitted.clear()
        r_fd, w_fd = os.pipe()
        th = threading.Thread(target=writer, args=(w_fd, blocks, period))
        th.start()
        try:
            return runner.run(
                r_fd, emit=lambda pcm: emitted.append(time.monotonic()))
        finally:
            th.join()
            os.close(r_fd)

    run(blocks[:2], 0.0)                   # capture and warm-up
    torch.cuda.synchronize()
    tr.clear()
    with tempfile.TemporaryDirectory() as tmp:
        with tr.trace(tmp):
            stats = run(blocks, AIR_S)
        (name,) = [f for f in os.listdir(tmp) if f.endswith(".json")]
        with open(os.path.join(tmp, name)) as f:
            doc = json.load(f)
    recs = tr.recorded()
    if keep:
        os.makedirs(keep, exist_ok=True)
        with open(os.path.join(keep, "live_trace.json"), "w") as f:
            json.dump(doc, f)
        with open(os.path.join(keep, "live_records.json"), "w") as f:
            json.dump(recs, f)
    base = doc["baseTimeNanoseconds"]
    events = doc["traceEvents"]

    def ns(e):        # an event's (start, end) on the records' clock
        t0 = float(e["ts"]) * 1e3 + base
        return t0, t0 + float(e.get("dur", 0.0)) * 1e3

    device = [ns(e) for e in events if e.get("cat") in DEVICE_CATS]
    named = {}
    for e in events:
        # the host's region; the profiler also projects each region onto
        # the device's timeline (``gpu_user_annotation``)
        if (e.get("cat") == "user_annotation"
                and e.get("name", "").startswith("rtsdr.")):
            named.setdefault(e["name"], []).append(ns(e))
    clock = 0.0
    for nm, evs in named.items():
        starts = sorted(r["t0_ns"] for r in recs if r["name"] == nm)
        evs.sort()
        if len(starts) != len(evs):
            raise RuntimeError(f"{nm}: {len(starts)} records, "
                               f"{len(evs)} trace events")
        clock = max([clock] + [abs(e[0] - s) for e, s in zip(evs, starts)])

    by_block: dict = {}
    for r in recs:
        by_block.setdefault(r["block"], {})[r["name"]] = r
    traced = [b for b in sorted(k for k in by_block if k is not None)
              if b >= n_lead and "rtsdr.emit" in by_block[b]
              and "rtsdr.push" in by_block[b]]
    w0 = by_block[traced[0]]["rtsdr.read"]["t0_ns"]
    w1 = by_block[traced[-1]]["rtsdr.emit"]["t1_ns"]
    busy = union(device)
    idle = gaps(busy, w0, w1)
    reads = [e for e in named["rtsdr.read"] if e[1] > w0 and e[0] < w1]
    h2d = np.sort(np.asarray([ns(e)[0] for e in events
                              if e.get("cat") == "gpu_memcpy"
                              and "HtoD" in e.get("name", "")]))
    lags = []
    for b in traced:
        # the block's copy to the card, issued inside its push: the
        # nearest host-to-device copy to the span's start
        t = by_block[b]["rtsdr.push"]["t0_ns"]
        i = int(np.argmin(np.abs(h2d - t))) if len(h2d) else None
        if i is not None and abs(h2d[i] - t) < 5e6:
            lags.append((h2d[i] - t) / 1e3)
    span = lambda r: (r["t1_ns"] - r["t0_ns"]) / 1e6  # noqa: E731
    idle_ns = sum(b - a for a, b in idle)
    latency = [(emitted[b] - written[b]) * 1e3
               for b in range(n_lead, min(len(emitted), len(written)))]
    early = [by_block[b]["rtsdr.emit"]["attrs"]["early"] for b in traced
             if "early" in by_block[b]["rtsdr.emit"]["attrs"]]
    return {
        "part": "live", "blocks": stats["blocks"], "traced_blocks":
        len(traced), "wall_ms": (w1 - w0) / 1e6,
        "records": len(recs), "dropped": tr.dropped(),
        "captures": sum(r["name"] == "rtsdr.capture" for r in recs),
        "clock_ms": clock / 1e6,
        "h2d_after_push_us": {"min": min(lags),
                                   "median": statistics.median(lags),
                                   "max": max(lags)} if lags else None,
        "idle_ms": idle_ns / 1e6,
        "idle_share": idle_ns / (w1 - w0),
        "idle_under_read": covered(idle, reads) / idle_ns,
        "hold_ms": statistics.median(
            (by_block[b]["rtsdr.emit"]["t0_ns"]
             - by_block[b]["rtsdr.fetch_start"]["t1_ns"]) / 1e6
            for b in traced),
        "read_ms": statistics.median(span(by_block[b]["rtsdr.read"])
                                     for b in traced),
        "block_ms": statistics.median(
            sum(span(r) for r in by_block[b].values() if r["parent"] is None)
            for b in traced),
        "latency_ms": {"median": statistics.median(latency),
                       "max": max(latency)},
        "early_share": (sum(early) / len(early)
                        if len(early) == len(traced) else None),
        "spans_per_block": max(len(by_block[b]) for b in traced),
        "span_ms": {nm: statistics.median(span(by_block[b][nm])
                                          for b in traced)
                    for nm in by_block[traced[0]]}}


def host(channels: int, steps: int, warm_steps: int) -> dict:
    """The resident loop of ``benchmark/drivers/resident.py`` at
    ``channels``: the host's ms in ``step.borrowed`` and in
    ``Fetcher.start`` a step (medians), with no session, inside a session
    of the host alone, and inside one of the host and the card; with a
    session, the ``rtsdr.replay`` and ``rtsdr.fetch_start`` spans too."""
    from rtsdr_tpu_torch.io.staging import Fetcher
    from rtsdr_tpu_torch.io.stream import fetch_list
    from rtsdr_tpu_torch.pipeline.receiver import Receiver

    dev = torch.device("cuda")
    rx = Receiver(MODE0, (channels,), resync=True)
    raw = rx.step.input_buffer((channels, MODE0.block_size))
    gen = torch.Generator(device=dev).manual_seed(16)
    slabs = torch.randint(0, 256, (4, channels, MODE0.block_size),
                          generator=gen, device=dev, dtype=torch.uint8)
    fetcher = Fetcher(dev)
    state = rx.init()

    def loop(n):
        nonlocal state
        pending, t_step, t_fetch = None, [], []
        for k in range(n):
            raw.copy_(slabs[k % 4], non_blocking=True)
            t0 = time.perf_counter()
            state, out = rx.step.borrowed(state, raw)
            t1 = time.perf_counter()
            ticket = fetcher.start(fetch_list(out))
            t_step.append(t1 - t0)
            t_fetch.append(time.perf_counter() - t1)
            if pending is not None:
                fetcher.wait(pending)
            pending = ticket
        fetcher.wait(pending)
        return {"borrowed_ms": statistics.median(t_step) * 1e3,
                "fetch_start_ms": statistics.median(t_fetch) * 1e3}

    loop(8)                                  # capture and warm-up
    out = {"part": "host", "channels": channels, "steps": steps,
           "off": loop(steps)}
    cpu = [torch.profiler.ProfilerActivity.CPU]
    scheduled = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    for label, kwargs in (
            ("host_session", {"activities": cpu}),
            ("host_and_card_session", {}),
            # the ``--trace 1`` slice's session: opened (warming up) long
            # before the steps it records
            ("scheduled_session", {"schedule": scheduled})):
        tr.clear()
        prof = (torch.profiler.profile(**kwargs) if "activities" in kwargs
                else tr.profile(**kwargs))
        with prof:
            if "schedule" in kwargs:
                loop(warm_steps)
                prof.step()
            res = loop(steps)
            if "schedule" in kwargs:
                prof.step()
        for nm in ("rtsdr.replay", "rtsdr.fetch_start"):
            ms = [(r["t1_ns"] - r["t0_ns"]) / 1e6 for r in tr.recorded()
                  if r["name"] == nm]
            res[nm + "_ms"] = statistics.median(ms) if ms else None
            res[nm + "_mean_ms"] = statistics.fmean(ms) if ms else None
        out[label] = res
    tr.clear()
    out["off_again"] = loop(steps)
    del rx, slabs, state
    torch.cuda.empty_cache()
    return out


FILE_BLOCKS, FILE_REPEAT, FILE_REPS = 240, 8, 5


def file_rate() -> dict:
    """``live``'s runner over a regular file: blocks a second a run, held
    and drained at once in turns, and the share of early drains in one
    more run inside a profiler session of the host."""
    from rtsdr_tpu_torch.runtime import BlockReader

    data = fm_multiplex_iq(FILE_BLOCKS * MODE0.iq_len)
    runner = StreamRunner(MODE0, resync=True)
    total = FILE_BLOCKS * FILE_REPEAT
    rates = {"held": [], "drain": []}

    def once(path, route, session=contextlib.nullcontext()):
        with open(path, "rb") as f, session, (
                mock.patch.object(BlockReader, "ready", lambda self: 0,
                                  create=True)
                if route == "drain" else contextlib.nullcontext()):
            t0 = time.perf_counter()
            stats = runner.run(f.fileno(), emit=lambda pcm: None)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        if stats["blocks"] != total:
            raise RuntimeError(f"{stats['blocks']} of {total} blocks")
        return total / dt

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "station.iq")
        with open(path, "wb") as f:
            for _ in range(FILE_REPEAT):
                data.tofile(f)
        once(path, "held")                    # captures the step
        for rep in range(FILE_REPS):
            for route in (("held", "drain") if rep % 2 == 0
                          else ("drain", "held")):
                rates[route].append(once(path, route))
        tr.clear()
        once(path, "held", torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]))
    early = [r["attrs"]["early"] for r in tr.recorded()
             if r["name"] == "rtsdr.emit" and "early" in r["attrs"]]
    tr.clear()
    del runner
    torch.cuda.empty_cache()
    return {"part": "file", "blocks": total, "reps": FILE_REPS,
            "blocks_per_s": rates,
            "blocks_per_s_median": {k: statistics.median(v)
                                    for k, v in rates.items()},
            "early_share": sum(early) / len(early) if early else None}


PARTS = ("cost", "live", "host", "file")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("parts", nargs="*", metavar="PART",
                    help=f"of {', '.join(PARTS)}: the parts to run "
                    "(default: cost, live, host)")
    ap.add_argument("--lead", type=int, default=8)
    ap.add_argument("--blocks", type=int, default=24)
    ap.add_argument("--n-off", type=int, default=200_000)
    ap.add_argument("--n-on", type=int, default=20_000)
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--warm-steps", type=int, default=300)
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="also write the JSON lines to FILE")
    ap.add_argument("--keep", default=None, metavar="DIR",
                    help="write the live loop's Chrome trace and records "
                    "into DIR")
    args = ap.parse_args()
    if set(args.parts) - set(PARTS):
        ap.error(f"unknown part: {sorted(set(args.parts) - set(PARTS))}")
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    head = {"part": "card", "card": card, "torch": torch.__version__,
            "cuda": torch.version.cuda}
    chosen = args.parts or ("cost", "live", "host")
    parts = [lambda: head]
    for name in chosen:
        if name == "cost":
            parts.append(lambda: cost(args.n_off, args.n_on))
        elif name == "live":
            parts.append(lambda: live(args.lead, args.blocks, args.keep))
        elif name == "host":
            parts += [lambda c=c: host(c, args.steps, args.warm_steps)
                      for c in (1, 1024)]
        else:
            parts.append(file_rate)
    for part in parts:
        line = part()
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
