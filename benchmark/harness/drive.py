"""What the entry drivers share: the traffic, the samples a run keeps for
its check, the traced slice, and the clock."""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness import check, core
from benchmark.traffic import synth


class Traffic:
    """The ring of a cell's traffic from the seed, and each stream's raw
    block at each of its blocks."""

    def __init__(self, ctx: core.Ctx):
        t0 = time.perf_counter()
        (self.ring, self.station, self.offset, self.params,
         self.ring_dev) = synth.make_ring(ctx.traffic, ctx.config, ctx.seed,
                                          ctx.device)
        self.streams = ctx.traffic["streams"]
        ctx.note(setup_part="traffic_synthesis_s",
                 seconds=time.perf_counter() - t0,
                 stations=[{k: p[k] for k in ("pi", "cnr_db", "detune_hz")}
                           for p in self.params])

    def block(self, c: int, b: int) -> np.ndarray:
        return synth.stream_block(self.ring, self.station, self.offset, c, b)


class Samples:
    """The items a run keeps: the start items (the first ``start_blocks``
    blocks of a few streams) and window items triggered at times drawn from
    the seed.  A driver calls ``before_step(k, state, now)`` before each
    step ``k`` and ``outputs(k, get)`` when step ``k``'s outputs are on the
    host (``get(row)`` gives the outputs at a stream's row).

    A stream's row in the state and the outputs is the stream itself, None
    where the step is unbatched (``batched`` False), or ``rows[stream]``
    where the driver gives ``rows``: a tuple of indices where the state
    has more than one batch axis, such as (capture, slot)."""

    def __init__(self, ctx: core.Ctx, n_streams: int, batched: bool = True,
                 rows=None):
        self.batched = batched
        self.rows = rows
        chk = ctx.workload["check"]
        rng = synth.rng_for(ctx.seed, 7)
        starts, window = check.sample_items(
            rng, n_streams, chk["start_streams"], chk["window_items"])
        self.start_blocks = chk["start_blocks"]
        self.items = [{"kind": "start", "stream": c,
                       "blocks": list(range(self.start_blocks)),
                       "outputs": []} for c in starts]
        self.pending = [(f, c) for f, c in window]
        self.wanted: dict = {}     # step -> [(item, stream)]
        self.window_t0 = None
        self.window_s = ctx.seconds
        self._armed = None        # the item whose block s is the next step

    def start_window(self, t0: float) -> None:
        self.window_t0 = t0

    def before_step(self, k: int, state, now: float) -> None:
        """Snapshot the program's state where an item needs it."""
        if self._armed is not None:
            item = self._armed
            item["snap_at"] = check.state_rows(state, self.row(item["stream"]))
            item["blocks"] = [k]
            self.wanted.setdefault(k, []).append(item)
            self.items.append(item)
            self._armed = None
            return
        if (self.window_t0 is None or not self.pending or k < 2
                or now < self.window_t0 + self.pending[0][0] * self.window_s):
            return
        _, c = self.pending.pop(0)
        self._armed = {"kind": "window", "stream": c, "outputs": []}
        self._armed["snap_prev"] = check.state_rows(state, self.row(c))

    def row(self, c: int):
        """Stream ``c``'s row (class docstring)."""
        if not self.batched:
            return None
        return c if self.rows is None else self.rows[c]

    def outputs(self, k: int, get) -> None:
        for item in self.items:
            if item["kind"] == "start" and k < self.start_blocks:
                item["outputs"].append(get(self.row(item["stream"])))
        for item in self.wanted.pop(k, []):
            item["outputs"].append(get(self.row(item["stream"])))

    def finished(self) -> list:
        """The items with their snapshots on the host; an item whose
        outputs never came stays, with none (it compares as wrong)."""
        for item in self.items:
            for key in ("snap_prev", "snap_at"):
                if key in item:
                    item[key] = check.to_host(item[key])
        return self.items


def host_outputs(arrays: tuple, c) -> dict:
    """The outputs at row ``c`` (``Samples.row``: an index, a tuple of
    them, or None for an unbatched step) of what
    ``io/stream.py::fetch_list`` fetched."""
    from rtsdr_tpu_torch.io.stream import fetched_frame

    def row(a):
        a = np.asarray(a)
        return (a[c] if c is not None else a).copy()
    return {"left": row(arrays[0]), "right": row(arrays[1]),
            "frame": check.frame_dict(fetched_frame(arrays), c)}


class Slice:
    """The traced slice of a ``--trace 1`` run: ``steps`` steps starting
    ``after_s`` into the window.  The profiler session opens here, in
    set-up."""

    def __init__(self, ctx: core.Ctx, device):
        self.after_s = ctx.workload["trace"]["after_s"]
        self.steps = ctx.workload["trace"]["steps"]
        self.tracer = None
        self.first = None
        self.done = False
        if ctx.trace:
            from benchmark.harness.trace import Tracer
            self.tracer = Tracer(device)
            self.tracer.prepare()

    def tick(self, k: int, now: float, window_t0: float | None) -> None:
        """Called before step ``k``: begins and ends the slice."""
        if self.tracer is None or self.done or window_t0 is None:
            return
        if self.first is None:
            if now >= window_t0 + self.after_s:
                self.first = k
                self.tracer.begin()
        elif k == self.first + self.steps:
            self.tracer.end()
            self.done = True

    def summary(self) -> dict | None:
        """The slice reduced (None without one, or when the window ended
        inside it); closes the session."""
        if self.tracer is None:
            return None
        self.tracer.close()
        if not self.done or self.tracer.events is None:
            return None
        from benchmark.harness.trace import summarize
        return summarize(self.tracer.events, self.steps,
                         self.tracer.window_s)


def memory_peak(device) -> int:
    import torch

    if device.type != "cuda":
        return 0
    torch.cuda.synchronize()
    return int(torch.cuda.max_memory_allocated())
