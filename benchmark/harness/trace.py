"""A traced slice of the measured window, reduced to what the per-layer
metrics read.

The profiler is ``torch.profiler`` over the host and the card, opened the
way the port's ``utils/trace.py::profile`` opens it (a copy, so that a
change to the program's tracing cannot change the benchmark's): CUPTI is
torn down after each session (``TEARDOWN_CUPTI=1``), since left up its
device timestamps drift against the profiler's window and the first
kernels of a session go missing.

From the Chrome trace: device events (kernels, copies by direction,
memsets) with their streams; the union of their intervals over all
streams (the device's busy time); the gaps between them, each named by the
harness's own host span (``bench.*``) that covers its middle; and the
device operations that took most time.  The stream-union arithmetic is
``tools/torch_profile_step.py``'s.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import torch

SPAN_PREFIX = "bench."


def span(name: str):
    """A host span of the harness's own, visible in a trace."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


class Tracer:
    """One profiler session over a slice of the window.  ``prepare()`` in
    set-up opens it, idle (its warm-up state: CUPTI's start, which takes
    seconds, is paid before the window); ``begin()`` and ``end()`` around
    the slice record it (a schedule of one warm-up and one active step),
    and ``end()`` reduces it; ``close()`` shuts the session."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.prof = None
        self.events = None
        self.window_s = 0.0

    def prepare(self) -> None:
        os.environ.setdefault("TEARDOWN_CUPTI", "1")
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(
            activities=acts, on_trace_ready=self._ready,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                             repeat=1))
        self.prof.start()

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def begin(self) -> None:
        self._sync()
        self._t0 = time.perf_counter()
        self.prof.step()

    def end(self) -> None:
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self.prof.step()

    def _ready(self, prof) -> None:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)

    def close(self) -> None:
        if self.prof is not None:
            self.prof.stop()
            self.prof = None


def _kind(e: dict) -> str | None:
    cat = e.get("cat")
    if cat == "kernel":
        return "kernel"
    if cat == "gpu_memset":
        return "memset"
    if cat == "gpu_memcpy":
        name = e.get("name", "")
        for k in ("HtoD", "DtoH", "DtoD"):
            if k in name:
                return k
        return "memcpy"
    return None


def _union(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list = []
    for t0, t1 in sorted(spans):
        if merged and t0 <= merged[-1][1]:
            if t1 > merged[-1][1]:
                merged[-1][1] = t1
        else:
            merged.append([t0, t1])
    return [(a, b) for a, b in merged]


def summarize(events: list[dict], steps: int, window_s: float) -> dict:
    """Seconds by kind of device event, the busy union, the top device
    operations and the idle gaps by host span, per traced window."""
    dev, host = [], []
    by_kind: dict = {}
    by_name: dict = {}
    for e in events:
        kind = _kind(e)
        if kind is not None:
            t0 = float(e["ts"])
            t1 = t0 + float(e.get("dur", 0.0))
            dev.append((t0, t1))
            by_kind[kind] = by_kind.get(kind, 0.0) + (t1 - t0) / 1e6
            name = e.get("name", "?")[:96]
            by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e6
        elif (e.get("cat") == "user_annotation"
              and e.get("name", "").startswith(SPAN_PREFIX)):
            t0 = float(e["ts"])
            host.append((t0, t0 + float(e.get("dur", 0.0)), e["name"]))
    union = _union(dev)
    busy = sum(b - a for a, b in union) / 1e6
    gaps: dict = {}
    host.sort()
    for (a0, a1), (b0, _) in zip(union, union[1:]):
        mid = 0.5 * (a1 + b0)
        # the innermost (latest starting) harness span over the gap
        covering = [n for h0, h1, n in host if h0 <= mid <= h1]
        name = covering[-1][len(SPAN_PREFIX):] if covering else "other"
        gaps[name] = gaps.get(name, 0.0) + (b0 - a1) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"steps": steps, "window_s": window_s, "busy_s": busy,
            "seconds_by_kind": by_kind, "device_ops": [list(t) for t in top],
            "idle_gaps": [list(t) for t in idle], "device_events": len(dev)}
