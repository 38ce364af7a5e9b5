"""Profiler tracing (counterpart of ``rtsdr_tpu/utils/trace.py``):
``torch.profiler`` traces around a block of work, written as Chrome trace
files (chrome://tracing, Perfetto, TensorBoard's profiler plugin)."""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Record host (CPU) activity, and the GPU's kernels and copies when a
    CUDA device is present, around a block of work; on exit write
    ``<log_dir>/trace_<pid>_<ns>.json`` (Chrome trace format).  Yields
    ``log_dir`` (default: ``rtsdr_trace`` under the temporary directory).

        with trace("t"):
            state, out = rx.step(state, raw)
            torch.cuda.synchronize()

    A profiler that cannot start raises; nothing is skipped.
    """
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "rtsdr_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(log_dir,
                            f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)


def annotate(name: str):
    """Named region inside a trace (host-side annotation)."""
    return torch.profiler.record_function(name)
