"""Profiler tracing (counterpart of ``rtsdr_tpu/utils/trace.py``):
``torch.profiler`` traces around a block of work, written as Chrome trace
files (chrome://tracing, Perfetto, TensorBoard's profiler plugin), and the
profiler session every timing tool of the port opens (``profile``)."""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


def profile(**kwargs) -> torch.profiler.profile:
    """``torch.profiler.profile`` over the host and, when a CUDA device is
    present, the GPU's kernels and copies; ``kwargs`` go to it.

    The profiler is told to tear CUPTI down at the end of the session
    (``TEARDOWN_CUPTI=1``, unless the environment already says otherwise),
    so that the next session initialises it afresh.  Left initialised from
    one session to the next, CUPTI's device timestamps drift against the
    profiler's capture window with the time since CUPTI started (about
    10 us per second on an H100 with torch 2.11 and CUDA 12.8), and the
    profiler drops every device event that seems to start before its
    window: a compiled step traced a few minutes into a process loses its
    first kernels (``tools/torch_trace_check.py --interval 8`` with
    ``TEARDOWN_CUPTI=0`` shows it).  Every profiler session of this
    package, its tools and ``chip_smoke.py`` opens through here."""
    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities, **kwargs)


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
    prof = profile()
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
