"""Profiler tracing (counterpart of ``rtsdr_tpu/utils/trace.py``):
``torch.profiler`` traces around a block of work, written as Chrome trace
files (chrome://tracing, Perfetto, TensorBoard's profiler plugin), the
profiler session every timing tool of the port opens (``profile``), and
the program's spans (``annotate``).

The spans mark the host loop's layer boundaries (attributes in brackets):

* ``rtsdr.read``: ``StreamRunner.run``'s read of a block,
  ``BatchRunner.read_batch``'s reader loop, the CLI's wideband loop's read
  of a capture block (``bytes``; ``ready``, the whole blocks waiting in
  the reader when it began, the least over a batch's readers, -1 at the
  end of the stream);
* ``rtsdr.push``: ``io/staging.py::Feeder.push`` (``bytes``);
* ``rtsdr.replay``: one replay of a compiled step, ``utils/jit.py``
  (``launches``);
* ``rtsdr.capture``: a compiled step's warm-up and capture, at its first
  call;
* ``rtsdr.fetch_start``: ``Fetcher.start``, the outputs' copies queued
  (``copies``, ``bytes``);
* ``rtsdr.fetch_wait``: ``Fetcher.wait``;
* ``rtsdr.emit``: a runner's or the CLI's wideband loop's drain of one
  block's outputs (the fetch's wait, ``emit``, ``rds_log``,
  ``frame_hook`` / ``rds_hook``, the wideband loop's wavs and RDS lines;
  ``early``: 1 when drained before the next block's read, 0 when held
  until after it);
* ``rtsdr.channelize``: one call of the wideband channelizer,
  ``ops/channelizer.py`` (``route``, ``captures``, ``slots``, ``shared``,
  ``own``, ``taps``), eager or at a capture: never inside a replay.

A span records only while a profiler session records (``profile``,
``trace``, or any ``torch.profiler`` session in its active steps); with
none it is one shared object that does nothing.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time

import torch
from torch.autograd import _profiler_enabled


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


#: records kept at most; later ones are dropped and counted (``dropped``)
CAP = 65_536

_records: list = []
_dropped = 0
_thread = threading.local()   # .open: this thread's open spans; .block


class _Off:
    """The span while no profiler session records: enters and leaves doing
    nothing, and is false."""

    __slots__ = ()
    block = None

    def __bool__(self) -> bool:
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def add(self, **attrs) -> None:
        return None


OFF = _Off()


class Span:
    """A span that records: a ``torch.profiler.record_function`` region in
    the session's trace, and one record in ``recorded()`` when it ends."""

    __slots__ = ("name", "block", "attrs", "parent", "t0_ns", "_region")

    def __init__(self, name: str, block, attrs: dict):
        self.name, self.block, self.attrs = name, block, attrs

    def add(self, **attrs) -> None:
        """Counts known only inside the span (``if span: span.add(...)``
        where computing them costs)."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = getattr(_thread, "open", None)
        if stack is None:
            stack = _thread.open = []
        outer = stack[-1] if stack else None
        self.parent = outer.name if outer is not None else None
        if self.block is None:
            self.block = (outer.block if outer is not None
                          else getattr(_thread, "block", None))
        else:
            _thread.block = self.block
        stack.append(self)
        # the record's interval holds the region's event: the first event
        # of a session takes the profiler a millisecond to set up
        self.t0_ns = time.time_ns()
        self._region = torch.profiler.record_function(self.name)
        self._region.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        global _dropped
        self._region.__exit__(*exc)
        t1_ns = time.time_ns()
        _thread.open.pop()
        if len(_records) < CAP:
            _records.append({"name": self.name, "t0_ns": self.t0_ns,
                             "t1_ns": t1_ns, "parent": self.parent,
                             "block": self.block, "attrs": self.attrs})
        else:
            _dropped += 1


def annotate(name: str, block: int | None = None, **attrs):
    """The program's span: a named region of the host's work.

    With no profiler session recording it returns ``OFF``, one shared
    object that does nothing (no region, no record, no clock read).  While
    one records it enters ``record_function(name)``, so the region is a
    host event in the session's Chrome trace beside the kernels and
    copies, and appends one record to ``recorded()``: ``name``, ``t0_ns``
    and ``t1_ns`` (``time.time_ns()``, the trace's own clock: an event's
    ``ts`` plus the file's ``baseTimeNanoseconds``), ``parent`` (the
    innermost span open around it on its thread), ``block`` and ``attrs``
    (the counts at that boundary).

    ``block``: the index of the block the span serves.  A span given one
    sets it for the spans that follow on its thread; a span without one
    takes its parent's, else the last one given.
    """
    if not _profiler_enabled():
        return OFF
    return Span(name, block, attrs)


def recorded() -> list:
    """The records of the spans that ended while a session recorded, in
    the order they ended."""
    return list(_records)


def dropped() -> int:
    """Records dropped beyond ``CAP`` since the last ``clear``."""
    return _dropped


def clear() -> None:
    """Forget the records, the dropped count and this thread's block."""
    global _dropped
    _records.clear()
    _dropped = 0
    _thread.block = None
