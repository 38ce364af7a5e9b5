"""Per-shard stepping shared by the sharded receivers.

A sharded receiver keeps one state per shard, each on its shard's device:
``step_shards`` steps each shard on its own input and gathers the outputs
on one device, in shard order (``parallel/channels.py``,
``parallel/timeshard.py`` and ``pipeline/wideband.py`` with
``channel_sharding``).  Each shard steps with its input's GPU made
current: the kernels launch on the current device's stream and read its
SM count.

The spread route of the time-sharded receiver goes one level down: each
time shard of a channel shard steps at its own ``Place``, a device and, on
a GPU, a stream of its own made once for the receiver's lifetime
(``time_shard_places``), inside ``on_place``.  ``move`` hands a value made
at one place to another: the reader's stream waits on an event of the
maker's, and the value is copied to the reader's device or, on the same
device, read in place with its memory held for the reader's stream.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch


def concat_rows(trees, device, dim: int = 0):
    """Per-shard output trees (NamedTuples / tuples of tensors / None) ->
    one tree, leaves concatenated along ``dim`` on ``device``; a single
    shard's tree is returned as it is."""
    if len(trees) == 1:
        return trees[0]
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.cat([t.to(device) for t in trees], dim=dim)
    parts = [concat_rows([t[i] for t in trees], device, dim)
             for i in range(len(first))]
    return type(first)(*parts) if hasattr(first, "_fields") else tuple(parts)


def _device_of(x):
    """The guard that makes a CUDA input's device current (nothing for a
    CPU input)."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        return torch.cuda.device(x.device)
    return contextlib.nullcontext()


def step_shards(steps, states, inputs, device, dim: int = 0):
    """``steps[i](states[i], inputs[i])`` for every shard, in order;
    ``inputs`` may be a generator that moves each shard's part to its
    device as it is taken; a shard whose part lies on a GPU steps with that
    GPU current.  Returns the tuple of new states and the outputs
    gathered along ``dim`` on ``device``."""
    new, outs = [], []
    for step, st, x in zip(steps, states, inputs):
        with _device_of(x):
            st, out = step(st, x)
        new.append(st)
        outs.append(out)
    return tuple(new), concat_rows(outs, device, dim)


class Place(NamedTuple):
    """Where a time shard steps: its device and, on a GPU, its stream."""

    device: torch.device
    stream: object = None      # torch.cuda.Stream on a CUDA device


def time_shard_places(devices) -> tuple:
    """One ``Place`` per device of a mesh row, each GPU cell with a new
    stream of its own (a device that repeats gets one stream per cell)."""
    return tuple(Place(d, torch.cuda.Stream(device=d) if d.type == "cuda"
                       else None) for d in map(torch.device, devices))


def caller_place(device) -> Place:
    """The caller's current stream on ``device``: where a row's state and
    outputs are made and read."""
    device = torch.device(device)
    if device.type != "cuda":
        return Place(device)
    return Place(device, torch.cuda.current_stream(device))


@contextlib.contextmanager
def on_place(place: Place):
    """A context in which ``place``'s device and stream are current, so
    every kernel and stock op launches on its stream (nothing on the
    CPU)."""
    if place.stream is None:
        yield
        return
    with torch.cuda.device(place.device), torch.cuda.stream(place.stream):
        yield


def record(place: Place):
    """An event after the work queued on ``place``'s stream so far."""
    event = torch.cuda.Event()
    event.record(place.stream)
    return event


def move(x: torch.Tensor, src: Place, dst: Place) -> torch.Tensor:
    """``x``, made on ``src``'s stream, for reading on ``dst``'s.

    ``dst``'s stream waits on an event recorded on ``src``'s.  On the same
    device ``x`` itself is returned, held for ``dst``'s stream
    (``record_stream``: its memory goes to no new tensor before ``dst``'s
    reads are done); on another GPU it is copied there on ``src``'s
    stream, into memory of ``dst``'s, which waits for the copy.
    """
    if src.stream is None:
        return x.to(dst.device)
    dst.stream.wait_event(record(src))
    if src.device == dst.device:
        x.record_stream(dst.stream)
        return x
    with on_place(dst), on_place(src):
        # PyTorch copies between GPUs on the source device's current
        # stream behind the destination's, and allocates on the latter's
        return x.to(dst.device, non_blocking=True)
