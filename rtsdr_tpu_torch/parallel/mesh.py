"""The (channel, time) mesh of the parallel receivers.

Counterpart of ``rtsdr_tpu/parallel/mesh.py``.  PyTorch has no mesh and no
global array, so the port's mesh is what the receivers need to know: the
torch device of each (channel shard, time shard) cell and each channel
shard's first device, which holds its state and its outputs.  The channel
axis maps onto devices (each shard's stations run on its own device, with
no communication).  The T time shards of one channel shard run one of two
ways (``parallel/timeshard.py``):

  * stacked: the T chunks lie along a leading dimension on the channel
    shard's one device, where every JAX collective of the time axis becomes
    a tensor operation on that dimension;
  * spread: each chunk steps on its own device with its own CUDA stream, as
    each time shard of the JAX mesh runs on its own chip, and halos, the
    PLL handoff and the gathers are copies between them, each after an
    event of the stream that made the value.

``make_mesh`` takes the stacked route when it is given exactly one device
per channel shard, and the spread route for a grid of ``n_ch x n_t``
devices.  A device may repeat within a row (several time shards on one
card, each on its own stream; the CPU).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rtsdr_tpu_torch.device import resolve_device

CHANNEL_AXIS = "ch"
TIME_AXIS = "t"


class Mesh(NamedTuple):
    time_devices: tuple  # (n_ch, n_t) grid: the device of each cell
    spread: bool         # each time shard steps on its own device / stream

    @property
    def devices(self) -> tuple:
        """Each channel shard's first device (may repeat): where its state
        and its outputs live."""
        return tuple(row[0] for row in self.time_devices)

    @property
    def n_time_shards(self) -> int:
        return len(self.time_devices[0])

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as ``jax.sharding.Mesh.shape``."""
        return {CHANNEL_AXIS: len(self.devices), TIME_AXIS: self.n_time_shards}


def make_mesh(n_channel_shards: int | None = None, n_time_shards: int = 1,
              devices=None) -> Mesh:
    """Build a (ch, t) mesh.

    ``devices``: with exactly ``n_ch`` devices the time shards of each
    channel shard stack on its one device (every row of ``time_devices``
    repeats it); with at least ``n_ch * n_t`` the first ``n_ch * n_t`` form
    the grid in row-major order, as JAX's ``reshape(n_ch, n_t)``, and each
    time shard steps on its own (``spread``); any other count raises.  A
    device may repeat (several shards on one device, as the CPU tests do).
    Default every visible CUDA device (raises without one): the grid where
    there are enough of them, else the time shards stacked on the first
    ``n_ch``.  ``n_channel_shards`` defaults to ``len(devices) // n_t``
    where that is at least 1 (JAX's default), else 1.  Pass the devices to
    fix the route whatever the host has.
    """
    every_gpu = devices is None
    if every_gpu:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    # a GPU by index, so that two cells on one card compare equal
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d
               for d in devices]
    if n_time_shards < 1:
        raise ValueError(f"n_time_shards={n_time_shards}")
    n_t = int(n_time_shards)
    if n_channel_shards is None:
        n_channel_shards = max(1, len(devices) // n_t)
    n_ch = int(n_channel_shards)
    if n_ch < 1:
        raise ValueError(f"n_channel_shards={n_ch}")
    if every_gpu and len(devices) < n_ch * n_t:
        devices = devices[:n_ch]
    if len(devices) == n_ch:
        grid = tuple((d,) * n_t for d in devices)
    elif len(devices) >= n_ch * n_t:
        grid = tuple(tuple(devices[r * n_t:(r + 1) * n_t])
                     for r in range(n_ch))
    else:
        raise ValueError(
            f"mesh of {n_ch} channel shards x {n_t} time shards over "
            f"{len(devices)} devices: give {n_ch} (time shards stacked) or "
            f"at least {n_ch * n_t} (one per time shard)")
    spread = n_t > 1 and len(devices) != n_ch
    if spread and len({d.type for row in grid for d in row}) > 1:
        raise ValueError("a spread mesh takes CUDA devices or the CPU, "
                         "not both")
    return Mesh(grid, spread)


def row_split(n_rows: int, n_shards: int) -> tuple:
    """Contiguous equal row ranges, one ``slice`` per shard."""
    if n_rows % n_shards:
        raise ValueError(
            f"{n_rows} channels not divisible by {n_shards} shards")
    per = n_rows // n_shards
    return tuple(slice(i * per, (i + 1) * per) for i in range(n_shards))


def rows_on(raw, rows: slice, device) -> torch.Tensor:
    """Rows ``rows`` of a host array or tensor as a tensor on ``device``."""
    if isinstance(raw, np.ndarray):
        return torch.as_tensor(np.ascontiguousarray(raw[rows])).to(device)
    return raw[rows].to(device)
