"""The (channel, time) mesh of the parallel receivers.

Counterpart of ``rtsdr_tpu/parallel/mesh.py``.  PyTorch has no mesh and no
global array, so the port's mesh is what the receivers need to know: one
torch device per channel shard and the number of time shards.  The channel
axis maps onto devices (each shard's stations run on its own device, with
no communication); the T time shards of one channel shard are stacked along
a leading dimension on that shard's device, where every JAX collective of
the time axis becomes a tensor operation on that dimension
(``parallel/timeshard.py``).  Spreading one channel shard's time shards
over several GPUs is not done here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rtsdr_tpu_torch.device import resolve_device

CHANNEL_AXIS = "ch"
TIME_AXIS = "t"


class Mesh(NamedTuple):
    devices: tuple       # torch.device of each channel shard (may repeat)
    n_time_shards: int

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as ``jax.sharding.Mesh.shape``."""
        return {CHANNEL_AXIS: len(self.devices), TIME_AXIS: self.n_time_shards}


def make_mesh(n_channel_shards: int | None = None, n_time_shards: int = 1,
              devices=None) -> Mesh:
    """Build a (ch, t) mesh.

    ``devices``: the devices the channel shards take, in order; default all
    visible CUDA devices (raises without one).  A device may repeat (several
    channel shards on one device, as the CPU tests do).  Defaults to one
    channel shard per device.  Time shards take no devices of their own:
    they share their channel shard's.
    """
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_channel_shards is None:
        n_channel_shards = len(devices)
    if not 1 <= n_channel_shards <= len(devices):
        raise ValueError(f"mesh of {n_channel_shards} channel shards over "
                         f"{len(devices)} devices")
    if n_time_shards < 1:
        raise ValueError(f"n_time_shards={n_time_shards}")
    return Mesh(tuple(devices[:n_channel_shards]), int(n_time_shards))


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
