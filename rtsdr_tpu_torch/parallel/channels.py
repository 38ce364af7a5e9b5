"""Channel-parallel receivers: many FM stations spread over the mesh's
channel shards.

Counterpart of ``rtsdr_tpu/parallel/channels.py``.  Each channel shard runs
the batched receiver over its own contiguous rows on its own device, with
no communication at all; state stays on the shard's device from step to
step, and outputs come back in global row order.
"""

from __future__ import annotations

import torch

from rtsdr_tpu_torch.config import ReceiverConfig
from rtsdr_tpu_torch.parallel.mesh import (
    CHANNEL_AXIS,
    Mesh,
    row_split,
    rows_on,
)
from rtsdr_tpu_torch.pipeline.receiver import make_receiver
from rtsdr_tpu_torch.utils.jit import jit_on_one_device
from rtsdr_tpu_torch.utils.shards import step_shards


def make_channel_sharded_receiver(
    cfg: ReceiverConfig,
    mesh: Mesh,
    n_channels: int,
    dtype=torch.float32,
    jit: bool = True,
    **kwargs,
):
    """Build ``(init_fn, step_fn, row_split)`` with the channels spread over
    the mesh's channel shards, each on its row's first device (the time
    axis, and a grid mesh's other devices, are not used).

    ``row_split``: one ``slice`` of global rows per shard.  ``init_fn()``:
    a tuple with one ``ReceiverState`` per shard, on its device.
    ``step_fn(state, raw_u8)``: raw_u8 is (n_channels, block_size) uint8 (a
    host array or a tensor on any device); each shard's rows go to its
    device.  Outputs are the serial receiver's, rows in global order, on the
    mesh's first device.  ``kwargs`` go to ``make_receiver``.

    ``jit`` (default True): on a mesh of one device (shards may repeat it)
    the step is compiled with its state donated, as the JAX package's
    ``jax.jit(step, donate_argnums=0)`` (``utils/jit.py``: the state it
    returns is updated in place by the next call); a mesh over two or more
    devices steps eagerly.
    """
    rows = row_split(n_channels, mesh.shape[CHANNEL_AXIS])
    per = n_channels // len(rows)
    shards = [make_receiver(cfg, (per,), dtype, device=dev, **kwargs)
              for dev in mesh.devices]

    def init_fn() -> tuple:
        return tuple(init() for init, _ in shards)

    def step_fn(state: tuple, raw_u8):
        return step_shards(
            [step for _, step in shards], state,
            (rows_on(raw_u8, sl, dev) for sl, dev in zip(rows, mesh.devices)),
            mesh.devices[0])

    return (*jit_on_one_device(
        init_fn, step_fn, mesh.devices, jit,
        f"channel-sharded receiver ({len(rows)} shards)"), rows)


def make_wideband_sharded_receiver(
    cfg: ReceiverConfig,
    mesh: Mesh,
    n_rf_channels: int,
    dtype=torch.float32,
    **kwargs,
):
    """Wideband receiver (pipeline/wideband.py) decoded across the mesh:
    one K-wide capture in, the K stations spread over the channel shards.

    The channelizer runs on the mesh's first device; each shard's stations
    go to its device and decode there (``channel_sharding``).  State: a
    ``WidebandState`` whose ``rx`` is a tuple of per-shard receiver states.
    Outputs are the unsharded receiver's, stations in order, on the first
    device.  On a mesh of one device the step is compiled with its state
    donated, as the JAX package's is always (``utils/jit.py``); a mesh over
    two or more devices steps eagerly.  ``make_wideband_receiver`` with no
    ``jit_step`` is the eager step.
    """
    from rtsdr_tpu_torch.pipeline.wideband import make_wideband_receiver

    return jit_on_one_device(
        *make_wideband_receiver(cfg, n_rf_channels, dtype=dtype,
                                channel_sharding=mesh.devices,
                                device=mesh.devices[0], **kwargs),
        mesh.devices, True,
        f"wideband-sharded receiver K={n_rf_channels}")
