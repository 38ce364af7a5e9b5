"""Channel-parallel receivers: many FM stations spread over the mesh's
channel shards.

Counterpart of ``rtsdr_tpu/parallel/channels.py``.  Each channel shard runs
the batched receiver over its own contiguous rows on its own device, with
no communication at all; state stays on the shard's device from step to
step, and outputs come back in global row order.

Compiled as the JAX package jits them (``utils/jit.py``): a mesh of one
device is one ``CompiledStep``; a mesh over two or more devices is a
``ComposedStep`` with one part per device, each part holding the shards
that live there (``shard_rows``, ``compose_wideband``).
"""

from __future__ import annotations

import numpy as np
import torch

from rtsdr_tpu_torch.config import ReceiverConfig
from rtsdr_tpu_torch.parallel.mesh import (
    CHANNEL_AXIS,
    Mesh,
    row_split,
    rows_on,
)
from rtsdr_tpu_torch.pipeline.receiver import make_receiver
from rtsdr_tpu_torch.utils.jit import (
    CompiledStep,
    ComposedStep,
    device_groups,
    jit_step,
)
from rtsdr_tpu_torch.utils.shards import concat_rows, step_shards


def _rows_of(raw, slices):
    """The rows ``slices`` of a host array or tensor, in order, as one
    array (a view where there is one slice)."""
    parts = [raw[sl] for sl in slices]
    if len(parts) == 1:
        return parts[0]
    if isinstance(raw, np.ndarray):
        return np.concatenate(parts)
    return torch.cat(parts)


def _step_each(steps, states, xs):
    """``steps[j](states[j], xs[j])`` for each shard of one part: the new
    states and the outputs, each a tuple in shard order."""
    new, outs = [], []
    for step, st, x in zip(steps, states, xs):
        st, out = step(st, x)
        new.append(st)
        outs.append(out)
    return tuple(new), tuple(outs)


def shard_rows(inits, steps, rows, devices, jit: bool, name: str,
               groups=None):
    """``(init_fn, step)`` of a receiver whose shard i steps ``steps[i]``
    from ``inits[i]()`` on ``devices[i]`` over the rows ``rows[i]`` of each
    block.  The state is the tuple of shard states; outputs are gathered on
    ``devices[0]`` in shard order.

    ``jit``: where every shard lies on one device, one ``CompiledStep``;
    over two or more devices a ``ComposedStep`` with one part per entry of
    ``groups`` (``[(device, shard indices)]``; default one per distinct
    device, ``device_groups``), each part stepping its shards over its own
    rows.  Else the eager step."""
    def init_fn() -> tuple:
        return tuple(init() for init in inits)

    def step_fn(state: tuple, raw_u8):
        return step_shards(
            steps, state,
            (rows_on(raw_u8, sl, dev) for sl, dev in zip(rows, devices)),
            devices[0])

    if not jit:
        return init_fn, step_fn
    if groups is None:
        groups = device_groups(devices)
    if len(groups) == 1:
        return jit_step(init_fn, step_fn, groups[0][0], name=name)

    def part(idx):
        sizes = [rows[i].stop - rows[i].start for i in idx]

        def init():
            return tuple(inits[i]() for i in idx)

        def step(states, x):
            return _step_each([steps[i] for i in idx], states,
                              x.split(sizes))
        return init, step

    parts = [CompiledStep(*part(idx), dev, f"{name}, shards {idx} on {dev}")
             for dev, idx in groups]
    order = [i for _, idx in groups for i in idx]

    def merge(trees):
        flat = dict(zip(order, (st for tree in trees for st in tree)))
        return tuple(flat[i] for i in range(len(inits)))

    def gather(outs):
        flat = dict(zip(order, (o for out in outs for o in out)))
        return concat_rows([flat[i] for i in range(len(inits))], devices[0])

    return init_fn, ComposedStep(
        parts,
        split=lambda state: [tuple(state[i] for i in idx)
                             for _, idx in groups],
        merge=merge,
        feed=lambda k, raw, _: _rows_of(raw, [rows[i] for i in groups[k][1]]),
        gather=gather, name=name)


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

    ``jit`` (default True): the step is compiled with its state donated, as
    the JAX package's ``jax.jit(step, donate_argnums=0)`` (``utils/jit.py``:
    the state it returns is updated in place by the next call): one
    ``CompiledStep`` on a mesh of one device (shards may repeat it), a
    ``ComposedStep`` of one per device on a mesh over two or more.
    """
    rows = row_split(n_channels, mesh.shape[CHANNEL_AXIS])
    per = n_channels // len(rows)
    shards = [make_receiver(cfg, (per,), dtype, device=dev, **kwargs)
              for dev in mesh.devices]
    return (*shard_rows(
        [init for init, _ in shards], [step for _, step in shards], rows,
        mesh.devices, jit, f"channel-sharded receiver ({len(rows)} shards)"),
        rows)


def compose_wideband(init_fn, step_fn, groups, name: str) -> ComposedStep:
    """The channel-sharded wideband step (``make_wideband_receiver`` with
    ``channel_sharding``) as one compiled part per entry of ``groups``
    (``[(device, station-shard indices)]``, the first on the channelizer's
    device): the first part holds the channelizer, the residual NCO and its
    own shards' stations, and hands each later part its shards' slice of
    the channelized I/Q, which that part decodes from its own input
    buffer."""
    stages = step_fn.stages
    ax, n = stages.k_axis, stages.k_sh
    steps = stages.steps

    def iq_of(iq, idx):
        return torch.cat([iq.narrow(ax, i * n, n) for i in idx], ax)

    head_idx = groups[0][1]
    rest = [idx for _, idx in groups[1:]]

    def head_init():
        st = init_fn()
        return st._replace(rx=tuple(st.rx[i] for i in head_idx))

    def head_step(st, raw_u8):
        iq, chan_zi, mix_phase = stages.front(st, raw_u8)
        rx, outs = _step_each([steps[i] for i in head_idx], st.rx,
                              [iq.narrow(ax, i * n, n) for i in head_idx])
        return (st._replace(chan_zi=chan_zi, rx=rx, mix_phase=mix_phase),
                (outs, tuple(iq_of(iq, idx) for idx in rest)))

    def part(idx):
        def init():
            return tuple(init_fn().rx[i] for i in idx)

        def step(states, iq):
            return _step_each([steps[i] for i in idx], states,
                              iq.split(n, ax))
        return init, step

    parts = [CompiledStep(head_init, head_step, groups[0][0],
                          f"{name}, front and shards {head_idx}")]
    parts += [CompiledStep(*part(idx), dev, f"{name}, shards {idx} on {dev}")
              for dev, idx in groups[1:]]
    order = [i for _, idx in groups for i in idx]

    def split(state):
        return [state._replace(rx=tuple(state.rx[i] for i in head_idx))] + [
            tuple(state.rx[i] for i in idx) for idx in rest]

    def merge(trees):
        flat = dict(zip(order, (*trees[0].rx, *(s for t in trees[1:]
                                                for s in t))))
        return trees[0]._replace(rx=tuple(flat[i] for i in range(len(order))))

    def feed(k, raw_u8, outs):
        return raw_u8 if k == 0 else outs[0][1][k - 1]

    def gather(outs):
        flat = dict(zip(order, (*outs[0][0], *(o for out in outs[1:]
                                               for o in out))))
        return concat_rows([flat[i] for i in range(len(order))],
                           groups[0][0], dim=ax)

    return ComposedStep(parts, split, merge, feed, gather, name)


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
    device.  The step is compiled with its state donated, as the JAX
    package's is always (``utils/jit.py``): one ``CompiledStep`` on a mesh
    of one device; on a mesh over two or more, one part per device
    (``compose_wideband``: the channelizer's device holds it and its own
    stations, every other device its stations).  ``make_wideband_receiver``
    with no ``jit_step`` is the eager step.
    """
    from rtsdr_tpu_torch.pipeline.wideband import make_wideband_receiver

    name = f"wideband-sharded receiver K={n_rf_channels}"
    init_fn, step_fn = make_wideband_receiver(
        cfg, n_rf_channels, dtype=dtype, channel_sharding=mesh.devices,
        device=mesh.devices[0], **kwargs)
    groups = device_groups(mesh.devices)
    if len(groups) == 1:
        return jit_step(init_fn, step_fn, mesh.devices[0], name=name)
    return init_fn, compose_wideband(init_fn, step_fn, groups, name)
