"""Per-shard stepping shared by the sharded receivers.

A sharded receiver keeps one state per shard, each on its shard's device:
``step_shards`` steps each shard on its own input and gathers the outputs
on one device, in shard order (``parallel/channels.py``,
``parallel/timeshard.py`` and ``pipeline/wideband.py`` with
``channel_sharding``).  Each shard steps with its input's GPU made
current: the kernels launch on the current device's stream and read its
SM count.
"""

from __future__ import annotations

import contextlib

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
