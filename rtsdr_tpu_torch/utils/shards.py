"""Per-shard stepping shared by the sharded receivers.

A sharded receiver keeps one state per shard, each on its shard's device:
``step_shards`` steps each shard on its own input and gathers the outputs
on one device, in shard order (``parallel/channels.py``,
``parallel/timeshard.py`` and ``pipeline/wideband.py`` with
``channel_sharding``).
"""

from __future__ import annotations

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


def step_shards(steps, states, inputs, device, dim: int = 0):
    """``steps[i](states[i], inputs[i])`` for every shard, in order;
    ``inputs`` may be a generator that moves each shard's part to its
    device as it is taken.  Returns the tuple of new states and the outputs
    gathered along ``dim`` on ``device``."""
    new, outs = [], []
    for step, st, x in zip(steps, states, inputs):
        st, out = step(st, x)
        new.append(st)
        outs.append(out)
    return tuple(new), concat_rows(outs, device, dim)
