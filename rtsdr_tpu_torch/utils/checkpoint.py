"""Checkpoint / resume for the receiver state (counterpart of
``rtsdr_tpu/utils/checkpoint.py``).

The reference has no checkpointing; its complete resumable state is the
scattered collection of zi tails, PLL fields and bit carries.  Here that
state is one tree of NamedTuples (``ReceiverState``, ``WidebandState``,
``ScanState``), so a checkpoint is one ``.npz`` file with one array per
leaf, keyed by the leaf's field path (``frontend/zi_i``,
``audio/pll/theta``, ``frame/carry``, ...).  The keys are those of the JAX
package's ``_flatten_paths`` and a ``None`` field writes nothing, so one
file resumes in either package.

Sharded state: a plain tuple in the tree (not a NamedTuple) holds one
state per shard — the time- and channel-sharded receivers' ``init_fn()``
output, a channel-sharded wideband receiver's ``rx``.  It is saved in
serial layout, the shards' rows concatenated in global order (along
axis 0, or the axis the enclosing state's ``shard_axis(field)`` names:
a ``WidebandState``'s ``rx`` rows lie after its batch dims), which is the layout of the JAX package's sharded state too.  On
load, the rows split back into equal contiguous parts
(``parallel/mesh.py::row_split``), each onto its shard's device.
"""

from __future__ import annotations

import numpy as np
import torch

from rtsdr_tpu_torch.utils.shards import concat_rows


def _is_shards(node) -> bool:
    return isinstance(node, tuple) and not hasattr(node, "_fields")


def _shard_dim(node, field: str) -> int:
    """The axis along which the shards of ``node.<field>`` are rows: the
    state's own ``shard_axis(field)`` where it has one, else 0."""
    axis = getattr(node, "shard_axis", None)
    return 0 if axis is None else axis(field)


def _leaves(node, key: str = "", dim: int = 0):
    """(path, tensor) of every leaf in serial layout (a shard tuple's rows
    gathered on the host)."""
    if node is None:
        return
    if isinstance(node, torch.Tensor):
        yield key, node
    elif _is_shards(node):
        yield from _leaves(concat_rows(list(node), torch.device("cpu"), dim),
                           key, dim)
    else:
        for name, v in zip(node._fields, node):
            yield from _leaves(v, f"{key}/{name}" if key else name,
                               _shard_dim(node, name))


def state_keys(state) -> list:
    """The checkpoint keys of ``state``, in tree order."""
    return [k for k, _ in _leaves(state)]


def save_state(path: str, state) -> None:
    """Save a state tree to an .npz file (every leaf fetched to the host;
    sharded subtrees in serial layout)."""
    arrays = {k: v.detach().cpu().numpy() for k, v in _leaves(state)}
    np.savez_compressed(path, **arrays)


def _restore(node, key, data, cuts, dim=0):
    """``node`` rebuilt from ``data``.  ``cuts`` lists (dim, index, count)
    of the shard tuples above it, outermost first; ``dim`` is the row axis
    if ``node`` is itself a shard tuple."""
    if node is None:
        return None
    if _is_shards(node):
        return tuple(_restore(s, key, data, cuts + [(dim, i, len(node))])
                     for i, s in enumerate(node))
    if not isinstance(node, torch.Tensor):
        return type(node)(*(
            _restore(v, f"{key}/{name}" if key else name, data, cuts,
                     _shard_dim(node, name))
            for name, v in zip(node._fields, node)))
    if key not in data:
        raise KeyError(f"checkpoint missing state leaf {key}")
    arr = data[key]
    full = list(node.shape)
    for dim, _, count in reversed(cuts):
        full[dim] *= count
    if arr.shape != tuple(full):
        raise ValueError(
            f"leaf {key}: checkpoint shape {arr.shape} != {tuple(full)}")
    from rtsdr_tpu_torch.parallel.mesh import row_split

    for dim, index, count in cuts:
        arr = arr[(slice(None),) * dim + (row_split(arr.shape[dim],
                                                    count)[index],)]
    # (np.ascontiguousarray would make a 0-d leaf 1-d)
    return torch.as_tensor(np.array(arr, order="C")).to(
        device=node.device, dtype=node.dtype)


def load_state(path: str, like):
    """Load a state saved by ``save_state`` (or by the JAX package's).
    ``like`` (an ``init_fn()`` output) gives the tree, every leaf's dtype
    (integer and float widths are cast to it) and device; a sharded
    subtree's rows go to each shard's device.  Raises ``KeyError`` for a
    leaf the file lacks and ``ValueError`` for a wrong shape."""
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    return _restore(like, "", data, [])
