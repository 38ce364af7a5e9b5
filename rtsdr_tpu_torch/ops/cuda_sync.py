"""The RDS frame layer's resync walk on the hand-written CUDA kernel
``csrc/sync_walk.cu`` (K7).

Counterpart of the ``jax.lax.scan`` in ``rtsdr_tpu/pipeline/frame.py::
resolve_sync`` (its ``scan_fn``), which XLA compiles into one device loop:
``sync_walk`` is ``pipeline.frame.resolve_sync(..., resync=True)`` for CUDA
tensors, in one launch at any lane count.  Its plain version is
``pipeline.frame._walk_plain``.

What bounds the kernel on an H100 and what its design does about that is in
the note at the top of ``csrc/sync_walk.cu``.
"""

from __future__ import annotations

import math

import torch

from rtsdr_tpu_torch.ops import _cuda

_I32 = torch.int32
#: the most windows the kernel takes: a tile of 8 lanes' rows (an int32 and
#: five flag bytes per window) in 48 KB of shared memory
MAX_WINDOWS = 48 * 1024 // (8 * 9)


def _operand(t, name: str, dtype, shape, dev) -> torch.Tensor:
    """``t`` checked and contiguous, as the kernel reads it (a device copy
    only where it is not contiguous already: no host sync)."""
    if t.dtype is not dtype:
        raise TypeError(f"sync_walk: {name} must be {dtype}, got {t.dtype}")
    if t.device != dev or tuple(t.shape) != shape:
        raise ValueError(f"sync_walk: {name} is {tuple(t.shape)} on "
                         f"{t.device}, expected {shape} on {dev}")
    return t.contiguous()


def sync_walk(sid, w_valid, base_pos, last_position, bad_count, corr=None):
    """``resolve_sync(..., resync=True)`` on the kernel: sid (..., W) int32,
    w_valid / corr (..., W) bool (corr None: no repairs), base_pos /
    last_position / bad_count (...,) int32 (sid's leading dims), all on
    one CUDA device.  Returns (is_sync, is_false_pos, is_resync,
    new_last_position, new_bad_count)."""
    dev = sid.device
    if sid.dtype is not _I32:
        raise TypeError(f"sync_walk: sid must be {_I32}, got {sid.dtype}")
    batch = tuple(sid.shape[:-1])
    w_max = sid.shape[-1]
    lanes = math.prod(batch)
    if lanes == 0 or w_max == 0:
        raise ValueError(f"sync_walk: empty block {tuple(sid.shape)}")
    if w_max > MAX_WINDOWS:
        raise ValueError(f"sync_walk: {w_max} windows, the kernel takes at "
                         f"most {MAX_WINDOWS}")
    win = (*batch, w_max)
    sid = sid.contiguous()
    valid = _operand(w_valid, "w_valid", torch.bool, win, dev).view(
        torch.uint8)
    rep = (None if corr is None else
           _operand(corr, "corr", torch.bool, win, dev).view(torch.uint8))
    base, last, bad = (_operand(t, name, _I32, batch, dev) for t, name in (
        (base_pos, "base_pos"), (last_position, "last_position"),
        (bad_count, "bad_count")))
    is_sync, is_fp, is_resync = (torch.empty(win, dtype=torch.bool,
                                             device=dev) for _ in range(3))
    new_last = torch.empty(batch, dtype=_I32, device=dev)
    new_bad = torch.empty(batch, dtype=_I32, device=dev)
    _cuda.launch(
        "rtsdr_sync_walk", "sync_walk", sid.data_ptr(), valid.data_ptr(),
        _cuda.ptr(rep), base.data_ptr(), last.data_ptr(), bad.data_ptr(),
        is_sync.data_ptr(), is_fp.data_ptr(), is_resync.data_ptr(),
        new_last.data_ptr(), new_bad.data_ptr(), lanes, w_max)
    return is_sync, is_fp, is_resync, new_last, new_bad
