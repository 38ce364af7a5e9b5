"""PLL / NCO stage on the hand-written CUDA kernel ``csrc/pll.cu``.

Counterpart of ``rtsdr_tpu/ops/pallas_pll.py`` (``pll_pallas``): drop-in
for ``ops.pll.pll`` on float32 CUDA input — same delayed-by-one NCO views,
same 7-leaf state, ``loop_div``, per-lane constant arrays, tuple input
read part by part without a stacked copy.

What the kernel replaces, what bounds it on an H100 and what its design
does about that is in the note at the top of ``csrc/pll.cu``.  Its plain
version is ``ops.pll.pll_loop``.
"""

from __future__ import annotations

import ctypes
import math
import operator

import numpy as np
import torch

from rtsdr_tpu_torch.ops import _cuda
from rtsdr_tpu_torch.ops.fir import DeviceCache
from rtsdr_tpu_torch.ops.pll import PLLState, loop_constants, pll_loop

MAX_PARTS = 4
_F32 = torch.float32
_PtrArray = ctypes.c_void_p * MAX_PARTS


def _arg_key(v):
    """A cache key for one loop-constant argument: Python scalars by value,
    anything else through ``np.asarray`` (lists, tuples, numpy scalars and
    arrays), by value up to 64 elements and by identity above that (the
    entry holds it)."""
    if isinstance(v, (int, float)):
        return float(v)
    a = np.asarray(v)
    if a.size <= 64:
        return (a.shape, a.dtype.str, a.tobytes())
    return ("id", id(v))


def _lane_consts(batch_shape, c, device, freq, fs, nco_scale, phase_adjust,
                 norm_bandwidth, loop_div) -> torch.Tensor:
    """(5, C) float32 rows kp, ki, dtheta, scale, adjust on ``device``:
    float64 host math, broadcast per lane, then one cast (the plain
    version's rounding)."""
    consts = loop_constants(freq, fs, nco_scale, phase_adjust,
                            norm_bandwidth, loop_div)
    table = np.stack([np.broadcast_to(v, batch_shape).reshape(c)
                      for v in consts]).astype(np.float32)
    return torch.as_tensor(table).to(device)


def _rows_of_one_block(leaves, c):
    """The (len(leaves), C) tensor whose rows the leaves are, when they
    are consecutive rows of one contiguous buffer (views of one tensor: a
    state this wrapper returned, or ``stacked_state``'s), else None: no
    copy is then made."""
    first = leaves[0]
    base = first._base
    if base is None:
        return None
    start, size = first.data_ptr(), first.element_size()
    for i, leaf in enumerate(leaves):
        if (leaf._base is not base or leaf.data_ptr() != start + i * c * size
                or not leaf.is_contiguous()):
            return None
    return first.as_strided((len(leaves), c), (c, 1))


def stacked_state(states) -> PLLState:
    """One PLLState of leaves (S, ...) from S states of equal shape, its
    leaves rows of one (7, S, ...) buffer (what ``pll_cuda`` reads without
    a copy): the S states' own buffer where they are the S parts of one
    (the receiver's pilot and carrier loops, split from one call's state),
    else one stacked copy."""
    s, shape = len(states), tuple(states[0].integrator.shape)
    c = math.prod(shape)
    flat = [leaf for group in zip(*states) for leaf in group]   # (7, S)
    block = _rows_of_one_block(flat, c)
    if block is None:
        block = torch.stack([leaf.reshape(c) for leaf in flat])
    return PLLState(*block.view(7, s, *shape).unbind(0))


def pll_cuda(x, state: PLLState, *, freq, fs: float, nco_scale=1.0,
             phase_adjust=0.0, norm_bandwidth=0.01,
             delay_output: bool = True, loop_div: int = 1
             ) -> tuple[torch.Tensor, torch.Tensor, PLLState]:
    """``ops.pll.pll`` on the kernel: x (..., N) float32 on a CUDA device,
    or a tuple of up to 4 equal-shape parts (= ``torch.stack(x, 0)``).  A
    CPU input runs the plain loop instead."""
    parts = list(x) if isinstance(x, (tuple, list)) else [x]
    x0 = parts[0]
    if not x0.is_cuda:
        xs = torch.stack(parts, 0) if isinstance(x, (tuple, list)) else x
        return pll_loop(xs, state, freq=freq, fs=fs, nco_scale=nco_scale,
                        phase_adjust=phase_adjust,
                        norm_bandwidth=norm_bandwidth,
                        delay_output=delay_output, loop_div=loop_div)
    is_tuple = isinstance(x, (tuple, list))
    # the host work of a call is on the C = 1 step's critical path: a plan
    # found by the identity of the loop-constant arguments (by their value
    # when they are new objects), the checks, the outputs, the launch
    args = (freq, nco_scale, phase_adjust, norm_bandwidth)
    ikey = (x0.shape, len(parts), is_tuple, x0.get_device(), fs, loop_div,
            *map(id, args))
    plan = _by_id.get(ikey)
    if plan is None or not all(map(operator.is_, plan[-1][0], args)):
        plan = _plan(parts, is_tuple, args, fs, loop_div, ikey)
    (dev, bshape, c, n, lanes_arg, n_parts, consts_ptr, _) = plan
    shape = x0.shape
    for p in parts:
        if (p.dtype is not _F32 or p.shape != shape or p.device != dev
                or not p.is_contiguous()):
            _cuda.check(p, "x", shape, _F32, dev)
    ptrs = _PtrArray(*[p.data_ptr() for p in parts])
    st_in = _rows_of_one_block(state, c)                          # (7, C)
    if st_in is None:
        for name, leaf in zip(PLLState._fields, state):
            if leaf.shape != bshape or leaf.dtype is not _F32 \
                    or leaf.device != dev:
                raise ValueError(
                    f"state.{name}: expected float32 {tuple(bshape)} on "
                    f"{dev}, got {leaf.dtype} {tuple(leaf.shape)} on "
                    f"{leaf.device}")
        st_in = torch.stack([leaf.reshape(c) for leaf in state])
    elif (st_in.dtype is not _F32 or st_in.device != dev
          or any(leaf.shape != bshape for leaf in state)):
        raise ValueError(f"state: expected float32 leaves {tuple(bshape)} "
                         f"on {dev}")
    nco_i, nco_q = x0.new_empty((2, *bshape, n)).unbind(0)
    st_out = x0.new_empty((7, *bshape))
    new_state = PLLState(*st_out.unbind(0))
    _cuda.launch(
        "rtsdr_pll", "pll", ctypes.addressof(ptrs), lanes_arg, n_parts,
        consts_ptr, st_in.data_ptr(), st_out.data_ptr(), nco_i.data_ptr(),
        nco_q.data_ptr(), c, n, loop_div, int(bool(delay_output)))
    return nco_i, nco_q, new_state


_plans = DeviceCache()
_by_id = DeviceCache()


def _plan(parts, is_tuple, args, fs, loop_div, ikey):
    """What a call of this shape and these loop constants needs beyond its
    pointers, made once: argument checks, the batch shape, the (5, C)
    constants on the device, the host array of lane counts the C entry
    point reads.  Found again by the arguments' identity (``ikey``; the
    entry holds them) or, for new objects, by their value."""
    x0 = parts[0]
    key = (x0.shape, len(parts), is_tuple, x0.get_device(), float(fs),
           loop_div, *(_arg_key(v) for v in args))
    plan = _plans.get(key)
    if plan is None:
        if len(parts) > MAX_PARTS:
            raise ValueError(
                f"pll_cuda takes at most {MAX_PARTS} input parts")
        if loop_div not in (1, 2, 4, 8) or x0.shape[-1] % loop_div:
            raise ValueError("loop_div must be 1, 2, 4 or 8 and divide N")
        dev = x0.device
        n = x0.shape[-1]
        batch_shape = ((len(parts), *x0.shape[:-1]) if is_tuple
                       else tuple(x0.shape[:-1]))
        c = math.prod(batch_shape)
        consts = _lane_consts(batch_shape, c, dev, *args[:1], fs, *args[1:],
                              loop_div)
        lanes = (ctypes.c_int * MAX_PARTS)(*([c // len(parts)] * len(parts)))
        _plans.make_room()
        plan = _plans[key] = (
            dev, torch.Size(batch_shape), c, n, ctypes.addressof(lanes),
            len(parts), consts.data_ptr(), (args, consts, lanes))
    _by_id.make_room()
    _by_id[ikey] = plan[:-1] + ((args,) + plan[-1][1:],)
    return _by_id[ikey]
