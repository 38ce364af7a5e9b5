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

import numpy as np
import torch

from rtsdr_tpu_torch.ops import _cuda
from rtsdr_tpu_torch.ops.pll import PLLState, loop_constants, pll_loop

MAX_PARTS = 4
_consts_cache: dict = {}


def _lane_consts(batch_shape, c, device, freq, fs, nco_scale, phase_adjust,
                 norm_bandwidth, loop_div) -> torch.Tensor:
    """(5, C) float32 rows kp, ki, dtheta, scale, adjust on ``device``:
    float64 host math, broadcast per lane, then one cast (the plain
    version's rounding)."""
    consts = loop_constants(freq, fs, nco_scale, phase_adjust,
                            norm_bandwidth, loop_div)
    table = np.stack([np.broadcast_to(v, batch_shape).reshape(c)
                      for v in consts]).astype(np.float32)
    key = (device, table.shape, table.tobytes())
    t = _consts_cache.get(key)
    if t is None:
        if len(_consts_cache) > 64:
            _consts_cache.clear()
        t = torch.as_tensor(table).to(device)
        _consts_cache[key] = t
    return t


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
    if len(parts) > MAX_PARTS:
        raise ValueError(f"pll_cuda takes at most {MAX_PARTS} input parts")
    if loop_div not in (1, 2, 4, 8) or x0.shape[-1] % loop_div:
        raise ValueError("loop_div must be 1, 2, 4 or 8 and divide N")
    dev = x0.device
    n = x0.shape[-1]
    for p in parts:
        _cuda.check(p, "x", x0.shape, torch.float32, dev)
    batch_shape = (tuple(x0.shape[:-1]) if not isinstance(x, (tuple, list))
                   else (len(parts), *x0.shape[:-1]))
    c = int(np.prod(batch_shape)) if batch_shape else 1
    part_lanes = [p.numel() // n for p in parts]

    consts = _lane_consts(batch_shape, c, dev, freq, fs, nco_scale,
                          phase_adjust, norm_bandwidth, loop_div)
    for name, leaf in zip(PLLState._fields, state):
        if tuple(leaf.shape) != batch_shape or leaf.dtype != torch.float32 \
                or leaf.device != dev:
            raise ValueError(
                f"state.{name}: expected float32 {batch_shape} on {dev}, "
                f"got {leaf.dtype} {tuple(leaf.shape)} on {leaf.device}")
    st_in = torch.stack([leaf.reshape(c) for leaf in state])      # (7, C)
    st_out = torch.empty_like(st_in)
    nco_i = torch.empty((*batch_shape, n), dtype=torch.float32, device=dev)
    nco_q = torch.empty_like(nco_i)

    ptrs = (ctypes.c_void_p * len(parts))(*[p.data_ptr() for p in parts])
    lanes = (ctypes.c_int * len(parts))(*part_lanes)
    _cuda.launch(
        "rtsdr_pll", "pll",
        ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(lanes, ctypes.c_void_p),
        len(parts), _cuda.ptr(consts), _cuda.ptr(st_in), _cuda.ptr(st_out),
        _cuda.ptr(nco_i), _cuda.ptr(nco_q), c, n, loop_div,
        int(bool(delay_output)))
    new_state = PLLState(*(row.reshape(batch_shape)
                           for row in st_out.unbind(0)))
    return nco_i, nco_q, new_state
