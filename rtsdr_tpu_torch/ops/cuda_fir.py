"""FIR bank on the hand-written CUDA kernel ``csrc/fir_bank.cu``.

Counterpart of ``rtsdr_tpu/ops/pallas_fir.py`` (``fir_bank``,
``fir_bank_carried``, ``fir_block_pre``): F equal-length filters over one
(C, N) float32 input at output stride s, with an optional elementwise
pre-op fused into the load (``"square"``: x*x, ``"mul2"``: 2*x*x2) and the
overlap-save state read in-kernel.

What the kernel replaces, what bounds it on an H100 and what its design
does about that is in the note at the top of ``csrc/fir_bank.cu``.  Any
``C >= 1`` and any ``N >= 1`` are taken; the kernel masks ragged edges.

On a CUDA tensor the wrappers launch the kernel or raise; on a CPU tensor
they run the plain version (``*_ref``), which is also what the kernel is
compared with on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rtsdr_tpu_torch.ops import _cuda
from rtsdr_tpu_torch.ops.fir import _conv1d_valid

_PRE = {"none": 0, "square": 1, "mul2": 2}
_taps_cache: dict = {}


def _taps_on(h_list, device) -> torch.Tensor:
    """(F, taps) float32 taps on ``device`` (rounded from float64 once)."""
    h = np.stack([np.asarray(hh, np.float64) for hh in h_list])
    key = (device, h.shape, h.tobytes())
    t = _taps_cache.get(key)
    if t is None:
        if len(_taps_cache) > 64:
            _taps_cache.clear()
        t = torch.as_tensor(h.astype(np.float32)).to(device)
        _taps_cache[key] = t
    return t


def _pre_op(x, x2, pre: str):
    if pre == "square":
        return x * x
    if pre == "mul2":
        return 2.0 * x * x2
    return x


def fir_bank_carried_ref(x, h_list, zi, stride: int = 1, x2=None,
                         pre: str = "none"):
    """Plain PyTorch version of ``fir_bank_carried`` (any device/dtype):
    ``zi=None`` is the zero state."""
    t1 = len(h_list[0]) - 1
    xp = _pre_op(x, x2, pre)
    if zi is None:
        zi = torch.zeros((*x.shape[:-1], t1), dtype=x.dtype, device=x.device)
    xext = torch.cat([zi, xp], dim=-1)
    ys = [_conv1d_valid(xext, h, stride) for h in h_list]
    return ys, xext[..., -t1:].contiguous()


def _launch(x, h_list, zi, stride, x2, pre, want_tail: bool):
    taps = len(h_list[0])
    n_f = len(h_list)
    if pre not in _PRE:
        raise ValueError(f"unknown pre-op {pre!r}")
    if not 1 <= n_f <= 3 or any(len(h) != taps for h in h_list):
        raise ValueError("fir_bank takes 1..3 filters of equal length")
    if x.dim() < 1:
        raise ValueError(f"x: expected (..., N), got {tuple(x.shape)}")
    lead, n = tuple(x.shape[:-1]), x.shape[-1]
    c = math.prod(lead)
    if c < 1 or n < 1:
        raise ValueError(f"x: empty input {tuple(x.shape)}")
    dev = x.device
    _cuda.check(x, "x", dtype=torch.float32)
    if pre == "mul2":
        if x2 is None:
            raise ValueError("pre='mul2' needs x2")
        _cuda.check(x2, "x2", (*lead, n), torch.float32, dev)
    if zi is not None:
        _cuda.check(zi, "zi", (*lead, taps - 1), torch.float32, dev)
    m = -(-n // stride)
    y = torch.empty((n_f, *lead, m), dtype=torch.float32, device=dev)
    tail = (torch.empty((*lead, taps - 1), dtype=torch.float32, device=dev)
            if want_tail else None)
    _cuda.launch(
        "rtsdr_fir_bank", f"fir_bank.{pre}",
        _cuda.ptr(x), _cuda.ptr(x2 if pre == "mul2" else None),
        _cuda.ptr(zi), _cuda.ptr(_taps_on(h_list, dev)), _cuda.ptr(y),
        _cuda.ptr(tail), c, n, m, taps, n_f, stride, _PRE[pre])
    return list(y.unbind(0)), tail


def fir_bank(x, h_list, stride: int = 1, x2=None,
             pre: str = "none") -> list[torch.Tensor]:
    """F same-length filters over one (..., N) f32 input from the zero
    state: returns F tensors (..., ceil(N/stride))."""
    if x.is_cuda:
        return _launch(x, h_list, None, stride, x2, pre, False)[0]
    return fir_bank_carried_ref(x, h_list, None, stride, x2, pre)[0]


def fir_bank_carried(x, h_list, zi, stride: int = 1, x2=None,
                     pre: str = "none") -> tuple[list[torch.Tensor],
                                                 torch.Tensor]:
    """``fir_block`` / ``fir_decimate`` semantics on the kernel.

    y[f][m] = sum_k h_f[k] * xext[m*stride + taps-1 - k], xext = [zi | x']
    (x' = pre-op of x), per filter; returns (ys, new_zi).  The carried
    ``zi`` is already in the pre-op domain (the tail is ``pre(x)``), so the
    pre-op applies to ``x`` only.
    """
    if x.is_cuda:
        return _launch(x, h_list, zi, stride, x2, pre, True)
    return fir_bank_carried_ref(x, h_list, zi, stride, x2, pre)


def fir_block_pre(x, h, zi, pre: str, x2=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``fir_block`` over an elementwise pre-op of x, the pre-op fused
    in-kernel (the reference's squaring+FIR / mixer+FIR fusions)."""
    ys, new_zi = fir_bank_carried(x, [h], zi, 1, x2=x2, pre=pre)
    return ys[0], new_zi
