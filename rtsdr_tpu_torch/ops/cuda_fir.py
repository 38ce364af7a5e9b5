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
import operator

import numpy as np
import torch

from rtsdr_tpu_torch.ops import _cuda
from rtsdr_tpu_torch.ops.fir import (
    DeviceCache,
    _conv1d_valid,
    derived_from_list,
)

_PRE = {"none": 0, "square": 1, "mul2": 2}


def _taps_on(h_list, device) -> torch.Tensor:
    """(F, taps) float32 taps on ``device`` (rounded from float64 once)."""
    def build():
        h = np.stack([np.asarray(hh, np.float64) for hh in h_list])
        return torch.as_tensor(h.astype(np.float32)).to(device)

    return derived_from_list(h_list, ("taps", device), build)


def bank_plan(taps: int, stride: int) -> tuple[int, int]:
    """(lead, q_pad) of the kernel's polyphase plan: ``lead`` = taps-1
    rounded up to a multiple of 4 (the front padding puts the staged span
    on a 16-byte boundary), ``q_pad`` = taps per phase filter,
    ceil((lead+1) / stride) rounded up to a multiple of 4."""
    lead = -(-(taps - 1) // 4) * 4
    return lead, -(-(-(-(lead + 1) // stride)) // 4) * 4


def phase_taps(h_list, stride: int) -> np.ndarray:
    """The kernel's (F, stride, q_pad) float32 phase taps:
    ``hp[f, phi, q] = h_f[lead - q*stride - phi]`` where that index lies in
    [0, taps), else 0 (``csrc/fir_bank.cu``)."""
    h = np.stack([np.asarray(hh, np.float64) for hh in h_list]
                 ).astype(np.float32)
    taps = h.shape[1]
    lead, q_pad = bank_plan(taps, stride)
    k = lead - (np.arange(q_pad)[None, :] * stride
                + np.arange(stride)[:, None])                 # (s, q_pad)
    ok = (k >= 0) & (k < taps)
    return np.ascontiguousarray(
        np.where(ok[None], h[:, np.clip(k, 0, taps - 1)], 0.0)
        .astype(np.float32))


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


_plans = DeviceCache()
_F32 = torch.float32


def _plan(x, h_list, stride: int, pre: str, key):
    """What a call of this shape needs beyond its pointers, made once per
    (tap arrays, x shape and device, stride, pre-op): argument checks,
    output shapes, the phase taps on the device."""
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
    m = -(-n // stride)
    hp = derived_from_list(
        h_list, ("phase", stride, dev),
        lambda: torch.as_tensor(phase_taps(h_list, stride)).to(dev))
    y_shape = (*lead, m) if n_f == 1 else (n_f, *lead, m)
    _plans.make_room()
    plan = _plans[key] = (tuple(h_list), dev, torch.Size((*lead, taps - 1)),
                          y_shape, hp.data_ptr(), hp, c, n, m, taps, n_f,
                          f"fir_bank.{pre}", _PRE[pre])
    return plan


def _launch(x, h_list, zi, stride, x2, pre, want_tail: bool):
    # the host work of a call is on the C = 1 step's critical path: a plan
    # lookup, the checks, the outputs, the launch
    key = (tuple(map(id, h_list)), x.shape, x.get_device(), stride, pre)
    plan = _plans.get(key)
    if plan is None or not all(map(operator.is_, plan[0], h_list)):
        plan = _plan(x, h_list, stride, pre, key)
    (_, dev, zi_shape, y_shape, hp_ptr, _, c, n, m, taps, n_f, count_as,
     pre_id) = plan
    if x.dtype is not _F32 or not x.is_contiguous():
        _cuda.check(x, "x", dtype=_F32)
    if pre_id == 2:
        if x2 is None:
            raise ValueError("pre='mul2' needs x2")
        _cuda.check(x2, "x2", x.shape, _F32, dev)
    if zi is not None and (zi.shape != zi_shape or zi.dtype is not _F32
                           or zi.device != dev or not zi.is_contiguous()):
        _cuda.check(zi, "zi", zi_shape, _F32, dev)
    y = x.new_empty(y_shape)
    ys = [y] if n_f == 1 else list(y.unbind(0))
    tail = x.new_empty(zi_shape) if want_tail else None
    # the launch is the last host work of the call: the kernel starts as
    # soon as the host has done everything else
    _cuda.launch(
        "rtsdr_fir_bank", count_as, x.data_ptr(),
        x2.data_ptr() if pre_id == 2 else None,
        None if zi is None else zi.data_ptr(), hp_ptr, y.data_ptr(),
        None if tail is None else tail.data_ptr(), c, n, m, taps, n_f,
        stride, pre_id)
    return ys, tail


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
