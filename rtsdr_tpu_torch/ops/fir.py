"""Block FIR filtering with overlap-save state carry.

Counterpart of ``rtsdr_tpu/ops/fir.py``.  One formulation covers the
stateful block FIR, the multi-filter bank and the decimating FIR:

  * the carried state is the last ``taps-1`` *input* samples (overlap-save):
    ``y[n] = sum_k h[k] * xext[n*s + taps-1-k]``, ``xext = [zi | x]``,
    output-equivalent to chained ``scipy.signal.lfilter`` from zero initial
    conditions;
  * decimation fuses into the convolution as the output stride ``s``.

All functions are shape-polymorphic over leading batch dimensions
(channels) and dtype-polymorphic (float32 on the production path, float64
for oracle parity).

Where the work runs: a CUDA tensor goes to the hand-written FIR-bank
kernel (``ops/cuda_fir.py``), as the JAX functions go to their Pallas
kernel on a TPU — the kernel is float32, and its wrapper raises for any
other dtype rather than computing elsewhere; a CPU tensor takes the plain
version below, an explicit sum over the taps in the input's own dtype —
no convolution library call, so no TF32 on any device.  float64 is
therefore a CPU-only (oracle) path.
"""

from __future__ import annotations

import numpy as np
import torch


def fir_zi(num_taps: int, batch_shape: tuple = (), dtype=torch.float32,
           device="cuda") -> torch.Tensor:
    """Zero initial overlap-save state (last ``taps-1`` inputs)."""
    return torch.zeros((*batch_shape, num_taps - 1), dtype=dtype,
                       device=device)


def resample_zi(num_taps: int, batch_shape: tuple = (), dtype=torch.float32,
                device="cuda") -> torch.Tensor:
    """Zero initial state for ``fir_resample`` (upsampled-domain tail)."""
    return torch.zeros((*batch_shape, num_taps - 1), dtype=dtype,
                       device=device)


def _h64(h) -> np.ndarray:
    if isinstance(h, torch.Tensor):
        h = h.detach().cpu().numpy()
    return np.asarray(h, np.float64)


def _conv1d_valid(xext: torch.Tensor, h, stride: int = 1) -> torch.Tensor:
    """VALID 1-D convolution (true convolution: kernel flipped) over the
    last axis, batched over all leading axes — the plain version of every
    FIR in the port: ``y[m] = sum_k h[k] * xext[m*stride + taps-1-k]``
    accumulated tap by tap (k ascending) in ``xext``'s dtype."""
    h = _h64(h)
    taps = h.shape[0]
    m = (xext.shape[-1] - taps) // stride + 1
    y = torch.zeros((*xext.shape[:-1], m), dtype=xext.dtype,
                    device=xext.device)
    span = (m - 1) * stride + 1
    for k in range(taps):
        lo = taps - 1 - k
        y.add_(xext[..., lo:lo + span:stride], alpha=float(h[k]))
    return y


def _bank_kernel(x, h_list, zi, stride: int):
    """Run the CUDA FIR-bank kernel (it flattens the batch itself; it
    raises unless x is a non-empty float32 tensor)."""
    from rtsdr_tpu_torch.ops import cuda_fir

    return cuda_fir.fir_bank_carried(x.contiguous(), h_list,
                                     zi.contiguous(), stride)


def fir_block(x: torch.Tensor, h, zi: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stateful block FIR: y[n] = sum_k h[k] * xext[n + taps - 1 - k].

    Args:
      x:  (..., N) input block.
      h:  (taps,) impulse response.
      zi: (..., taps-1) previous block's input tail.

    Returns:
      y:      (..., N) filtered block (same alignment as lfilter).
      new_zi: (..., taps-1) this block's input tail.
    """
    if x.is_cuda:
        ys, new_zi = _bank_kernel(x, [_h64(h)], zi, 1)
        return ys[0], new_zi
    taps = len(h)
    xext = torch.cat([zi, x], dim=-1)
    return _conv1d_valid(xext, h), xext[..., -(taps - 1):]


def fir_block_bank(x: torch.Tensor, h_list, zi: torch.Tensor
                   ) -> tuple[tuple, torch.Tensor]:
    """``fir_block_multi`` returning a TUPLE of per-filter outputs (the
    kernel's outputs are separate arrays; callers that unpack at once skip
    the stacked copy)."""
    taps = {len(h) for h in h_list}
    assert len(taps) == 1, "fir_block_bank requires equal tap counts"
    if x.is_cuda:
        ys, new_zi = _bank_kernel(x, [_h64(h) for h in h_list], zi, 1)
        return tuple(ys), new_zi
    xext = torch.cat([zi, x], dim=-1)
    ys = tuple(_conv1d_valid(xext, h) for h in h_list)
    return ys, xext[..., -(taps.pop() - 1):]


def fir_block_multi(x: torch.Tensor, h_list, zi: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """F same-length FIRs over ONE input with ONE shared overlap-save state.

    Args:
      x: (..., N); h_list: sequence of (taps,) responses, equal taps.
      zi: (..., taps-1) shared input tail (all filters see the same input).

    Returns:
      y: (..., F, N); new_zi: (..., taps-1).
    """
    ys, new_zi = fir_block_bank(x, h_list, zi)
    return torch.stack(ys, dim=-2), new_zi


def fir_decimate(x: torch.Tensor, h, zi: torch.Tensor,
                 decim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused FIR + downsample-by-``decim``: computes only the kept outputs.

    Equivalent to ``lfilter(h, 1, x, zi)[::decim]`` but never materializes
    the dropped samples.
    """
    if x.is_cuda:
        ys, new_zi = _bank_kernel(x, [_h64(h)], zi, decim)
        return ys[0], new_zi
    taps = len(h)
    xext = torch.cat([zi, x], dim=-1)
    return _conv1d_valid(xext, h, stride=decim), xext[..., -(taps - 1):]


def _upsampled_tail_of(x: torch.Tensor, n_tail: int, up: int) -> torch.Tensor:
    """Last ``n_tail`` samples of zero-stuff(x, up), without materializing."""
    k = -(-n_tail // up)
    xt = x[..., -k:]
    u = torch.nn.functional.pad(xt[..., None], (0, up - 1))
    return u.reshape(*xt.shape[:-1], xt.shape[-1] * up)[..., -n_tail:]


def _resample_boundary_index(t1: int, up: int, down: int
                             ) -> tuple[np.ndarray, np.ndarray]:
    """Index math of the resampler's carried-state boundary.

    The first ceil(t1/down) outputs also read the carried upsampled-domain
    tail: output r takes tap kz = r*down + t1 - j from zi position j where
    valid.  Returns (kz clipped to [0, t1], valid mask), both
    (ceil(t1/down), t1) numpy arrays.
    """
    nb = -(-t1 // down)
    rz = np.arange(nb)[:, None]
    j = np.arange(t1)[None, :]
    kz = rz * down + t1 - j
    valid = (j >= rz * down) & (kz >= 0) & (kz <= t1)
    return np.clip(kz, 0, t1), valid


class DeviceCache(dict):
    """A cache whose values hold device tensors, emptied when it holds more
    than ``limit`` entries.  A kernel may still read a dropped value's
    tensors: queued on another stream (the spread route's time shards share
    their taps), or through a pointer its wrapper took before a later
    lookup of the same call emptied the cache.  So the values of one
    emptying are kept until the next, which first waits for the work
    queued on every device.

    A CUDA graph bakes the addresses its capture looked up, so a compiled
    step (``utils/jit.py``) keeps ``held_values()`` for the graph's
    lifetime; emptying a cache during a capture raises (the warm-up before
    a capture fills the caches, so a normal capture only hits)."""

    instances: list = []

    def __init__(self, limit: int = 64):
        super().__init__()
        self.limit, self.dropped = limit, []
        DeviceCache.instances.append(self)

    @classmethod
    def held_values(cls) -> list:
        """Every value the caches hold now."""
        return [v for cache in cls.instances for v in cache.values()]

    def make_room(self) -> None:
        if len(self) <= self.limit:
            return
        if torch.cuda.is_initialized() and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "DeviceCache: a CUDA graph capture looked up a new entry "
                f"in a full cache ({len(self)} > {self.limit} entries): "
                "emptying it needs a device synchronisation, which no "
                "capture admits; the step builds new tap arrays per call")
        if torch.cuda.is_initialized():
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)
        self.dropped = list(self.values())
        self.clear()


_derived = DeviceCache()


def derived_from_list(arrays, key, build):
    """What ``build()`` derives from the host arrays ``arrays`` (taps, say:
    matrices or phase taps on a device), made once per (arrays, key).
    Entries go by the arrays' identities and hold the arrays, so no id can
    pass to another array while its entry lives; tap arrays are not
    modified once used.  A hit reads and hashes no tap."""
    ids = tuple(map(id, arrays))
    entry = _derived.get(ids)
    if entry is None or any(a is not b for a, b in zip(entry[0], arrays)):
        _derived.make_room()
        entry = _derived[ids] = (tuple(arrays), {})
    hit = entry[1].get(key)
    if hit is None:
        hit = entry[1][key] = build()
    return hit


def derived_from(taps, key, build):
    """``derived_from_list`` for one array."""
    return derived_from_list((taps,), key, build)


def _resample_matrices(h: np.ndarray, up: int, down: int, dtype, device):
    """(block outputs b, window stride, window lead g, phase-banded matrix
    (span, b), boundary matrix (taps-1, nb)) of the x-domain resampler."""
    t1 = len(h) - 1
    b = up * max(1, 192 // up)   # a multiple of up: blocks start at phase 0
    g = -(-t1 // up)
    span = (b - 1) * down // up + g + 1
    # output r of a block reads window sample t with tap r*down + (g-t)*up
    k = (np.arange(b)[None, :] * down
         + (g - np.arange(span)[:, None]) * up)
    h_mat = np.where((k >= 0) & (k <= t1), h[np.clip(k, 0, t1)], 0.0)
    kz, valid = _resample_boundary_index(t1, up, down)
    hz = np.where(valid, h[kz], 0.0).T
    return (b, b * down // up, g,
            torch.as_tensor(h_mat, dtype=dtype).to(device),
            torch.as_tensor(hz, dtype=dtype).to(device))


def fir_resample(x: torch.Tensor, h, zi: torch.Tensor, up: int, down: int,
                 gain: float | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused rational resampler: zero-stuff x``up``, FIR, keep every
    ``down``-th; ``gain`` defaults to ``up`` (Parseval compensation).

    ``zi`` lives in the *upsampled* domain: shape (..., taps-1), the tail
    of the zero-stuffed stream, so chained blocks equal one long block.

    ``up == 1`` is a decimating FIR (the FIR-bank kernel on a CUDA tensor).
    ``up > 1`` has no kernel of its own in either package (the reference
    leaves it to its compiler): stock tensor ops on the input's device, in
    the x domain, so that nothing upsampled is ever made.  With
    ``uext = [zi | zero-stuff(x)]``,

        y[m] = gain * sum_k h[k] * uext[m*down + taps-1-k]
             = gain * (sum_i h[m*down - i*up] * x[i]  +  zi boundary terms):

    windows of x against a phase-banded matrix (only the ~taps/up taps that
    meet a sample), plus a small dense product for the first
    ceil((taps-1)/down) outputs, which also read the carried ``zi``.  It is
    the plain version the fused mixer + resampler + RRC kernel
    (``ops/cuda_resample.py``) is held against.
    """
    if gain is None:
        gain = float(up)
    if up == 1:
        y, new_zi = fir_decimate(x, h, zi, down)
        if gain == 1.0:
            return y, new_zi
        return y * gain, new_zi
    n = x.shape[-1]
    if (n * up) % down:
        raise ValueError(
            f"fir_resample: {n} samples x{up} do not divide by {down}")
    t1 = len(h) - 1
    m_total = n * up // down
    b, stride_x, g, h_mat, hz = derived_from(
        h, ("resample", up, down, x.dtype, str(x.device)),
        lambda: _resample_matrices(_h64(h), up, down, x.dtype, x.device))
    nblk = -(-m_total // b)
    span = h_mat.shape[0]
    right = max(0, (nblk - 1) * stride_x + span - g - n)
    windows = torch.nn.functional.pad(x, (g, right)).unfold(
        -1, span, stride_x)[..., :nblk, :]
    y = torch.matmul(windows, h_mat).reshape(*x.shape[:-1], nblk * b)
    y = y[..., :m_total].contiguous()
    nb = min(hz.shape[1], m_total)
    y[..., :nb] += torch.matmul(zi, hz[:, :nb])
    if n * up >= t1:
        new_zi = _upsampled_tail_of(x, t1, up)
    else:   # a block shorter than the tail keeps part of the old one
        u = torch.nn.functional.pad(x[..., None], (0, up - 1))
        new_zi = torch.cat([zi, u.reshape(*x.shape[:-1], n * up)],
                           dim=-1)[..., -t1:]
    return y * gain, new_zi.contiguous()
