"""RDS mixer + rational resampler (+ RRC matched filter) on the hand-written
CUDA kernels of ``csrc/resample_rrc.cu``.

Counterpart of ``rtsdr_tpu/ops/pallas_fir.py`` (``resample_mul2_rrc``,
``resample_mul2``, ``resample_mul2_tail``): one pass of
``resample_mul2_rrc`` does

    mixed  = 2 * extract[..., None, :] * stack([nco_i, nco_q], -2)
    resamp, new_zi     = fir_resample(mixed, h, zi, up, down)   (gain = up)
    rrc,    new_rrc_zi = fir_block(resamp, rrc_h, rrc_zi)

and the (..., 2, N) mixed streams and the (..., 2, M) resampler stream never
reach device memory; ``resample_mul2`` stops after the resampler and writes
its (..., 2, M) output (the time-sharded receiver's route, which runs the
RRC after the halo exchange).  ``zi`` is the carried tail of the zero-stuffed
mixed stream (upsampled domain, arbitrary floats).  Both kernels write
``new_zi`` themselves (one launch, no stock ops), equal bit for bit to
``resample_mul2_tail`` of the last ceil((taps-1)/up) inputs, which is how
the reference computes it outside its kernel.  ``resample_mul2(...,
segments=T)`` is the time-sharded receiver's form: T stacked chunks, each
reading its left neighbour's inputs in place as its halo.

What the kernel replaces, what bounds it on an H100 and what its design
does about that is in the note at the top of ``csrc/resample_rrc.cu``.  Any
``C >= 1``, ``up``, ``down`` and tap counts are taken as long as
``N * up`` divides by ``down``.

On a CUDA tensor the wrappers launch their kernel or raise; on a CPU tensor
they run the plain versions (``resample_mul2_rrc_ref``,
``resample_mul2_ref``), which are also what the kernels are compared with
on the card.
"""

from __future__ import annotations

import math

import torch

from rtsdr_tpu_torch.ops import _cuda
from rtsdr_tpu_torch.ops.cuda_fir import _taps_on
from rtsdr_tpu_torch.ops.fir import (
    _conv1d_valid,
    _upsampled_tail_of,
    fir_resample,
)

_F32 = torch.float32


def _mixed(extract, nco_i, nco_q):
    return 2.0 * extract[..., None, :] * torch.stack([nco_i, nco_q], dim=-2)


def resample_mul2_tail(extract, nco_i, nco_q, t1: int, up: int
                       ) -> torch.Tensor:
    """The upsampled-domain carry of the mixer + resampler: the zero-stuffed
    tail of the mixed stream, from the last ceil(t1/up) input samples."""
    kt = -(-t1 // up)
    return _upsampled_tail_of(
        _mixed(extract[..., -kt:], nco_i[..., -kt:], nco_q[..., -kt:]),
        t1, up).contiguous()


def resample_mul2_rrc_ref(extract, nco_i, nco_q, h, zi, rrc_h, rrc_zi,
                          up: int, down: int, gain: float | None = None):
    """Plain PyTorch version of ``resample_mul2_rrc`` (any device/dtype)."""
    resamp, new_zi = fir_resample(_mixed(extract, nco_i, nco_q), h, zi,
                                  up, down, gain=gain)
    rext = torch.cat([rrc_zi, resamp], dim=-1)
    return (_conv1d_valid(rext, rrc_h), new_zi,
            rext[..., -(len(rrc_h) - 1):].contiguous())


def resample_mul2_ref(extract, nco_i, nco_q, h, zi, up: int, down: int,
                      gain: float | None = None):
    """Plain PyTorch version of ``resample_mul2`` (any device/dtype): the
    materialized mixer followed by ``fir_resample``."""
    return fir_resample(_mixed(extract, nco_i, nco_q), h, zi, up, down,
                        gain=gain)


def resample_mul2_rrc(extract, nco_i, nco_q, h, zi, rrc_h, rrc_zi,
                      up: int, down: int, gain: float | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mixer + polyphase resampler + RRC in one kernel launch.

    Args:
      extract, nco_i, nco_q: (..., N) float32.
      h: (taps,) resampler filter at the rate ``fs * up``; zi: (..., 2,
        taps-1) upsampled-domain carry.
      rrc_h: (rtaps,) matched filter at the output rate; rrc_zi: (..., 2,
        rtaps-1) the previous block's last resampler outputs.

    Returns (rrc (..., 2, N*up/down), new_zi, new_rrc_zi).
    """
    if gain is None:
        gain = float(up)
    if not extract.is_cuda:
        return resample_mul2_rrc_ref(extract, nco_i, nco_q, h, zi, rrc_h,
                                     rrc_zi, up, down, gain)
    if extract.dim() < 1:
        raise ValueError(
            f"extract: expected (..., N), got {tuple(extract.shape)}")
    lead, n = tuple(extract.shape[:-1]), extract.shape[-1]
    c = math.prod(lead)
    if c < 1 or n < 1:
        raise ValueError(f"extract: empty input {tuple(extract.shape)}")
    if up < 1 or down < 1 or (n * up) % down:
        raise ValueError(
            f"resample_mul2_rrc: {n} samples x{up} do not divide by {down}")
    dev = extract.device
    taps, rtaps = len(h), len(rrc_h)
    m = n * up // down
    _cuda.check(extract, "extract", dtype=_F32)
    if n * up < taps - 1 or m < rtaps - 1:
        raise ValueError(
            f"resample_mul2_rrc: a block of {n} samples is shorter than "
            "the carried tails")
    _cuda.check(nco_i, "nco_i", (*lead, n), _F32, dev)
    _cuda.check(nco_q, "nco_q", (*lead, n), _F32, dev)
    _cuda.check(zi, "zi", (*lead, 2, taps - 1), _F32, dev)
    _cuda.check(rrc_zi, "rrc_zi", (*lead, 2, rtaps - 1), _F32, dev)
    rrc = torch.empty((*lead, 2, m), dtype=_F32, device=dev)
    new_rrc_zi = torch.empty_like(rrc_zi)
    new_zi = torch.empty_like(zi)
    _cuda.launch(
        "rtsdr_resample_rrc", "resample_rrc",
        _cuda.ptr(extract), _cuda.ptr(nco_i), _cuda.ptr(nco_q),
        _cuda.ptr(_taps_on([h], dev)), _cuda.ptr(zi),
        _cuda.ptr(_taps_on([rrc_h], dev)), _cuda.ptr(rrc_zi),
        _cuda.ptr(rrc), _cuda.ptr(new_rrc_zi), _cuda.ptr(new_zi),
        c, n, m, taps, up, down, rtaps, float(gain))
    return rrc, new_zi, new_rrc_zi


#: ``resample_mul2``'s kernel instances: launch-count name, ``split`` flag
#: (None: by the ratio, ``_AUTO_SPLIT``).
_MIX_IMPLS = {"auto": ("resample_mix", None),
              "pair": ("resample_mix.pair", 0),
              "split": ("resample_mix.split", 1)}
#: "auto"'s arm by (up, down): the faster on an H100 at the time-sharded
#: receivers' shapes (tools/torch_profile_resample.py, PERF.md): ``split``
#: at MODE1_RDS's x57/250, ``pair`` at MODE0's x19/80.  Only these two
#: ratios were measured; any other takes ``pair`` unmeasured.  A warp's
#: window reads (tests/test_torch_cuda_resample.py,
#: test_mix_window_spreads_banks) put at most 2 words per bank under
#: ``pair`` and 4 under ``split`` at x19/80, 4 under both at x57/250: a
#: candidate for the rule, not yet tested at a third ratio.
_AUTO_SPLIT = {(57, 250): 1}


def _segment_halo(extract, nco_i, nco_q, zi, t1: int, up: int):
    """The carried zi of each of the T stacked chunks (T, ..., 2, t1):
    chunk 0 the block's ``zi``, chunk s > 0 the zero-stuffed mixed tail of
    chunk s-1, in stock ops."""
    tails = resample_mul2_tail(extract[:-1], nco_i[:-1], nco_q[:-1], t1, up)
    return torch.cat([zi.unsqueeze(0).to(tails.dtype), tails], dim=0)


def resample_mul2_segments_ref(extract, nco_i, nco_q, h, zi, up: int,
                               down: int, gain: float | None = None):
    """Plain PyTorch version of ``resample_mul2(..., segments=T)``: the halo
    zis built with stock ops, then ``resample_mul2_ref`` over the stacked
    chunks; the new zi is the last chunk's."""
    y, new_zi = resample_mul2_ref(
        extract, nco_i, nco_q, h,
        _segment_halo(extract, nco_i, nco_q, zi, len(h) - 1, up),
        up, down, gain)
    return y, new_zi[-1]


def resample_mul2(extract, nco_i, nco_q, h, zi, up: int, down: int,
                  gain: float | None = None, impl: str = "auto",
                  segments: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused RDS mixer + rational resampler, one kernel launch.

    Equivalent to ``fir_resample(2*extract*stack([nco_i, nco_q]), h, zi,
    up, down, gain)``; the mixed streams never reach device memory.

    Args:
      extract, nco_i, nco_q: (..., N) float32.
      h: (taps,) filter at the rate ``fs * up``; zi: (..., 2, taps-1)
        upsampled-domain carry (arbitrary floats).
      impl: "auto" (the faster arm at the receiver's shapes), "pair" (a
        thread makes both branches' outputs from one tap read) or "split"
        (a thread per branch); the layout probe's arms,
        ``tools/torch_profile_resample.py``.  A CPU tensor runs the plain
        version either way.
      segments: T (the time-sharded receiver's form): the inputs are T
        consecutive chunks stacked along the first dimension, (T, ..., N),
        and ``zi`` is the carry of the first, (..., 2, taps-1).  Chunk s > 0
        reads the last ceil((taps-1)/up) inputs of chunk s-1 as its halo,
        in place; the new zi is the last chunk's.  Equal to
        ``resample_mul2_segments_ref``.

    Returns (y (..., 2, N*up/down), new_zi (..., 2, taps-1)); with
    segments, y is (T, ..., 2, M) and new_zi (..., 2, taps-1).
    """
    if impl not in _MIX_IMPLS:
        raise ValueError(f"resample_mul2: unknown impl {impl!r}")
    if gain is None:
        gain = float(up)
    if not extract.is_cuda:
        if segments is not None:
            return resample_mul2_segments_ref(extract, nco_i, nco_q, h, zi,
                                              up, down, gain)
        return resample_mul2_ref(extract, nco_i, nco_q, h, zi, up, down,
                                 gain)
    if extract.dim() < (1 if segments is None else 2):
        raise ValueError(
            f"extract: expected (..., N), got {tuple(extract.shape)}")
    lead, n = tuple(extract.shape[:-1]), extract.shape[-1]
    rows = math.prod(lead)
    if rows < 1 or n < 1:
        raise ValueError(f"extract: empty input {tuple(extract.shape)}")
    if up < 1 or down < 1 or (n * up) % down:
        raise ValueError(
            f"resample_mul2: {n} samples x{up} do not divide by {down}")
    taps = len(h)
    if n * up < taps - 1:      # then a chunk also holds its halo's inputs
        raise ValueError(
            f"resample_mul2: a block of {n} samples is shorter than the "
            "carried tail")
    zi_lead = lead
    if segments is not None:
        if lead[0] != segments:
            raise ValueError(f"extract: expected {segments} stacked chunks "
                             f"first, got {tuple(extract.shape)}")
        zi_lead = lead[1:]
    dev = extract.device
    _cuda.check(extract, "extract", dtype=_F32)
    _cuda.check(nco_i, "nco_i", (*lead, n), _F32, dev)
    _cuda.check(nco_q, "nco_q", (*lead, n), _F32, dev)
    _cuda.check(zi, "zi", (*zi_lead, 2, taps - 1), _F32, dev)
    m = n * up // down
    y = torch.empty((*lead, 2, m), dtype=_F32, device=dev)
    new_zi = torch.empty_like(zi)
    name, split = _MIX_IMPLS[impl]
    if split is None:
        split = _AUTO_SPLIT.get((up, down), 0)
    _cuda.launch(
        "rtsdr_resample_mix", name,
        _cuda.ptr(extract), _cuda.ptr(nco_i), _cuda.ptr(nco_q),
        _cuda.ptr(_taps_on([h], dev)), _cuda.ptr(zi), _cuda.ptr(y),
        _cuda.ptr(new_zi), rows, segments or 1, n, m, taps, up, down, split,
        float(gain))
    return y, new_zi
