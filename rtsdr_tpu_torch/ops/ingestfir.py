"""Fused ingest + RF front end on the hand-written CUDA kernel
``csrc/ingest.cu``: uint8 interleaved IQ -> decimated IF -> FM
discriminator -> audio low-pass (-> IF band-pass bank).

Counterpart of ``rtsdr_tpu/ops/ingestfir.py``: ``ingest_fir_decimate``,
``ingest_fir_demod`` and ``ingest_fir_demod_audio`` (with and without its
``bank_h`` band-pass stage) are four entry points over one device routine that consumes the *raw interleaved uint8* stream
directly — the (b-128)/128 conversion folds into the filter, and neither
float copies of the RF-rate stream nor (with ``emit_fm=False``) the
demodulated stream ever reach device memory.

What the kernel replaces, what bounds it on an H100 and what its design
does about that is in the note at the top of ``csrc/ingest.cu``.  Any
``C >= 1`` is taken; block lengths need only divide by the decimations.

On a CUDA tensor the wrappers launch the kernel or raise; on a CPU tensor
they run the plain versions (``*_ref``: normalize/deinterleave +
``ops.fir`` + ``ops.demod``), which are also what the kernel is compared
with on the card.
"""

from __future__ import annotations

import math

import torch

from rtsdr_tpu_torch.ops import _cuda
from rtsdr_tpu_torch.ops.cuda_fir import _taps_on
from rtsdr_tpu_torch.ops.demod import fm_discriminator
from rtsdr_tpu_torch.ops.fir import _conv1d_valid

_F32 = torch.float32


def normalize_deinterleave(raw_u8: torch.Tensor, dtype=_F32) -> torch.Tensor:
    """(..., 2N) interleaved uint8 -> (..., 2, N) float I/Q, (b-128)/128."""
    pairs = raw_u8.reshape(*raw_u8.shape[:-1], -1, 2)
    return (pairs.transpose(-1, -2).to(dtype) - 128.0) * (1.0 / 128.0)


def _decimate_ref(x, h, zi, decim):
    xext = torch.cat([zi, x], dim=-1)
    return _conv1d_valid(xext, h, decim), xext[..., -(len(h) - 1):]


def ingest_fir_decimate_ref(raw_u8, h, zi_i, zi_q, decim: int,
                            segments: int | None = None):
    """Plain PyTorch version of ``ingest_fir_decimate``."""
    zi = torch.stack([zi_i, zi_q], dim=-2)
    if segments is not None:
        # (S, ..., 2N): segment s > 0 reads the preceding segment's tail
        # where segment 0 reads the zero level; the zi adds to both
        t1 = len(h) - 1
        _segment_pairs(raw_u8, segments, t1)
        raw_u8 = raw_u8.reshape(*raw_u8.shape[:-1], segments, -1)
        raw_u8 = raw_u8.movedim(-2, 0)
        tails = normalize_deinterleave(raw_u8[:-1, ..., -2 * t1:], zi.dtype)
        zi = zi + torch.cat([torch.zeros_like(zi[:1]), tails])
    iq = normalize_deinterleave(raw_u8, zi_i.dtype)
    y, new_zi = _decimate_ref(iq, h, zi, decim)
    return (y[..., 0, :], y[..., 1, :],
            new_zi[..., 0, :].contiguous(), new_zi[..., 1, :].contiguous())


def ingest_fir_demod_ref(raw_u8, h, zi_i, zi_q, prev_i, prev_q, decim: int):
    """Plain PyTorch version of ``ingest_fir_demod``."""
    y_i, y_q, zi_i_n, zi_q_n = ingest_fir_decimate_ref(
        raw_u8, h, zi_i, zi_q, decim)
    fm, (pi, pq) = fm_discriminator(y_i, y_q, (prev_i, prev_q))
    return fm, zi_i_n, zi_q_n, pi.clone(), pq.clone()


def ingest_fir_demod_audio_ref(raw_u8, h, zi_i, zi_q, prev_i, prev_q,
                               decim: int, audio_h, audio_zi,
                               audio_down: int, emit_fm: bool = True,
                               bank_h=None, bank_zi=None):
    """Plain PyTorch version of ``ingest_fir_demod_audio``."""
    fm, zi_i_n, zi_q_n, pi, pq = ingest_fir_demod_ref(
        raw_u8, h, zi_i, zi_q, prev_i, prev_q, decim)
    audio, audio_zi_n = _decimate_ref(fm, audio_h, audio_zi, audio_down)
    base = (fm if emit_fm else None, audio, zi_i_n, zi_q_n, pi, pq,
            audio_zi_n.contiguous())
    if bank_h is None:
        return base
    bext = torch.cat([bank_zi, fm], dim=-1)
    return (*base, tuple(_conv1d_valid(bext, bh) for bh in bank_h))


def _segment_pairs(raw_u8, segments: int, t1: int) -> int:
    """Pairs per segment; a segment must hold a whole carried tail."""
    n_raw = raw_u8.shape[-1]
    if segments < 1 or n_raw % (2 * segments):
        raise ValueError(f"raw_u8: {n_raw} bytes do not split into "
                         f"{segments} segments of whole pairs")
    n_pairs = n_raw // (2 * segments)
    if segments > 1 and n_pairs < t1:
        raise ValueError(
            f"ingest_fir_decimate: segments of {n_pairs} pairs are fewer "
            f"than the {t1}-sample carried tail")
    return n_pairs


def _check_common(raw_u8, h, zi_i, zi_q, decim, segments=None):
    if raw_u8.dim() < 1:
        raise ValueError(
            f"raw_u8: expected (..., 2N), got {tuple(raw_u8.shape)}")
    _cuda.check(raw_u8, "raw_u8", dtype=torch.uint8)
    lead, n_raw = tuple(raw_u8.shape[:-1]), raw_u8.shape[-1]
    if segments is not None:
        lead = (segments, *lead)
        n_raw = 2 * _segment_pairs(raw_u8, segments, len(h) - 1)
    if n_raw % 2 or (n_raw // 2) % decim:
        raise ValueError(
            f"raw_u8: {n_raw} bytes is not a whole number of {decim}-pair "
            "decimation groups")
    if raw_u8.data_ptr() % 2:
        raise ValueError("raw_u8: must start at an even address")
    dev = raw_u8.device
    t1 = len(h) - 1
    _cuda.check(zi_i, "zi_i", (*lead, t1), _F32, dev)
    _cuda.check(zi_q, "zi_q", (*lead, t1), _F32, dev)
    return lead, math.prod(lead), n_raw // 2, dev


def _new(shape, dev):
    return torch.empty(shape, dtype=_F32, device=dev)


def ingest_fir_decimate(raw_u8: torch.Tensor, h, zi_i, zi_q, decim: int,
                        segments: int | None = None):
    """uint8 (..., 2N) interleaved IQ -> ((..., M) i, (..., M) q, new zis).

    Exactly ``fir_decimate(normalize(deinterleave(raw)), h, zi, decim)``
    for both I and Q, M = N/decim.

    ``segments=S`` (the time-sharded receiver's form): each raw row is S
    consecutive segments of 2N' bytes, each filtered as a block of its own
    with a segment axis first: zi and outputs are (S, ..., taps-1) and
    (S, ..., N'/decim).  Segment s > 0 reads the preceding segment's bytes
    as its left halo where segment 0 reads the zero level, and zi adds to
    every segment (zeros for s > 0 make it the serial filter over the whole
    row).  The kernel reads every segment and its halo in place.
    """
    if not raw_u8.is_cuda:
        return ingest_fir_decimate_ref(raw_u8, h, zi_i, zi_q, decim, segments)
    lead, c, n_pairs, dev = _check_common(raw_u8, h, zi_i, zi_q, decim,
                                          segments)
    m = n_pairs // decim
    y_i, y_q = _new((*lead, m), dev), _new((*lead, m), dev)
    zi_i_n, zi_q_n = torch.empty_like(zi_i), torch.empty_like(zi_q)
    _cuda.launch(
        "rtsdr_ingest_iq", "ingest.iq",
        _cuda.ptr(raw_u8), _cuda.ptr(_taps_on([h], dev)), _cuda.ptr(zi_i),
        _cuda.ptr(zi_q), _cuda.ptr(y_i), _cuda.ptr(y_q), _cuda.ptr(zi_i_n),
        _cuda.ptr(zi_q_n), c, n_pairs, len(h), decim, segments or 1)
    return y_i, y_q, zi_i_n, zi_q_n


def ingest_fir_demod(raw_u8: torch.Tensor, h, zi_i, zi_q, prev_i, prev_q,
                     decim: int):
    """Fused uint8 ingest + RF FIR + exact FM discriminator.

    Semantics: ``fm_discriminator(*ingest_fir_decimate(raw, h, zi, decim)
    [:2], (prev_i, prev_q))`` — but the decimated I/Q streams never reach
    device memory.  Returns (fm, new_zi_i, new_zi_q, new_prev_i,
    new_prev_q).
    """
    if not raw_u8.is_cuda:
        return ingest_fir_demod_ref(raw_u8, h, zi_i, zi_q, prev_i, prev_q,
                                    decim)
    lead, c, n_pairs, dev = _check_common(raw_u8, h, zi_i, zi_q, decim)
    _cuda.check(prev_i, "prev_i", lead, _F32, dev)
    _cuda.check(prev_q, "prev_q", lead, _F32, dev)
    fm = _new((*lead, n_pairs // decim), dev)
    zi_i_n, zi_q_n = torch.empty_like(zi_i), torch.empty_like(zi_q)
    pi, pq = torch.empty_like(prev_i), torch.empty_like(prev_q)
    _cuda.launch(
        "rtsdr_ingest_fm", "ingest.fm",
        _cuda.ptr(raw_u8), _cuda.ptr(_taps_on([h], dev)), _cuda.ptr(zi_i),
        _cuda.ptr(zi_q), _cuda.ptr(prev_i), _cuda.ptr(prev_q), _cuda.ptr(fm),
        _cuda.ptr(zi_i_n), _cuda.ptr(zi_q_n), _cuda.ptr(pi), _cuda.ptr(pq),
        c, n_pairs, len(h), decim)
    return fm, zi_i_n, zi_q_n, pi, pq


def ingest_fir_demod_audio(raw_u8: torch.Tensor, h, zi_i, zi_q, prev_i,
                           prev_q, decim: int, audio_h, audio_zi,
                           audio_down: int, emit_fm: bool = True,
                           bank_h=None, bank_zi=None):
    """``ingest_fir_demod`` + the audio LPF↓down fused behind it.

    Semantics: ``fm, ... = ingest_fir_demod(...)`` then ``audio,
    new_audio_zi = fir_decimate(fm, audio_h, audio_zi, audio_down)``.  With
    ``emit_fm=False`` (mono-only receiver) the demodulated stream is never
    written: the kernel emits only the audio and the carried fm tail.

    ``bank_h`` (optional list of 1..3 stride-1 filters of one length, at
    most the audio filter's): the IF band-pass bank (pilot / stereo channel
    / RDS extract) as a further stage over the same in-kernel fm —
    equivalent to ``fir_block_bank(fm, bank_h, bank_zi)``, ``bank_zi`` being
    the shared (..., taps-1) carried fm tail.  With ``emit_fm=False`` the
    demodulated stream then reaches all its consumers without touching
    device memory; the new ``audio_zi`` (the last fm samples) is what they
    take for their own carried tails.

    Returns (fm | None, audio, new_zi_i, new_zi_q, new_prev_i, new_prev_q,
    new_audio_zi[, bank outputs tuple]).
    """
    if (bank_h is None) != (bank_zi is None):
        raise ValueError("bank_h and bank_zi go together")
    if not raw_u8.is_cuda:
        return ingest_fir_demod_audio_ref(
            raw_u8, h, zi_i, zi_q, prev_i, prev_q, decim, audio_h, audio_zi,
            audio_down, emit_fm, bank_h, bank_zi)
    lead, c, n_pairs, dev = _check_common(raw_u8, h, zi_i, zi_q, decim)
    m = n_pairs // decim
    if m % audio_down:
        raise ValueError(
            f"{m} IF samples do not divide by the audio decimation "
            f"{audio_down}")
    ataps = len(audio_h)
    _cuda.check(prev_i, "prev_i", lead, _F32, dev)
    _cuda.check(prev_q, "prev_q", lead, _F32, dev)
    _cuda.check(audio_zi, "audio_zi", (*lead, ataps - 1), _F32, dev)
    fm = _new((*lead, m), dev) if emit_fm else None
    audio = _new((*lead, m // audio_down), dev)
    zi_i_n, zi_q_n = torch.empty_like(zi_i), torch.empty_like(zi_q)
    pi, pq = torch.empty_like(prev_i), torch.empty_like(prev_q)
    audio_zi_n = torch.empty_like(audio_zi)
    if bank_h is not None:
        n_bank, btaps = len(bank_h), len(bank_h[0])
        if (not 1 <= n_bank <= 3 or btaps > ataps
                or any(len(bh) != btaps for bh in bank_h)):
            raise ValueError(
                "bank_h takes 1..3 filters of one length, at most the audio "
                f"filter's {ataps} taps")
        _cuda.check(bank_zi, "bank_zi", (*lead, btaps - 1), _F32, dev)
        bank = _new((n_bank, *lead, m), dev)
        _cuda.launch(
            "rtsdr_ingest_fm_audio_bank", "ingest.fm_audio_bank",
            _cuda.ptr(raw_u8), _cuda.ptr(_taps_on([h], dev)),
            _cuda.ptr(zi_i), _cuda.ptr(zi_q), _cuda.ptr(prev_i),
            _cuda.ptr(prev_q), _cuda.ptr(_taps_on([audio_h], dev)),
            _cuda.ptr(audio_zi), _cuda.ptr(_taps_on(bank_h, dev)),
            _cuda.ptr(bank_zi), _cuda.ptr(fm), _cuda.ptr(audio),
            _cuda.ptr(bank), _cuda.ptr(zi_i_n), _cuda.ptr(zi_q_n),
            _cuda.ptr(pi), _cuda.ptr(pq), _cuda.ptr(audio_zi_n),
            c, n_pairs, len(h), decim, ataps, audio_down, n_bank, btaps)
        return (fm, audio, zi_i_n, zi_q_n, pi, pq, audio_zi_n,
                tuple(bank.unbind(0)))
    _cuda.launch(
        "rtsdr_ingest_fm_audio", "ingest.fm_audio",
        _cuda.ptr(raw_u8), _cuda.ptr(_taps_on([h], dev)), _cuda.ptr(zi_i),
        _cuda.ptr(zi_q), _cuda.ptr(prev_i), _cuda.ptr(prev_q),
        _cuda.ptr(_taps_on([audio_h], dev)), _cuda.ptr(audio_zi),
        _cuda.ptr(fm), _cuda.ptr(audio), _cuda.ptr(zi_i_n), _cuda.ptr(zi_q_n),
        _cuda.ptr(pi), _cuda.ptr(pq), _cuda.ptr(audio_zi_n),
        c, n_pairs, len(h), decim, ataps, audio_down)
    return fm, audio, zi_i_n, zi_q_n, pi, pq, audio_zi_n
