"""FIR coefficient generators (own copy of ``rtsdr_tpu/ops/coeffs.py``).

These run once at configuration time on the host, so they are plain NumPy in
float64.  The low/band-pass designs reproduce ``scipy.signal.firwin(...,
window='hann')`` exactly, because the reference Python golden models — our
numerical fidelity target — use firwin (reference model/fmMonoBlock.py:43-45,
model/fmRDSblock.py:64-111).  We deliberately do NOT reproduce the reference
C++ generators (src/filter.cpp:19-60), whose center-tap convention diverges
from firwin (SURVEY.md §7 "quirks").

The RRC design follows reference model/fmRRC.py:12-47 (T_symbol=1/2375 s,
beta=0.90, the 1/T_symbol scale factor dropped).
"""

from __future__ import annotations

import math

import numpy as np


def _hann_symmetric(num_taps: int) -> np.ndarray:
    """Symmetric Hann window, as used by firwin(window='hann')."""
    n = np.arange(num_taps, dtype=np.float64)
    if num_taps == 1:
        return np.ones(1)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (num_taps - 1))


def _sinc_bands(num_taps: int, left: float, right: float) -> np.ndarray:
    """Ideal band-pass impulse response for normalized band [left, right].

    Frequencies normalized to Nyquist=1.  right*sinc(right*m) - left*sinc(left*m)
    evaluated at m = n - (num_taps-1)/2.
    """
    m = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    return right * np.sinc(right * m) - left * np.sinc(left * m)


def lowpass_taps(fs: float, fc: float, num_taps: int) -> np.ndarray:
    """Windowed-sinc LPF identical to firwin(num_taps, fc/(fs/2), window='hann').

    Scaled for unit DC gain (firwin's scale=True at frequency 0).
    """
    cutoff = fc / (fs / 2.0)
    h = _sinc_bands(num_taps, 0.0, cutoff) * _hann_symmetric(num_taps)
    return h / np.sum(h)


def bandpass_taps(fs: float, f_lo: float, f_hi: float, num_taps: int) -> np.ndarray:
    """Windowed-sinc BPF identical to firwin(..., pass_zero='bandpass').

    Scaled for unit gain at the band center (firwin's scale frequency).
    """
    lo = f_lo / (fs / 2.0)
    hi = f_hi / (fs / 2.0)
    h = _sinc_bands(num_taps, lo, hi) * _hann_symmetric(num_taps)
    m = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    center = 0.5 * (lo + hi)
    scale = np.sum(h * np.cos(np.pi * m * center))
    return h / scale


def rrc_taps(fs: float, num_taps: int, beta: float = 0.90,
             symbol_rate: float = 2375.0) -> np.ndarray:
    """Root-raised-cosine matched filter (reference model/fmRRC.py:12-47).

    Note the reference's center convention is ``k - num_taps/2`` (integer
    division by float), not ``(num_taps-1)/2``; we keep it for parity with
    the golden model.
    """
    t_sym = 1.0 / symbol_rate
    h = np.empty(num_taps, dtype=np.float64)
    for k in range(num_taps):
        t = (k - num_taps / 2.0) / fs
        if t == 0.0:
            h[k] = 1.0 + beta * (4.0 / math.pi - 1.0)
        elif abs(abs(t) - t_sym / (4.0 * beta)) < 1e-18:
            h[k] = (beta / np.sqrt(2.0)) * (
                (1.0 + 2.0 / math.pi) * math.sin(math.pi / (4.0 * beta))
                + (1.0 - 2.0 / math.pi) * math.cos(math.pi / (4.0 * beta))
            )
        else:
            num = (
                math.sin(math.pi * t * (1.0 - beta) / t_sym)
                + 4.0 * beta * (t / t_sym) * math.cos(math.pi * t * (1.0 + beta) / t_sym)
            )
            den = (
                math.pi
                * t
                * (1.0 - (4.0 * beta * t / t_sym) ** 2)
                / t_sym
            )
            h[k] = num / den
    return h
