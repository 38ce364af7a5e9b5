"""Bartlett-method PSD estimation (counterpart of ``rtsdr_tpu/ops/psd.py``):
a batched ``torch.fft.rfft`` in place of the reference's O(N^2) DFT.

Numerics match the golden model: Hann window ``sin^2(pi*i/NFFT)`` (the
model's periodic-style window), per-segment ``|FFT|^2 * 2 / (Fs * NFFT/2)``,
dB, then segment-average.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def psd_freqs(nfft: int, fs: float) -> np.ndarray:
    """The frequency grid of ``estimate_psd``'s bins (host numpy)."""
    return np.arange(0, fs / 2.0, fs / nfft)[: nfft // 2]


def estimate_psd(samples: torch.Tensor, nfft: int, fs: float,
                 eps: float = 1e-30) -> tuple[np.ndarray, torch.Tensor]:
    """Bartlett PSD estimate.

    Args:
      samples: (..., N) real signal; N is truncated to a multiple of nfft.
      nfft: number of frequency bins (segment length).
      fs: sampling rate.

    Returns:
      freq: (nfft//2,) positive frequency bins (host numpy, for plotting).
      psd:  (..., nfft//2) averaged PSD in dB.
    """
    n = samples.shape[-1]
    num_segments = n // nfft
    x = samples[..., : num_segments * nfft]
    segs = x.reshape(*x.shape[:-1], num_segments, nfft)

    i = torch.arange(nfft, dtype=samples.dtype, device=samples.device)
    hann = torch.sin(i * (math.pi / nfft)) ** 2

    spec = torch.fft.rfft(segs * hann, n=nfft, dim=-1)[..., : nfft // 2]
    power = (2.0 / (fs * nfft / 2.0)) * spec.abs() ** 2
    db = 10.0 * torch.log10(power + eps)
    return psd_freqs(nfft, fs), db.mean(dim=-2)
