"""Spectrum utilities (counterpart of ``rtsdr_tpu/ops/fourier.py``; the
reference's O(N^2) DFT and magnitude helper, src/fourier.cpp:15-33).

Both are thin wrappers over ``torch.fft`` on the input's own device, kept
for API parity and for the PSD / observability path.  No kernel of the
port is involved.
"""

from __future__ import annotations

import torch


def dft(x: torch.Tensor) -> torch.Tensor:
    """Full complex DFT of a real or complex signal over the last axis
    (replaces the O(N^2) loop at src/fourier.cpp:15-23 with an FFT)."""
    return torch.fft.fft(x, dim=-1)


def magnitude(spectrum: torch.Tensor, normalize: bool = True
              ) -> torch.Tensor:
    """|X| per bin, optionally 1/N-normalized (src/fourier.cpp:26-33)."""
    mag = spectrum.abs()
    if normalize:
        mag = mag / spectrum.shape[-1]
    return mag
