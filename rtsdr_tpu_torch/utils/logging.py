"""Observability: gnuplot-compatible vector dumps and PSD logging
(counterpart of ``rtsdr_tpu/utils/logging.py``).

Replaces the reference logVector (src/logfunc.cpp:23-43) and its gnuplot
workflow (src/example.gnuplot): two-column ``<name>.dat`` files any plotting
tool reads.  The file is byte for byte the one the JAX package writes for
the same values; tensors on any device are fetched to the host first.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def log_vector(name: str, y, x=None, out_dir: str = "data") -> str:
    """Write x/y columns to ``<out_dir>/<name>.dat`` (gnuplot format)."""
    y = _host(y)
    if x is None:
        x = np.arange(len(y))
    x = _host(x)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.dat")
    with open(path, "w") as f:
        f.write(f"# {name}: {len(y)} samples\n")
        for xi, yi in zip(x, y):
            f.write(f"{xi}\t{yi:.9g}\n")
    return path


def log_psd(name: str, samples, nfft: int, fs: float,
            out_dir: str = "data") -> str:
    """Estimate (``ops/psd.py::estimate_psd``, on the samples' device) and
    dump a PSD for visual inspection (the reference's primary verification
    method)."""
    from rtsdr_tpu_torch.ops.psd import estimate_psd

    if not isinstance(samples, torch.Tensor):
        samples = torch.as_tensor(np.asarray(samples))
    freq, psd = estimate_psd(samples, nfft, fs)
    return log_vector(name, psd, freq, out_dir)
