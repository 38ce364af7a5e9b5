"""Device resolution shared by every ``*_init`` / ``make_*`` entry point."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when a CUDA device is asked
    for (the default) and none is present.  The CPU is used only when the
    caller names it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rtsdr_tpu_torch: no CUDA GPU is available (torch.cuda."
            "is_available() is False); pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


def require_kernel_dtype(device: torch.device, dtype) -> None:
    """The CUDA kernels are float32: raise when a pipeline is built for a
    CUDA device in another dtype, instead of letting any stage run as plain
    PyTorch on the card.  float64 is the CPU-only oracle path."""
    if device.type == "cuda" and dtype != torch.float32:
        raise TypeError(
            f"rtsdr_tpu_torch: dtype {dtype} on {device}: the CUDA kernels "
            "are float32 only; other dtypes run on device='cpu' (the plain "
            "PyTorch versions)")
