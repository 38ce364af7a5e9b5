"""Raw binary sample file I/O (reference src/iofunc.cpp:31-59; own copy
of ``rtsdr_tpu/io/binio.py``).

float32 raw read/write for captured IQ / intermediate dumps, plus the
uint8 capture loader used by the RDS models (model/fmRDSblock.py:58-59).
"""

from __future__ import annotations

import numpy as np


def read_f32(path: str) -> np.ndarray:
    """Read a float32 raw file (readBinData, src/iofunc.cpp:31-47)."""
    return np.fromfile(path, dtype=np.float32)


def write_f32(path: str, samples) -> None:
    """Write float32 raw (writeBinData, src/iofunc.cpp:50-59)."""
    np.asarray(samples, dtype=np.float32).tofile(path)


def read_iq_u8(path: str, normalize: bool = False) -> np.ndarray:
    """Read a uint8 interleaved IQ capture; optionally (x-128)/128
    normalized (model/fmRDSblock.py:58-59)."""
    raw = np.fromfile(path, dtype=np.uint8)
    if normalize:
        return (raw.astype(np.float32) - 128.0) / 128.0
    return raw
