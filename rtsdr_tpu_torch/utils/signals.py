"""Test-signal generators (reference src/genfunc.cpp:13-41, used for kernel
bring-up in the labs) plus an FM multiplex synthesizer for end-to-end
self-test without recorded captures (own copy of
``rtsdr_tpu/utils/signals.py``)."""

from __future__ import annotations

import numpy as np


def generate_sin(fs: float, freq: float, n: int, amplitude: float = 1.0,
                 phase: float = 0.0) -> np.ndarray:
    """Sine generator (reference generateSin, src/genfunc.cpp:13-21)."""
    t = np.arange(n) / fs
    return amplitude * np.sin(2 * np.pi * freq * t + phase)


def mix_sin(*signals: np.ndarray) -> np.ndarray:
    """Sum of equal-length sines, normalized by count (reference mixSin,
    src/genfunc.cpp:23-31)."""
    return np.sum(signals, axis=0) / len(signals)


def random_samples(n: int, max_value: float = 10.0, seed: int = 0) -> np.ndarray:
    """Uniform random test samples (reference generateRandomSamples,
    src/genfunc.cpp:33-41)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-max_value, max_value, n)


def fm_multiplex_iq(
    n_pairs: int,
    rf_fs: float = 2.4e6,
    mono_hz: float = 1.1e3,
    stereo_hz: float = 2.3e3,
    pilot_amp: float = 0.1,
    mono_amp: float = 0.45,
    stereo_amp: float = 0.45,
    deviation: float = 75e3,
    pilot_phase: float = 0.0,
) -> np.ndarray:
    """Interleaved uint8 IQ of a synthetic FM stereo station (no RDS).

    multiplex = mono tone + 19 kHz pilot + (L-R tone) DSB-SC on 38 kHz.
    """
    t = np.arange(n_pairs) / rf_fs
    pilot_arg = 2 * np.pi * 19e3 * t + pilot_phase
    m = (mono_amp * np.sin(2 * np.pi * mono_hz * t)
         + pilot_amp * np.cos(pilot_arg)
         + stereo_amp * np.sin(2 * np.pi * stereo_hz * t) * np.cos(2 * pilot_arg))
    phase = 2 * np.pi * deviation * np.cumsum(m) / rf_fs
    iq = np.empty(2 * n_pairs)
    iq[0::2] = np.cos(phase)
    iq[1::2] = np.sin(phase)
    return np.clip(np.round(iq * 100.0 + 128.0), 0, 255).astype(np.uint8)
