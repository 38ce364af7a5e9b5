"""WAV artifact writer (the golden models' listening-test output,
model/fmMonoBlock.py:250-255) — stdlib only (counterpart of
``rtsdr_tpu/io/wav.py``)."""

from __future__ import annotations

import wave

import numpy as np

from rtsdr_tpu_torch.runtime import emit_int16_interleave


def write_wav(path: str, left: np.ndarray, right: np.ndarray | None = None,
              fs: int = 48000, scale: float = 32767.0) -> None:
    """Write float [-1, 1] audio to a 16-bit PCM wav (mono or stereo)."""
    if right is None:
        data = np.clip(np.nan_to_num(left) * scale, -32768, 32767).astype(
            np.int16)
        n_ch = 1
    else:
        data = emit_int16_interleave(left, right, scale)
        n_ch = 2
    with wave.open(path, "wb") as w:
        w.setnchannels(n_ch)
        w.setsampwidth(2)
        w.setframerate(fs)
        w.writeframes(data.tobytes())


class WavStreamWriter:
    """Incremental 16-bit PCM wav writer: frames are flushed per block and
    the header is patched on close, so memory stays O(block) on unbounded
    streams (live radio)."""

    def __init__(self, path: str, fs: int = 48000, n_channels: int = 2):
        self._w = wave.open(path, "wb")
        self._w.setnchannels(n_channels)
        self._w.setsampwidth(2)
        self._w.setframerate(fs)

    def write_int16_bytes(self, data: bytes) -> None:
        """Append already-interleaved int16 PCM bytes."""
        self._w.writeframes(data)

    def write_float(self, left: np.ndarray, right: np.ndarray,
                    scale: float = 32767.0) -> None:
        """Append float [-1, 1] stereo samples."""
        self._w.writeframes(emit_int16_interleave(left, right, scale).tobytes())

    def close(self) -> None:
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
