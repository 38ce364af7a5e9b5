"""ctypes bindings for the native host runtime (librtsdr_runtime.so); own
copy of ``rtsdr_tpu/runtime``.

Builds the shared library on first use when it is missing or older than
``ingest.cpp`` (g++ via make); every function has a pure-NumPy fallback so
the framework works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import stat
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "librtsdr_runtime.so")
_lib = None
_build_failed = False


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    try:
        # make rebuilds the library when it is missing or older than
        # ingest.cpp, and leaves it alone otherwise
        subprocess.run(["make", "-C", _DIR], check=True,
                       capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        pass    # no toolchain: a library built before, else NumPy
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        _build_failed = True
        return None
    lib.rtsdr_deinterleave_normalize.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    lib.rtsdr_normalize_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.rtsdr_emit_int16_interleave.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
        ctypes.c_void_p]
    lib.rtsdr_reader_create.argtypes = [ctypes.c_int, ctypes.c_int64,
                                        ctypes.c_int]
    lib.rtsdr_reader_create.restype = ctypes.c_void_p
    lib.rtsdr_reader_acquire.argtypes = [ctypes.c_void_p]
    lib.rtsdr_reader_acquire.restype = ctypes.c_int
    lib.rtsdr_reader_slot.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rtsdr_reader_slot.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.rtsdr_reader_ready.argtypes = [ctypes.c_void_p]
    lib.rtsdr_reader_ready.restype = ctypes.c_int
    lib.rtsdr_reader_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rtsdr_reader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def have_native() -> bool:
    return _load() is not None


def deinterleave_normalize(raw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint8 interleaved IQ -> (i, q) float32 in [-1, 1)."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    n = raw.size // 2
    lib = _load()
    if lib is None:
        x = (raw.astype(np.float32) - 128.0) / 128.0
        return x[0::2].copy(), x[1::2].copy()
    i = np.empty(n, np.float32)
    q = np.empty(n, np.float32)
    lib.rtsdr_deinterleave_normalize(
        raw.ctypes.data, n, i.ctypes.data, q.ctypes.data)
    return i, q


def emit_int16_interleave(left: np.ndarray, right: np.ndarray,
                          scale: float = 16384.0) -> np.ndarray:
    """float L/R -> interleaved int16 with NaN guard (reference
    src/fm_radio.cpp:286-302)."""
    left = np.ascontiguousarray(left, dtype=np.float32)
    right = np.ascontiguousarray(right, dtype=np.float32)
    n = left.size
    lib = _load()
    if lib is None:
        l = np.nan_to_num(left, nan=0.0) * scale
        r = np.nan_to_num(right, nan=0.0) * scale
        out = np.empty(2 * n, np.int16)
        out[0::2] = np.clip(l, -32768, 32767).astype(np.int16)
        out[1::2] = np.clip(r, -32768, 32767).astype(np.int16)
        return out
    out = np.empty(2 * n, np.int16)
    lib.rtsdr_emit_int16_interleave(
        left.ctypes.data, right.ctypes.data, n, float(scale), out.ctypes.data)
    return out


class BlockReader:
    """Prefetching fixed-size block reader over a file descriptor.

    Producer thread + bounded slot pool in C++; ``read_block()`` returns a
    numpy view copy of the next block or None at EOF.
    """

    def __init__(self, fd: int, block_size: int, n_slots: int = 4):
        self._lib = _load()
        self.block_size = block_size
        # a regular file's next block waits on no writer
        self._regular = stat.S_ISREG(os.fstat(fd).st_mode)
        if self._lib is None:
            self._file = os.fdopen(os.dup(fd), "rb", buffering=0)
            self._h = None
            return
        self._h = self._lib.rtsdr_reader_create(fd, block_size, n_slots)

    def _read_exact(self) -> bytes | None:
        """Fallback full-block read: FileIO.read issues ONE os.read, and
        a pipe returns only what is currently buffered — a short read
        mid-stream is NOT EOF (the C++ producer loops the same way,
        ingest.cpp).  Loop until the block is full or the stream ends;
        a partial trailing block is dropped, matching the reference
        (src/iofunc.cpp:61-69 via cin.read + gcount)."""
        parts = bytearray()
        while len(parts) < self.block_size:
            chunk = self._file.read(self.block_size - len(parts))
            if not chunk:
                return None
            parts.extend(chunk)
        return bytes(parts)

    def read_block(self):
        if self._h is None:  # numpy fallback: blocking read
            buf = self._read_exact()
            if buf is None:
                return None
            return np.frombuffer(buf, np.uint8)
        slot = self._lib.rtsdr_reader_acquire(self._h)
        if slot < 0:
            return None
        ptr = self._lib.rtsdr_reader_slot(self._h, slot)
        block = np.ctypeslib.as_array(ptr, shape=(self.block_size,)).copy()
        self._lib.rtsdr_reader_release(self._h, slot)
        return block

    def read_block_into(self, dst: np.ndarray) -> bool:
        """Copy the next block into ``dst`` (shape (block_size,), uint8)
        without an intermediate allocation; False at EOF.  This is the
        multi-fd batch path: N readers fill the rows of one (N, bs)
        staging array that becomes a single device transfer."""
        assert dst.nbytes == self.block_size and dst.flags["C_CONTIGUOUS"]
        if self._h is None:
            buf = self._read_exact()
            if buf is None:
                return False
            dst[:] = np.frombuffer(buf, np.uint8)
            return True
        slot = self._lib.rtsdr_reader_acquire(self._h)
        if slot < 0:
            return False
        ptr = self._lib.rtsdr_reader_slot(self._h, slot)
        ctypes.memmove(dst.ctypes.data, ptr, self.block_size)
        self._lib.rtsdr_reader_release(self._h, slot)
        return True

    def ready(self) -> int:
        """Whole blocks the next read takes without waiting on a writer,
        asked without waiting: the blocks read ahead (a block still
        arriving does not count), -1 once the stream has ended and none
        is left.  Over a regular file at least 1 until then: its next
        block is there to read.  Without the native library: 1 over a
        regular file, 0 over a pipe, a FIFO or a terminal, and never -1:
        it does not look ahead for the end."""
        if self._h is None:
            return int(self._regular)
        n = self._lib.rtsdr_reader_ready(self._h)
        return 1 if n == 0 and self._regular else n

    def close(self):
        if self._h is not None:
            self._lib.rtsdr_reader_destroy(self._h)
            self._h = None
        elif getattr(self, "_file", None) is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
