"""Build, load and count the hand-written CUDA kernels.

The sources under ``rtsdr_tpu_torch/csrc`` have a plain C interface (no
PyTorch headers), so ``nvcc`` needs seconds.  At first use each ``*.cu`` is
compiled to an object file, all compilers started together, and the
objects are linked into ONE shared library under ``rtsdr_tpu_torch/build``
(git-ignored), named by a hash of the sources so an edited source is
rebuilt.  The library is loaded with ``ctypes``; every pointer and the
stream are declared ``c_void_p`` (an undeclared Python int would be cut to
32 bits).

Each C entry point launches on the stream it is given, allocates nothing,
does not synchronise and returns ``cudaGetLastError()``; ``launch`` raises
when that is not 0 and otherwise adds one to the kernel's launch count.
The one other place a count changes is ``add_launches``: a replayed CUDA
graph adds the launches its capture recorded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("ingest.cu", "fir_bank.cu", "pll.cu", "resample_rrc.cu",
           "channelizer.cu", "sync_walk.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # raw, rf_h, zi_i, zi_q, out_i, out_q, zi_i_out, zi_q_out,
    # C (output rows), n_pairs, taps, decim, n_seg (segments per raw row),
    # stream
    "rtsdr_ingest_iq": [_P] * 8 + [_I] * 5 + [_P],
    # raw, rf_h, zi_i, zi_q, prev_i, prev_q, fm, zi_i_out, zi_q_out,
    # prev_i_out, prev_q_out, C, n_pairs, taps, decim, stream
    "rtsdr_ingest_fm": [_P] * 11 + [_I] * 4 + [_P],
    # raw, rf_h, zi_i, zi_q, prev_i, prev_q, audio_h, audio_zi, fm (or
    # NULL), audio, zi_i_out, zi_q_out, prev_i_out, prev_q_out,
    # audio_zi_out, C, n_pairs, taps, decim, audio_taps, down, stream
    "rtsdr_ingest_fm_audio": [_P] * 15 + [_I] * 6 + [_P],
    # raw, rf_h, zi_i, zi_q, prev_i, prev_q, audio_h, audio_zi, bank_h,
    # bank_zi, fm (or NULL), audio, bank, zi_i_out, zi_q_out, prev_i_out,
    # prev_q_out, audio_zi_out, C, n_pairs, taps, decim, audio_taps, down,
    # n_bank, bank_taps, stream
    "rtsdr_ingest_fm_audio_bank": [_P] * 18 + [_I] * 8 + [_P],
    # x, x2 (or NULL), zi (or NULL), phase taps (F, stride, q_pad), y,
    # zi_out (or NULL), C, N, M, taps, F, stride, pre, stream
    "rtsdr_fir_bank": [_P] * 6 + [_I] * 7 + [_P],
    # parts (host array of pointers), part_lanes (host array of ints),
    # n_parts, consts (5, C), st_in (7, C), st_out (7, C), nco_i, nco_q,
    # C, N, loop_div, delay_output, stream
    "rtsdr_pll": [_P, _P, _I] + [_P] * 5 + [_I] * 4 + [_P],
    # e, nco_i, nco_q, h, zi, rrc_h, rrc_zi, y, rrc_zi_out, zi_out, C, N, M,
    # taps, up, down, rrc_taps, gain, stream
    "rtsdr_resample_rrc": [_P] * 10 + [_I] * 7 + [_F, _P],
    # e, nco_i, nco_q, h, zi, y, zi_out, rows, segments, N, M, taps, up,
    # down, split, gain, stream
    "rtsdr_resample_mix": [_P] * 7 + [_I] * 8 + [_F, _P],
    # raw, zi, proto, twiddle, shared list, own taps, own list, y, zi_out,
    # B, n_pairs, K, taps, d, a_sp, P, tile, n_tiles, nb, pitch, n_sh,
    # n_own, own_lanes, n_og, ns_sh, ns_own, g_sh, g_own, plane_elems, smem,
    # stream
    "rtsdr_channelize_composed": [_P] * 9 + [_I] * 21 + [_P],
    # raw, zi, stage A taps, stage B taps, twiddle, each station's slot,
    # NCO phase and ramp (or NULL), y, zi_out, B, n_pairs, K, S, taps,
    # decim, P, tile, n_tiles, ns, pitch_a, a_elems, bp, kp, smem, stream
    "rtsdr_channelize_two_stage": [_P] * 10 + [_I] * 15 + [_P],
    # sid, valid, corr (or NULL), base_pos, last_in, bad_in, is_sync, is_fp,
    # is_resync, last_out, bad_out, L (lanes), W (windows), stream
    "rtsdr_sync_walk": [_P] * 11 + [_I] * 2 + [_P],
}

#: launches per kernel entry since the last ``reset_launch_counts``
LAUNCHES: dict[str, int] = {}

_lib = None
build_seconds: float | None = None   # nvcc wall time of this process's build


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def add_launches(counts: dict) -> None:
    """Count a replayed CUDA graph's launches: ``counts`` are those its
    capture recorded (``utils/jit.py``), so a replay counts what the eager
    step would."""
    for name, n in counts.items():
        LAUNCHES[name] = LAUNCHES.get(name, 0) + n


def _find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "rtsdr_tpu_torch: nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda)"
        "; the CUDA kernels are built from csrc/ at first use")


def _sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC_DIR, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> str:
    """Compile ``csrc/*.cu`` (one ``nvcc`` per source, in parallel) and
    link them into one shared library; returns its path.  A library built
    earlier from the same sources is reused."""
    global build_seconds
    tag = _sources_hash()
    so_path = os.path.join(BUILD_DIR, f"librtsdr_kernels_{tag}.so")
    if os.path.exists(so_path):
        return so_path
    nvcc = _find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    for src in SOURCES:
        obj = os.path.join(BUILD_DIR, f"{src[:-3]}_{tag}_{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c",
               os.path.join(CSRC_DIR, src), "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    objs, failed = [], []
    for src, obj, proc in procs:          # wait for ALL before raising
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{out}")
        elif verbose and out:
            print(out, flush=True)
        objs.append(obj)
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = f"{so_path}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, so_path)              # atomic: safe with other processes
    for obj in objs:
        os.remove(obj)
    build_seconds = time.perf_counter() - t0
    return so_path


def load(verbose: bool = False):
    """The kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build(verbose))
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.rtsdr_error_string.argtypes = [ctypes.c_int]
        lib.rtsdr_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def ptr(t) -> int | None:
    """Device address of a tensor (None stays a NULL pointer)."""
    return None if t is None else t.data_ptr()


_entries: dict = {}


def current_stream() -> int:
    """PyTorch's current CUDA stream on the current device, as the raw
    handle (the accessor PyTorch's own kernel launchers use: no Stream
    object is made per launch)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def launch(entry: str, count_as: str, *args) -> None:
    """Call C entry point ``entry`` with ``args`` plus PyTorch's current
    stream; raise on a launch error, else count one launch of
    ``count_as``."""
    fn = _entries.get(entry)
    if fn is None:
        fn = _entries[entry] = getattr(load(), entry)
    err = fn(*args, current_stream())
    if err != 0:
        msg = _lib.rtsdr_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA launch failed ({err}: {msg})")
    LAUNCHES[count_as] = LAUNCHES.get(count_as, 0) + 1


def check(t, name: str, shape=None, dtype=None, device=None):
    """Raise unless ``t`` is a contiguous tensor of the given shape /
    dtype / device (what the kernels take)."""
    if dtype is not None and t.dtype is not dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if shape is not None and t.shape != shape and \
            tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return t
