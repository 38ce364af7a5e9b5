"""rtsdr_tpu_torch — the PyTorch/CUDA port of ``rtsdr_tpu`` (NVIDIA Hopper).

Same layout and function names as the JAX package, which stays in the
repository as the reference; this package imports ``torch`` and ``numpy``
and nothing of ``jax`` or ``rtsdr_tpu``.

Ported so far: the receiver in modes 0 and 1 (uint8 I/Q -> front end ->
mono + stereo -> int16; RDS DSP -> bit layer -> decoded groups), the
wideband receiver (one capture at K x the RF rate -> K stations), the band
scanner and the parallel receivers (time-, channel- and wideband-sharded,
multihost), with hand-written CUDA kernels (``csrc/ingest.cu``,
``csrc/fir_bank.cu``, ``csrc/pll.cu``, ``csrc/resample_rrc.cu``,
``csrc/channelizer.cu``) built at first use and bound through ``ctypes``
(``ops/_cuda.py``).

Every ``*_init``, ``make_*`` and ``Receiver`` takes an explicit ``device``
whose default is ``"cuda"``; nothing falls back to the CPU by itself.  A
kernel wrapper given a CPU tensor runs its plain PyTorch version (what the
CPU tests exercise); given a CUDA tensor it launches the kernel or raises.

Package layout:
  config    — frozen mode tables
  ops       — coeffs, FIR, discriminator, IIR, PLL, channelizer, PSD + the
              CUDA kernel wrappers
  pipeline  — frontend, audio, rds, frame, groups, receiver, wideband, scan
              (NamedTuple states, JAX field names)
  parallel  — mesh, time-sharded / channel-sharded receivers, multihost,
              scaling
  io        — host streaming loops, wav / raw file I/O
  runtime   — native prefetching block reader + int16 emitter (ctypes)
  utils     — signal generators, state conversion
  csrc      — CUDA C++ sources
"""

__version__ = "0.1.0"

from rtsdr_tpu_torch import config  # noqa: F401
