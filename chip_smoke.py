#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``rtsdr_tpu_torch/csrc`` (``nvcc``, into the
git-ignored ``rtsdr_tpu_torch/build``), then

  1. ``kernel_cases`` — calls every kernel wrapper on CUDA tensors at the
     shapes the receiver gives it (MODE0: 307,200-byte blocks, 151 taps,
     C = 1 and C = 1024) and holds the result against its plain PyTorch
     version on the same inputs, within the stated tolerance; times the
     kernel (CUDA events, median), the plain version, and for the FIR bank
     one ``torch.nn.functional.conv1d`` call as a yardstick that the port
     itself never uses; computes the least time the card could need;
  2. ``stream`` — the CLI path: 8 blocks of a synthetic FM stereo station
     through ``StreamRunner`` at C = 1 (and once more through
     ``python -m rtsdr_tpu_torch.cli 0 --no-rds`` as a subprocess, whose
     bytes must be identical); the decoded tones must have the expected
     amplitudes, which shows the pilot loop locked;
  3. ``batch`` — ``Receiver(MODE0, (1024,), enable_rds=False)``: 6 steps on
     1024 noisy stations; finite outputs, row 0 equal to a C = 1 run;
  4. ``batch_runner`` — the ``--stations`` path: 16 capture files through
     ``BatchRunner`` (one reader per file, pinned staging, one batched step
     per block); station 0 equal to the C = 1 run;
  5. checks that phases 2-4 (the main path) went through the kernels: the
     launch counts, set to 0 just before, must equal steps x launches per
     step.

Every line printed is one JSON object, except the line with the card's name
and power limit.  Exit code 0 and a last line ``{"ok": true, ...}`` only if
every phase passed; without a CUDA device, or if a kernel does not build,
launch or agree, the exit code is not 0 and no result is printed.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

H100_MEM_BYTES_PER_S = 3.35e12   # HBM3, NVIDIA H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12      # float32 outside the tensor cores

TOL_FIR_REL = 2e-6    # x max|ref|: float32 sums of 151 terms, order may differ
TOL_IQ = 3e-6         # decimated I/Q, |values| < 1
TOL_FM = 5e-6         # rad: atan2f vs torch.atan2 on constant-envelope I/Q
TOL_STATE = 1e-6      # carried FIR / discriminator state
TOL_NCO = 5e-5        # cos/sin of angles the two detectors round differently
TOL_PLL_STATE = 1e-4  # sequential float32 rounding over 15,360 samples
TOL_PLL_INTEG = 1e-5  # the integrator of a locked loop is itself ~1e-3

N_STREAM_BLOCKS = 8
N_BATCH_STEPS = 6
N_BATCH_CHANNELS = 1024
N_RUNNER_STATIONS = 16
N_RUNNER_BLOCKS = 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1

    import numpy as np
    import torch.nn.functional as F

    from rtsdr_tpu_torch import runtime
    from rtsdr_tpu_torch.config import MODE0
    from rtsdr_tpu_torch.io.batch import BatchRunner
    from rtsdr_tpu_torch.io.stream import StreamRunner
    from rtsdr_tpu_torch.ops import (
        _cuda, coeffs, cuda_fir, cuda_pll, fir, ingestfir)
    from rtsdr_tpu_torch.ops.pll import PLLState, pll, pll_init, pll_loop
    from rtsdr_tpu_torch.pipeline.audio import audio_lpf_taps
    from rtsdr_tpu_torch.pipeline.frontend import rf_lpf_taps
    from rtsdr_tpu_torch.pipeline.receiver import Receiver
    from rtsdr_tpu_torch.utils.signals import fm_multiplex_iq

    # the plain versions are explicit float32 sums, but state it anyway:
    # no TF32 anywhere in a reference or a yardstick
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    dev = torch.device("cuda")
    cfg = MODE0
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    emit({"card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    _cuda.load()
    t1 = time.perf_counter()
    # the host runtime (C++ block reader) builds at first use too: build it
    # here, so the stream phase below times streaming and not g++
    native_reader = runtime.have_native()
    emit({"build": {"seconds": round(t1 - t0, 3),
                    "nvcc_seconds": _cuda.build_seconds,
                    "sources": [f"rtsdr_tpu_torch/csrc/{s}"
                                for s in _cuda.SOURCES],
                    "host_runtime_seconds": round(time.perf_counter() - t1, 3),
                    "host_runtime_native": native_reader}, "card": card})

    # ------------------------------------------------------------ helpers
    def time_ms(fn, reps=7, warm=2):
        for _ in range(warm):
            fn()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors
                   if t is not None)

    def bound(bytes_moved, flops):
        t_b = bytes_moved / H100_MEM_BYTES_PER_S * 1e3
        t_o = flops / H100_F32_FLOP_PER_S * 1e3
        return {"bound_ms": max(t_b, t_o),
                "bound_by": "bytes" if t_b >= t_o else "operations",
                "bytes": int(bytes_moved), "flop": int(flops),
                "bytes_ms": t_b, "operations_ms": t_o}

    def max_err(a, b):
        return float((a.double() - b.double()).abs().max())

    cases = []

    def check(name, shape, errs, tols, **extra):
        """errs / tols: dicts by quantity; fail the run if any exceeds."""
        bad = {k: (errs[k], tols[k]) for k in errs if not errs[k] <= tols[k]}
        row = {"name": name, "shape": shape, "max_abs_err": max(errs.values()),
               "errors": errs, "tolerances": tols, **extra}
        cases.append(row)
        if bad:
            emit({"kernel_case_failed": row})
            raise SystemExit(f"chip_smoke: {name} {shape} disagrees with its "
                             f"plain version: {bad}")
        return row

    # ------------------------------------------------------------- inputs
    rf_h = rf_lpf_taps(cfg)
    mono_h = audio_lpf_taps(cfg)
    if_fs = cfg.rf.if_fs
    pilot_h = coeffs.bandpass_taps(if_fs, cfg.stereo.pilot_lo,
                                   cfg.stereo.pilot_hi, cfg.stereo.taps)
    chan_h = coeffs.bandpass_taps(if_fs, cfg.stereo.chan_lo,
                                  cfg.stereo.chan_hi, cfg.stereo.taps)
    rds_h = coeffs.bandpass_taps(if_fs, cfg.rds.extract_lo,
                                 cfg.rds.extract_hi, cfg.rds.taps)
    n_if, n_audio = cfg.if_len, cfg.audio_len
    taps = cfg.rf.taps

    n_blocks = max(N_STREAM_BLOCKS, N_BATCH_STEPS)
    station = fm_multiplex_iq(n_blocks * cfg.iq_len).reshape(
        n_blocks, cfg.block_size)
    # 16 distinct stations (tone frequencies, pilot phases), tiled to 1024
    # rows; every row but row 0 gets its own +-8 LSB of uniform noise
    variants = [station[:N_BATCH_STEPS]]
    for k in range(1, 16):
        variants.append(fm_multiplex_iq(
            N_BATCH_STEPS * cfg.iq_len, mono_hz=700.0 + 130.0 * k,
            stereo_hz=1500.0 + 210.0 * k, pilot_phase=0.37 * k
        ).reshape(N_BATCH_STEPS, cfg.block_size))
    variants_host = np.stack(variants, axis=1)                   # (6, 16, B)
    variants = torch.as_tensor(variants_host).to(dev)
    gen = torch.Generator(device=dev).manual_seed(20260)

    def batch_block(b: int) -> torch.Tensor:
        rows = variants[b].repeat(N_BATCH_CHANNELS // 16, 1).to(torch.int16)
        noise = torch.randint(-8, 9, rows.shape, generator=gen, device=dev,
                              dtype=torch.int16)
        noise[0] = 0
        return (rows + noise).clamp_(0, 255).to(torch.uint8)

    # -------------------------------------------------- 1. kernel cases
    # Inputs of block 1 with the states block 0 left behind, so that every
    # carried state is a real mid-stream one.
    def ingest_inputs(c):
        if c == 1:
            raws = [torch.as_tensor(station[b][None]).to(dev) for b in (0, 1)]
        else:
            raws = [batch_block(0), batch_block(1)]
        z = lambda *s: torch.zeros(s, device=dev)
        st = (z(c, taps - 1), z(c, taps - 1), torch.ones(c, device=dev),
              z(c), z(c, len(mono_h) - 1))
        out = ingestfir.ingest_fir_demod_audio(
            raws[0], rf_h, st[0], st[1], st[2], st[3], cfg.rf.decim, mono_h,
            st[4], cfg.mono.down)
        return raws[1], out[2:], out[0]

    for c in (N_BATCH_CHANNELS, 1):
        raw, (zi_i, zi_q, pi, pq, azi), fm_prev = ingest_inputs(c)
        shape = f"u8 ({c}, {cfg.block_size})"
        rf_flop = c * n_if * 2 * 2 * taps
        au_flop = c * n_audio * 2 * len(mono_h)
        if c != 1:
            k = ingestfir.ingest_fir_decimate(raw, rf_h, zi_i, zi_q,
                                              cfg.rf.decim)
            r = ingestfir.ingest_fir_decimate_ref(raw, rf_h, zi_i, zi_q,
                                                  cfg.rf.decim)
            names = ("i", "q", "zi_i", "zi_q")
            check("ingest.iq", shape,
                  {n: max_err(a, b) for n, a, b in zip(names, k, r)},
                  dict(zip(names, (TOL_IQ, TOL_IQ, TOL_STATE, TOL_STATE))),
                  kernel_ms=time_ms(lambda: ingestfir.ingest_fir_decimate(
                      raw, rf_h, zi_i, zi_q, cfg.rf.decim)),
                  plain_ms=time_ms(lambda: ingestfir.ingest_fir_decimate_ref(
                      raw, rf_h, zi_i, zi_q, cfg.rf.decim), reps=2, warm=0),
                  library_ms=None,
                  **bound(nbytes(raw, zi_i, zi_q, *k), rf_flop))
            k = ingestfir.ingest_fir_demod(raw, rf_h, zi_i, zi_q, pi, pq,
                                           cfg.rf.decim)
            r = ingestfir.ingest_fir_demod_ref(raw, rf_h, zi_i, zi_q, pi, pq,
                                               cfg.rf.decim)
            names = ("fm", "zi_i", "zi_q", "prev_i", "prev_q")
            check("ingest.fm", shape,
                  {n: max_err(a, b) for n, a, b in zip(names, k, r)},
                  dict(zip(names, (TOL_FM,) + (TOL_STATE,) * 4)),
                  kernel_ms=time_ms(lambda: ingestfir.ingest_fir_demod(
                      raw, rf_h, zi_i, zi_q, pi, pq, cfg.rf.decim)),
                  plain_ms=time_ms(lambda: ingestfir.ingest_fir_demod_ref(
                      raw, rf_h, zi_i, zi_q, pi, pq, cfg.rf.decim),
                      reps=2, warm=0),
                  library_ms=None,
                  **bound(nbytes(raw, zi_i, zi_q, pi, pq, *k),
                          rf_flop + c * n_if * 8))
        for emit_fm in ((True, False) if c != 1 else (True,)):
            args = (raw, rf_h, zi_i, zi_q, pi, pq, cfg.rf.decim, mono_h, azi,
                    cfg.mono.down)
            k = ingestfir.ingest_fir_demod_audio(*args, emit_fm=emit_fm)
            r = ingestfir.ingest_fir_demod_audio_ref(*args, emit_fm=emit_fm)
            names = ("fm", "audio", "zi_i", "zi_q", "prev_i", "prev_q",
                     "audio_zi")
            tols = (TOL_FM, TOL_FIR_REL * float(r[1].abs().max()),
                    TOL_STATE, TOL_STATE, TOL_STATE, TOL_STATE, TOL_FM)
            errs = {n: max_err(a, b) for n, a, b in zip(names, k, r)
                    if a is not None}
            assert (k[0] is None) == (not emit_fm)
            check("ingest.fm_audio", shape, errs,
                  {n: t for n, t in zip(names, tols) if n in errs},
                  emit_fm=emit_fm,
                  kernel_ms=time_ms(
                      lambda: ingestfir.ingest_fir_demod_audio(
                          *args, emit_fm=emit_fm)),
                  plain_ms=time_ms(
                      lambda: ingestfir.ingest_fir_demod_audio_ref(
                          *args, emit_fm=emit_fm), reps=2, warm=0),
                  library_ms=None,
                  **bound(nbytes(raw, zi_i, zi_q, pi, pq, azi, *k),
                          rf_flop + c * n_if * 8 + au_flop))

        # FIR bank at the shapes audio.py gives it: fm of this block, the
        # bank's own outputs as the mixer's inputs
        fm = ingestfir.ingest_fir_demod_audio(
            raw, rf_h, zi_i, zi_q, pi, pq, cfg.rf.decim, mono_h, azi,
            cfg.mono.down)[0]
        if_zi = fm_prev[:, -(taps - 1):].contiguous()
        (_, chan_prev), _ = cuda_fir.fir_bank_carried(
            fm_prev, [pilot_h, chan_h], None)
        (pilot, chan), _ = cuda_fir.fir_bank_carried(fm, [pilot_h, chan_h],
                                                     if_zi)
        st0 = pll_init((c,), device=dev)
        pkw = dict(freq=cfg.stereo.pll.freq, fs=if_fs,
                   nco_scale=cfg.stereo.pll.nco_scale,
                   phase_adjust=cfg.stereo.pll.phase_adjust,
                   norm_bandwidth=cfg.stereo.pll.norm_bandwidth)
        nco_prev, _, st1 = cuda_pll.pll_cuda(
            cuda_fir.fir_bank(fm_prev, [pilot_h])[0], st0, **pkw)
        nco, _, _ = cuda_pll.pll_cuda(pilot, st1, **pkw)
        mix_zi = (2.0 * chan_prev * nco_prev)[:, -(len(mono_h) - 1):
                                              ].contiguous()
        sq_zi = (chan_prev * chan_prev)[:, -(taps - 1):].contiguous()

        bank_cases = [("none", [pilot_h, chan_h], 1, fm, None, if_zi)]
        bank_cases.append(("mul2", [mono_h], cfg.mono.down, chan, nco,
                           mix_zi))
        if c != 1:
            bank_cases.append(("square", [rds_h], 1, chan, None, sq_zi))
            bank_cases.append(("none", [pilot_h, chan_h, rds_h], 1, fm, None,
                               if_zi))
        for pre, hl, s, x, x2, zi in bank_cases:
            k_ys, k_t = cuda_fir.fir_bank_carried(x, hl, zi, s, x2=x2,
                                                  pre=pre)
            r_ys, r_t = cuda_fir.fir_bank_carried_ref(x, hl, zi, s, x2=x2,
                                                      pre=pre)
            errs = {f"y{f}": max_err(a, b)
                    for f, (a, b) in enumerate(zip(k_ys, r_ys))}
            tols = {f"y{f}": TOL_FIR_REL * float(b.abs().max())
                    for f, b in enumerate(r_ys)}
            errs["new_zi"] = max_err(k_t, r_t)
            tols["new_zi"] = TOL_STATE
            # yardstick: one conv1d call over the already extended (and,
            # for a pre-op, already mixed / squared) input
            xp = x if pre == "none" else (x * x if pre == "square"
                                          else 2.0 * x * x2)
            xext = torch.cat([zi, xp], dim=-1)[:, None, :]
            w = torch.as_tensor(np.stack(hl)[:, None, ::-1].copy(),
                                dtype=torch.float32, device=dev)
            lib = F.conv1d(xext, w, stride=s)
            lib_err = max(max_err(lib[:, f], r_ys[f]) /
                          float(r_ys[f].abs().max()) for f in range(len(hl)))
            n_out = k_ys[0].shape[-1]
            check(f"fir_bank.{pre}", f"f32 ({c}, {x.shape[-1]})", errs, tols,
                  filters=len(hl), stride=s,
                  kernel_ms=time_ms(lambda: cuda_fir.fir_bank_carried(
                      x, hl, zi, s, x2=x2, pre=pre)),
                  plain_ms=time_ms(lambda: cuda_fir.fir_bank_carried_ref(
                      x, hl, zi, s, x2=x2, pre=pre), reps=2, warm=0),
                  library_ms=time_ms(lambda: F.conv1d(xext, w, stride=s)),
                  library="torch.nn.functional.conv1d (cudnn.allow_tf32="
                          "False) on the extended, pre-mixed input",
                  library_rel_err_vs_plain=lib_err,
                  **bound(nbytes(x, x2, zi, k_t, *k_ys),
                          len(hl) * c * n_out * 2 * taps
                          + (0 if pre == "none" else
                             x.numel() * (1 if pre == "square" else 2))))

        # PLL: the band-passed pilot of this block from the locked state
        def pll_case(label, x, st, div, **kw):
            xs = torch.stack(x, 0) if isinstance(x, tuple) else x
            lanes = xs.numel() // xs.shape[-1]
            k = cuda_pll.pll_cuda(x, st, loop_div=div, **kw)
            t_plain = time.perf_counter()
            r = pll_loop(xs, st, loop_div=div, **kw)
            torch.cuda.synchronize()
            t_plain = (time.perf_counter() - t_plain) * 1e3
            errs = {"nco_i": max_err(k[0], r[0]), "nco_q": max_err(k[1], r[1])}
            tols = {"nco_i": TOL_NCO, "nco_q": TOL_NCO}
            for name, a, b in zip(PLLState._fields, k[2], r[2]):
                d = (a.double() - b.double()).abs()
                if name in ("phase_est", "theta"):      # angles mod 4 pi
                    d = torch.minimum(d % (4 * np.pi),
                                      4 * np.pi - d % (4 * np.pi))
                # the state has leaves called nco_i / nco_q too
                errs[f"state.{name}"] = float(d.max())
                tols[f"state.{name}"] = (TOL_PLL_INTEG if name == "integrator"
                                         else TOL_PLL_STATE)
            n = xs.shape[-1]
            check("pll", f"f32 {label} = {lanes} lanes x {n}", errs, tols,
                  loop_div=div,
                  integrator_max_abs=float(r[2].integrator.abs().max()),
                  kernel_ms=time_ms(lambda: cuda_pll.pll_cuda(
                      x, st, loop_div=div, **kw)),
                  plain_ms=t_plain, library_ms=None,
                  **bound(nbytes(xs, k[0], k[1]) + 2 * 7 * 4 * lanes
                          + 5 * 4 * lanes,
                          lanes * n * (12 // div + 8)))

        pll_case(f"({c}, N)", pilot, st1, 1, **pkw)
        pll_case(f"({c}, N)", pilot, st1, 4, **pkw)
        if c != 1:
            # two-part input with per-part constants: the stereo-pilot +
            # squared-RDS-carrier pair of the RDS slice
            # (the second part is a clean 114 kHz carrier per lane: an
            # unlocked loop fed noise wanders across the detector's +-pi
            # seam, where two roundings of one angle legitimately part)
            tt = torch.arange(n_if, device=dev, dtype=torch.float64) / if_fs
            ph = 0.05 * (torch.arange(c, device=dev) % 16)[:, None]
            sq = torch.cos(2 * np.pi * cfg.rds.pll.freq * tt[None, :] + ph
                           ).to(torch.float32)
            b1 = (2, 1)
            sp, rp = cfg.stereo.pll, cfg.rds.pll
            kw2 = dict(
                freq=np.array([sp.freq, rp.freq]).reshape(b1), fs=if_fs,
                nco_scale=np.array([sp.nco_scale, rp.nco_scale]).reshape(b1),
                phase_adjust=np.array([sp.phase_adjust,
                                       rp.phase_adjust]).reshape(b1),
                norm_bandwidth=np.array([sp.norm_bandwidth,
                                         rp.norm_bandwidth]).reshape(b1))
            st2 = PLLState(*(torch.stack([a, b]) for a, b in
                             zip(st1, pll_init((c,), device=dev))))
            pll_case(f"2 parts of ({c}, N)", (pilot, sq), st2, 1, **kw2)
        del fm, pilot, chan, nco, fm_prev, chan_prev, nco_prev, raw

    emit({"kernel_cases": cases, "card": card})
    torch.cuda.empty_cache()

    # nothing with a kernel computes its plain version on the card: what the
    # kernels cannot take (float64) raises, per function and per pipeline
    x64 = torch.zeros((2, 600), dtype=torch.float64, device=dev)
    zi64 = torch.zeros((2, taps - 1), dtype=torch.float64, device=dev)
    refusals = {
        "fir_block": lambda: fir.fir_block(x64, mono_h, zi64),
        "fir_decimate": lambda: fir.fir_decimate(x64, mono_h, zi64, 5),
        "fir_bank_carried": lambda: cuda_fir.fir_bank_carried(
            x64, [mono_h], zi64),
        "pll": lambda: pll(x64, pll_init((2,), torch.float64, dev), **pkw),
        "Receiver": lambda: Receiver(cfg, (), torch.float64,
                                     enable_rds=False),
    }
    before = _cuda.launch_counts()
    for name, call in refusals.items():
        try:
            call()
        except TypeError:
            continue
        raise SystemExit(f"chip_smoke: {name} took float64 on the card "
                         "instead of raising")
    if _cuda.launch_counts() != before:
        raise SystemExit("chip_smoke: a refused call launched a kernel")
    emit({"refused_float64_on_card": sorted(refusals), "card": card})

    # --------------------------------- warm-up outside the counted window
    rx1 = Receiver(cfg, (), enable_rds=False)
    rxb = Receiver(cfg, (N_BATCH_CHANNELS,), enable_rds=False)
    st = rx1.init()
    for b in range(2):
        st, _ = rx1.step(st, torch.as_tensor(station[b]).to(dev))
    rxb.step(rxb.init(), batch_block(0))
    torch.cuda.synchronize()

    # ============================ the main path: counts start from 0 here
    _cuda.reset_launch_counts()

    # ---------------------------------------------------------- 2. stream
    with tempfile.TemporaryDirectory() as tmp:
        iq_path = os.path.join(tmp, "station.iq")
        station[:N_STREAM_BLOCKS].tofile(iq_path)
        chunks = []
        runner = StreamRunner(cfg, enable_rds=False)
        with open(iq_path, "rb") as f:
            t0 = time.perf_counter()
            stats = runner.run(f.fileno(), emit=chunks.append)
            stream_s = time.perf_counter() - t0
        stream_counts = _cuda.launch_counts()
        # the same capture through the command-line entry point
        with open(iq_path, "rb") as f:
            cli = subprocess.run(
                [sys.executable, "-m", "rtsdr_tpu_torch.cli", "0", "--no-rds"],
                stdin=f, capture_output=True, timeout=600,
                cwd=os.path.dirname(os.path.abspath(__file__)))
    pcm = b"".join(chunks)
    expect_bytes = N_STREAM_BLOCKS * n_audio * 4
    if stats["blocks"] != N_STREAM_BLOCKS or len(pcm) != expect_bytes:
        raise SystemExit(f"chip_smoke: stream wrote {len(pcm)} bytes in "
                         f"{stats['blocks']} blocks, expected {expect_bytes}")
    if cli.returncode != 0 or cli.stdout != pcm:
        raise SystemExit(
            "chip_smoke: the CLI subprocess failed or its bytes differ from "
            f"StreamRunner's (rc {cli.returncode}, {len(cli.stdout)} bytes): "
            f"{cli.stderr.decode()[-2000:]}")
    lr = np.frombuffer(pcm, np.int16).reshape(-1, 2)[n_audio:] / 16384.0
    t = np.arange(lr.shape[0]) / cfg.audio_fs

    def tone(x, hz):
        return 2.0 * float(np.hypot(np.mean(x * np.sin(2 * np.pi * hz * t)),
                                    np.mean(x * np.cos(2 * np.pi * hz * t))))

    amps = {"mono_1100Hz_in_L+R": tone(lr[:, 0] + lr[:, 1], 1.1e3),
            "stereo_2300Hz_in_L-R": tone(lr[:, 0] - lr[:, 1], 2.3e3),
            "leak_2300Hz_in_L+R": tone(lr[:, 0] + lr[:, 1], 2.3e3)}
    emit({"stream": {"blocks": N_STREAM_BLOCKS, "channels": 1,
                     "bytes_out": len(pcm), "tone_amplitudes": amps,
                     "expected": {"mono": 0.88, "stereo": 0.83,
                                  "leak_below": 0.02, "within": "10%"},
                     "ms_per_64ms_block": stream_s * 1e3 / N_STREAM_BLOCKS,
                     "cli_bytes_identical": True,
                     "launches": stream_counts}, "card": card})
    if not (abs(amps["mono_1100Hz_in_L+R"] - 0.88) < 0.088
            and abs(amps["stereo_2300Hz_in_L-R"] - 0.83) < 0.083
            and amps["leak_2300Hz_in_L+R"] < 0.02):
        raise SystemExit(f"chip_smoke: stream tones are off: {amps}")

    # ----------------------------------------------------------- 3. batch
    st_b, st_1 = rxb.init(), rx1.init()
    step_ms, row0_err, finite, peak, twin_lr = [], 0.0, True, 0, []
    for b in range(N_BATCH_STEPS):
        raw = batch_block(b)
        torch.cuda.synchronize()
        # peak while stepping: state, this block's input and outputs, the
        # step's intermediates (not the scratch the input was made with)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        st_b, out_b = rxb.step(st_b, raw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        peak = max(peak, torch.cuda.max_memory_allocated())
        st_1, out_1 = rx1.step(st_1, raw[0])
        twin_lr.append((out_1.left.cpu().numpy(), out_1.right.cpu().numpy()))
        for a, r in ((out_b.left, out_1.left), (out_b.right, out_1.right),
                     (out_b.mono, out_1.mono)):
            finite = finite and bool(torch.isfinite(a).all())
            if tuple(a.shape) != (N_BATCH_CHANNELS, n_audio):
                raise SystemExit(f"chip_smoke: batch output shape {a.shape}")
            row0_err = max(row0_err, max_err(a[0], r))
    steady = statistics.median(step_ms[1:])

    # ---------------------------------------------------- 4. batch_runner
    # the --stations path: one capture file per station (the 16 noiseless
    # variants; station 0 is the C = 1 twin's input), one reader thread per
    # file, pinned (N, block) staging, one batched step per block
    got = [[] for _ in range(N_RUNNER_STATIONS)]
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for c in range(N_RUNNER_STATIONS):
            path = os.path.join(tmp, f"station{c}.iq")
            variants_host[:N_RUNNER_BLOCKS, c].tofile(path)
            files.append(open(path, "rb"))
        try:
            with BatchRunner(cfg, [f.fileno() for f in files],
                             enable_rds=False) as runner:
                t0 = time.perf_counter()
                rstats = runner.run(emit=lambda c, left, right: got[c].append(
                    (left.copy(), right.copy())))
                runner_s = time.perf_counter() - t0
        finally:
            for f in files:
                f.close()
    if (rstats != {"blocks": N_RUNNER_BLOCKS, "stations": N_RUNNER_STATIONS}
            or any(len(g) != N_RUNNER_BLOCKS for g in got)):
        raise SystemExit(f"chip_smoke: BatchRunner stats {rstats}, blocks "
                         f"emitted per station {[len(g) for g in got]}")
    runner_finite = all(np.isfinite(a).all() and a.shape == (n_audio,)
                        for g in got for lr_ in g for a in lr_)
    runner_err = max(float(np.abs(a - r).max())
                     for b in range(N_RUNNER_BLOCKS)
                     for a, r in zip(got[0][b], twin_lr[b]))
    # the stations differ, so no two rows may carry the same audio
    distinct = len({got[c][-1][0].tobytes()
                    for c in range(N_RUNNER_STATIONS)})
    counts = _cuda.launch_counts()
    # ============================================= end of the main path
    emit({"batch": {"channels": N_BATCH_CHANNELS, "steps": N_BATCH_STEPS,
                    "bytes_per_step": N_BATCH_CHANNELS * cfg.block_size,
                    "finite": finite, "row0_max_abs_err_vs_c1": row0_err,
                    "row0_tolerance": 2e-5, "step_ms": step_ms,
                    "ms_per_step_median": steady,
                    "realtime_multiple": N_BATCH_CHANNELS * 64.0 / steady,
                    "max_memory_allocated_bytes": peak}, "card": card})
    if not finite or not row0_err <= 2e-5:
        raise SystemExit(f"chip_smoke: batch outputs wrong (finite={finite}, "
                         f"row 0 differs from the C=1 run by {row0_err})")
    emit({"batch_runner": {"stations": N_RUNNER_STATIONS,
                           "blocks": N_RUNNER_BLOCKS, "finite": runner_finite,
                           "station0_max_abs_err_vs_c1": runner_err,
                           "station0_tolerance": 2e-5,
                           "distinct_stations": distinct,
                           "ms_per_block": runner_s * 1e3 / N_RUNNER_BLOCKS},
          "card": card})
    if (not runner_finite or not runner_err <= 2e-5
            or distinct != N_RUNNER_STATIONS):
        raise SystemExit(
            f"chip_smoke: BatchRunner outputs wrong (finite={runner_finite}, "
            f"station 0 differs from the C=1 run by {runner_err}, "
            f"{distinct} distinct stations of {N_RUNNER_STATIONS})")

    # stream, batch, the batch's C = 1 twin, BatchRunner
    steps = N_STREAM_BLOCKS + 2 * N_BATCH_STEPS + N_RUNNER_BLOCKS
    per_step = {"ingest.fm_audio": 1, "fir_bank.none": 1, "fir_bank.mul2": 1,
                "pll": 1}
    expected = {k: v * steps for k, v in per_step.items()}
    if counts != expected:
        raise SystemExit(f"chip_smoke: launch counts {counts} on the main "
                         f"path, expected {expected}")

    # -------------------------------------------------- the kernels line
    meta = {
        "ingest.fm_audio": ("rtsdr_tpu_torch/csrc/ingest.cu",
                            "rtsdr_tpu/ops/ingestfir.py:257"),
        "fir_bank.none": ("rtsdr_tpu_torch/csrc/fir_bank.cu",
                          "rtsdr_tpu/ops/pallas_fir.py:35"),
        "fir_bank.mul2": ("rtsdr_tpu_torch/csrc/fir_bank.cu",
                          "rtsdr_tpu/ops/pallas_fir.py:35"),
        "pll": ("rtsdr_tpu_torch/csrc/pll.cu",
                "rtsdr_tpu/ops/pallas_pll.py:82"),
    }
    rows = []
    for name, (source, replaces) in meta.items():
        # the case at the batch path's shape (C = 1024; the receiver's own
        # configuration of the kernel comes first among the cases)
        case = next(r for r in cases if r["name"] == name
                    and f"({N_BATCH_CHANNELS}," in r["shape"])
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": counts[name],
                     "shape": case["shape"],
                     "max_abs_err": case["max_abs_err"],
                     "ms": case["kernel_ms"], "plain_ms": case["plain_ms"],
                     "bound_ms": case["bound_ms"],
                     "bound_by": case["bound_by"],
                     "library_ms": case["library_ms"]})
    print(card, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
