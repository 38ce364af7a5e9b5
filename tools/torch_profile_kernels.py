#!/usr/bin/env python3
"""The fused-ingest (K1), FIR-bank (K2), PLL (K3), mixer + resampler + RRC
(K4), composed-channelizer (K5) and mixer + resampler (K6) kernels alone,
at the shapes the receivers give them, on one GPU.

    python3 tools/torch_profile_kernels.py [--repo DIR] [--label NAME]
        [--only K1,K2,K3,K4,K5,K6] [--check] [--host-breakdown] [--out FILE]

Imports ``rtsdr_tpu_torch`` from ``--repo`` (default: this checkout), so
that the same script times another tree's kernels, such as a ``git
archive`` of a parent commit, through the same wrapper signatures
(``ingestfir.ingest_fir_*``, ``cuda_fir.fir_bank_carried``,
``cuda_pll.pll_cuda``, ``cuda_resample.resample_mul2_rrc``,
``channelizer.composed_channelize_u8``, ``cuda_resample.resample_mul2``; a
tree without K6's segmented form runs the time-sharded receiver's former
route, the halo zi made in stock ops).  K1's inputs are 16 synthetic
stations under +-8 LSB of noise, tiled to the rows, with the states their
previous block leaves; K4's and K6's a band-limited extract and a carrier
of unit modulus; K5's random bytes at K = 16 with no offsets, one, and
every station offset.  Per shape:

  * ``wrapper_ms``: CUDA events around one wrapper call, median of 7;
  * ``burst_ms``: events around a burst of 10 calls, / 10, median of 5;
  * ``device_ms``: the kernel's own device time per call, by
    ``torch.profiler`` over a burst of 10;
  * ``host_us`` (C = 1 shapes): host time per wrapper call,
    ``time.perf_counter`` around loops of 20 calls with no synchronisation
    inside (the launch queue never fills), median of 25;
  * for K2 the same for one ``torch.nn.functional.conv1d`` call (TF32 off)
    over the extended, pre-mixed input: the yardstick, used nowhere in the
    port.

``--host-breakdown`` first prints what the pieces of a C = 1 wrapper call
cost the host (microseconds per call, as ``host_us``): an allocation,
``unbind``, ``data_ptr``, the current stream, a bare launch through
``ctypes``, the whole wrappers, ``F.conv1d``.

With ``--check`` each case is also held against its plain version (K1:
I/Q 3e-6, fm 5e-6 rad, audio and bank 2e-6 max|ref| plus what the fm
difference passes on, state 1e-6; K2: 2e-6 max|ref|; K3 over 2 lanes of a
locked pilot and carrier: NCO 5e-5; K4: rrc and its state 5e-6 max|ref|,
``new_zi`` bit for bit; K5: 8e-6 max sum|g|, the byte tail equal; K6:
5e-6 max|ref|, ``new_zi`` bit for bit).
Prints one JSON line per case and a last line with the card's name and power
limit; ``--out`` appends the lines to a file too.
"""

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--only", default="K1,K2,K3,K4,K5,K6",
                    help="comma-separated kernels to time")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--host-breakdown", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))

    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    # what rtsdr_tpu_torch/utils/trace.py::profile does (a --repo tree may
    # predate it): CUPTI torn down after each session, so that its device
    # timestamps do not drift against the next session's window
    os.environ.setdefault("TEARDOWN_CUPTI", "1")

    if not torch.cuda.is_available():
        print("torch_profile_kernels: no CUDA device", file=sys.stderr)
        return 1
    from rtsdr_tpu_torch.config import MODE0, MODE1, MODE1_RDS
    from rtsdr_tpu_torch.ops import (
        _cuda, coeffs, cuda_fir, cuda_pll, cuda_resample, ingestfir)
    from rtsdr_tpu_torch.pipeline.rds import composed_resampler_taps
    from rtsdr_tpu_torch.utils.signals import fm_multiplex_iq
    from rtsdr_tpu_torch.ops.pll import pll_init, pll_loop
    from rtsdr_tpu_torch.pipeline.audio import audio_lpf_taps
    from rtsdr_tpu_torch.pipeline.frontend import rf_lpf_taps

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    _cuda.load()
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def ev_ms(fn, calls, reps, warm=2):
        for _ in range(warm):
            fn()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(calls):
                fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / calls)
        return statistics.median(times)

    def device_ms(fn, match, calls=10):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = 0.0
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if match is not None and match not in e.key:
                continue
            for name in ("self_device_time_total", "self_cuda_time_total"):
                if hasattr(e, name):
                    us += float(getattr(e, name))
                    break
        return us / 1e3 / calls if us else None

    def host_us(fn, calls=20, reps=25):
        # loops short enough that the launch queue never fills and blocks
        # the host; median per call
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
        return statistics.median(times)

    def timings(fn, match, small):
        row = {"wrapper_ms": ev_ms(fn, 1, 7), "burst_ms": ev_ms(fn, 10, 5),
               "device_ms": device_ms(fn, match)}
        if small:
            row["host_us"] = host_us(fn)
        return row

    cfg = MODE0
    fs = cfg.rf.if_fs
    bank_h = [coeffs.bandpass_taps(fs, cfg.stereo.pilot_lo,
                                   cfg.stereo.pilot_hi, cfg.stereo.taps),
              coeffs.bandpass_taps(fs, cfg.stereo.chan_lo,
                                   cfg.stereo.chan_hi, cfg.stereo.taps),
              coeffs.bandpass_taps(fs, cfg.rds.extract_lo,
                                   cfg.rds.extract_hi, cfg.rds.taps)]
    sq_h = coeffs.bandpass_taps(fs, cfg.rds.squared_lo, cfg.rds.squared_hi,
                                cfg.rds.taps)
    mono_h = audio_lpf_taps(cfg)
    rf_h = rf_lpf_taps(cfg)
    gen = torch.Generator(device=dev).manual_seed(5)
    only = set(args.only.split(","))

    if args.host_breakdown:
        x = torch.randn(1, 15360, device=dev)
        zi = torch.zeros(1, 150, device=dev)
        y3 = torch.empty(3, 1, 15360, device=dev)
        w1 = torch.randn(1, 1, 151, device=dev)
        xe = torch.randn(1, 1, 15510, device=dev)
        lib = _cuda.load()
        hp = torch.zeros(160, device=dev)
        raw = lib.rtsdr_fir_bank
        stream = torch.cuda.current_stream().cuda_stream
        st = pll_init((2, 1), device=dev)
        kw = dict(freq=np.array([19e3, 114e3]).reshape(2, 1), fs=fs,
                  nco_scale=np.array([2.0, 0.5]).reshape(2, 1),
                  phase_adjust=np.zeros((2, 1)),
                  norm_bandwidth=np.array([0.01, 0.01]).reshape(2, 1))
        st = cuda_pll.pll_cuda((x, x), st, **kw)[2]
        pieces = {
            "torch.empty": lambda: torch.empty((3, 1, 15360), device=dev),
            "x.new_empty": lambda: x.new_empty((3, 1, 15360)),
            "unbind": lambda: y3.unbind(0),
            "data_ptr": lambda: x.data_ptr(),
            "x.device": lambda: x.device,
            "current_stream().cuda_stream":
                lambda: torch.cuda.current_stream().cuda_stream,
            "_cuda.current_stream": getattr(_cuda, "current_stream", None),
            "ctypes launch (F = 1, 152 taps)": lambda: raw(
                x.data_ptr(), None, None, hp.data_ptr(), y3.data_ptr(),
                None, 1, 15360, 15360, 152, 1, 1, 0, stream),
            "fir_bank_carried F=3": lambda: cuda_fir.fir_bank_carried(
                x, bank_h, zi),
            "fir_bank_carried mul2 s=5": lambda: cuda_fir.fir_bank_carried(
                x, [mono_h], zi, 5, x2=x, pre="mul2"),
            "F.conv1d": lambda: F.conv1d(xe, w1),
            "pll_cuda pair": lambda: cuda_pll.pll_cuda((x, x), st, **kw),
        }
        for name, fn in pieces.items():
            if fn is not None:
                emit({"label": args.label, "host_us": name,
                      "us": host_us(fn)})

    # (label, pre, taps, stride, shape): every shape of PERF.md's B4 row
    bank_cases = [
        ("C=1 F=3", "none", bank_h, 1, (1, 15360)),
        ("C=1 F=2", "none", bank_h[:2], 1, (1, 15360)),
        ("C=1 square", "square", [sq_h], 1, (1, 15360)),
        ("C=1 mul2 s=5", "mul2", [mono_h], 5, (1, 15360)),
        ("C=1024 F=3", "none", bank_h, 1, (1024, 15360)),
        ("C=1024 square", "square", [sq_h], 1, (1024, 15360)),
        ("C=1024 mul2 s=5", "mul2", [mono_h], 5, (1024, 15360)),
        ("mode1 C=1024 F=3", "none", bank_h, 1, (1024, 16000)),
        ("mode1 C=1024 F=2", "none", bank_h[:2], 1, (1024, 16000)),
        ("mode1 C=1024 square", "square", [sq_h], 1, (1024, 16000)),
        ("wideband F=3", "none", bank_h, 1, (8, 16, 15360)),
        ("wideband square", "square", [sq_h], 1, (8, 16, 15360)),
        ("wideband s=5", "none", [mono_h], 5, (8, 16, 15360)),
        ("wideband mul2 s=5", "mul2", [mono_h], 5, (8, 16, 15360)),
        ("wideband s=10", "none", [rf_h], 10, (8, 16, 2, 153600)),
        ("scan s=10", "none", [rf_h], 10, (16, 2, 153600)),
    ]
    for label, pre, hl, s, shape in (bank_cases if "K2" in only else []):
        x = torch.randn(shape, generator=gen, device=dev)
        x2 = (torch.randn(shape, generator=gen, device=dev)
              if pre == "mul2" else None)
        zi = torch.randn((*shape[:-1], len(hl[0]) - 1), generator=gen,
                         device=dev)
        fn = (lambda x=x, hl=hl, zi=zi, s=s, x2=x2, pre=pre:
              cuda_fir.fir_bank_carried(x, hl, zi, s, x2=x2, pre=pre))
        lanes = x.numel() // shape[-1]
        xp = x if pre == "none" else (x * x if pre == "square"
                                      else 2.0 * x * x2)
        xext = torch.cat([zi, xp], -1).reshape(lanes, 1, -1)
        w = torch.as_tensor(np.stack(hl)[:, None, ::-1].copy(),
                            dtype=torch.float32, device=dev)
        lib = (lambda xext=xext, w=w, s=s: F.conv1d(xext, w, stride=s))
        row = {"label": args.label, "kernel": "K2", "case": label,
               "pre": pre, "filters": len(hl), "stride": s, "shape": shape,
               **timings(fn, "fir_bank", lanes == 1),
               "conv1d": timings(lib, None, lanes == 1)}
        if args.check:
            ys, tail = fn()
            rys, rtail = cuda_fir.fir_bank_carried_ref(x, hl, zi, s, x2=x2,
                                                       pre=pre)
            errs = [float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(ys, rys)]
            row["rel_err"] = max(errs)
            row["tail_err"] = float((tail - rtail).abs().max())
            row["ok"] = row["rel_err"] <= 2e-6 and row["tail_err"] <= 1e-6
        emit(row)
        del x, x2, zi, xp, xext
        torch.cuda.empty_cache()

    # K3: lanes x N, loop_div, delayed view, tuple input
    pk = dict(fs=fs, norm_bandwidth=0.01)
    pll_cases = [
        ("1 lane", 1, 15360, 1, True, False),
        ("2 lanes (C = 1 pair)", 2, 15360, 1, True, True),
        ("2 lanes, loop_div 4", 2, 15360, 4, True, True),
        ("256 lanes (wideband pair)", 256, 15360, 1, True, True),
        ("2,048 lanes (MODE0 C = 1,024 pair)", 2048, 15360, 1, True, True),
        ("2,048 lanes, loop_div 4", 2048, 15360, 4, True, True),
        ("2,048 lanes, undelayed", 2048, 15360, 1, False, True),
        ("2,048 x 16,000 (mode 1)", 2048, 16000, 1, True, True),
        ("4,096 lanes", 4096, 15360, 1, True, True),
    ]
    for label, lanes, n, div, delay, pair in (pll_cases if "K3" in only
                                               else []):
        t = torch.arange(n, device=dev, dtype=torch.float64) / fs
        ph = 0.05 * (torch.arange(lanes, device=dev) % 16)[:, None]
        if pair:
            half = lanes // 2
            x = (torch.cos(2 * np.pi * 19e3 * t + ph[:half]).float(),
                 torch.cos(2 * np.pi * 114e3 * t + ph[half:]).float())
            kw = dict(freq=np.array([19e3, 114e3]).reshape(2, 1),
                      nco_scale=np.array([2.0, 0.5]).reshape(2, 1),
                      phase_adjust=np.zeros((2, 1)), **pk)
            bshape = (2, half)
        else:
            x = torch.cos(2 * np.pi * 19e3 * t + ph).float()
            kw = dict(freq=19e3, nco_scale=2.0, **pk)
            bshape = (lanes,)
        st = pll_init(bshape, device=dev)
        # a locked mid-stream state: one block from the zero state first
        st = cuda_pll.pll_cuda(x, st, loop_div=div, **kw)[2]
        fn = (lambda x=x, st=st, kw=kw, div=div, delay=delay:
              cuda_pll.pll_cuda(x, st, loop_div=div, delay_output=delay,
                                **kw))
        row = {"label": args.label, "kernel": "K3", "case": label,
               "lanes": lanes, "n": n, "loop_div": div, "delay": delay,
               "tuple": pair, **timings(fn, "pll_kernel", lanes <= 2)}
        if args.check and lanes <= 2:
            xs = torch.stack(x) if pair else x
            k = fn()
            r = pll_loop(xs, st, loop_div=div, delay_output=delay, **kw)
            row["nco_err"] = max(float((k[0] - r[0]).abs().max()),
                                 float((k[1] - r[1]).abs().max()))
            row["ok"] = row["nco_err"] <= 5e-5
        emit(row)
        del x, st
        torch.cuda.empty_cache()
    # K1: the receivers' front ends.  16 stations (+-8 LSB of noise on
    # every row but row 0) tiled to C rows, two blocks: the states of the
    # first, the second timed
    def stations(c, cfg_):
        n = 2 * cfg_.iq_len
        rows = [fm_multiplex_iq(n, cfg_.rf.fs, mono_hz=700.0 + 130.0 * k,
                                stereo_hz=1500.0 + 210.0 * k,
                                pilot_phase=0.37 * k)
                for k in range(min(c, 16))]
        base = torch.as_tensor(np.stack(rows)).to(dev)
        raw = base.repeat((c + 15) // 16, 1)[:c].to(torch.int16)
        noise = torch.randint(-8, 9, raw.shape, generator=gen, device=dev,
                              dtype=torch.int16)
        noise[0] = 0
        raw = (raw + noise).clamp_(0, 255).to(torch.uint8)
        half = raw.shape[1] // 2
        return raw[:, :half].contiguous(), raw[:, half:].contiguous()

    def k1_state(c, first, cfg_):
        z = lambda *s_: torch.zeros(s_, device=dev)
        out = ingestfir.ingest_fir_demod_audio(
            first, rf_lpf_taps(cfg_), z(c, 150), z(c, 150),
            torch.ones(c, device=dev), z(c), cfg_.rf.decim, mono_h, z(c, 150),
            5) if cfg_ is MODE0 else None
        if out is None:
            out = ingestfir.ingest_fir_demod(
                first, rf_lpf_taps(cfg_), z(c, 150), z(c, 150),
                torch.ones(c, device=dev), z(c), cfg_.rf.decim)
            return out[1:5] + (z(c, 150),), out[0]
        return out[2:7], out[0]

    def errs_of(names, got, ref, tols):
        row = {}
        ok = True
        for n, a, b in zip(names, got, ref):
            if a is None or n not in tols:
                continue
            e = float((a.double() - b.double()).abs().max())
            row[n] = e
            ok = ok and e <= tols[n]
        return row, ok

    k1_cases = [("fm_audio C=1", 1, MODE0, "fm_audio", True),
                ("fm_audio C=1024", 1024, MODE0, "fm_audio", True),
                ("fm_audio C=1024, fm not written", 1024, MODE0, "fm_audio",
                 False),
                ("fm_audio_bank C=1024", 1024, MODE0, "bank", False),
                ("fm mode 1 C=1", 1, MODE1, "fm", True),
                ("fm mode 1 C=1024", 1024, MODE1, "fm", True),
                ("iq C=1", 1, MODE0, "iq", True),
                ("iq C=1024", 1024, MODE0, "iq", True),
                ("iq segmented T=4 (1024 rows of 4 segments)", 1024, MODE0,
                 "iq4", True)]
    bank_hs = bank_h
    for label, c, cfg_, entry, emit_fm in (k1_cases if "K1" in only else []):
        first, raw = stations(c, cfg_)
        h_rf = rf_lpf_taps(cfg_)
        (zi_i, zi_q, pi, pq, azi), fm_prev = k1_state(c, first, cfg_)
        if entry in ("fm_audio", "bank"):
            kw = dict(emit_fm=emit_fm)
            if entry == "bank":
                kw.update(bank_h=bank_hs,
                          bank_zi=fm_prev[:, -150:].contiguous())
            a = (raw, h_rf, zi_i, zi_q, pi, pq, cfg_.rf.decim, mono_h, azi,
                 5)
            fn = (lambda a=a, kw=kw:
                  ingestfir.ingest_fir_demod_audio(*a, **kw))
            ref = (lambda a=a, kw=kw:
                   ingestfir.ingest_fir_demod_audio_ref(*a, **kw))
            names = ("fm", "audio", "zi_i", "zi_q", "prev_i", "prev_q",
                     "audio_zi")
        elif entry == "fm":
            a = (raw, h_rf, zi_i, zi_q, pi, pq, cfg_.rf.decim)
            fn = lambda a=a: ingestfir.ingest_fir_demod(*a)
            ref = lambda a=a: ingestfir.ingest_fir_demod_ref(*a)
            names = ("fm", "zi_i", "zi_q", "prev_i", "prev_q")
        else:
            seg = 4 if entry == "iq4" else None
            if seg:
                zi_i = zi_i.repeat(seg, 1).reshape(seg, c, -1)
                zi_q = torch.zeros_like(zi_i)
            a = (raw, h_rf, zi_i, zi_q, cfg_.rf.decim)
            fn = lambda a=a, seg=seg: ingestfir.ingest_fir_decimate(
                *a, segments=seg)
            ref = lambda a=a, seg=seg: ingestfir.ingest_fir_decimate_ref(
                *a, segments=seg)
            names = ("i", "q", "zi_i", "zi_q")
        row = {"label": args.label, "kernel": "K1", "case": label,
               "entry": entry, "shape": list(raw.shape),
               **timings(fn, "ingest_kernel", c == 1)}
        if args.check:
            got, want = fn(), ref()
            tols = {"i": 3e-6, "q": 3e-6, "fm": 5e-6, "zi_i": 1e-6,
                    "zi_q": 1e-6, "prev_i": 1e-6, "prev_q": 1e-6,
                    "audio_zi": 5e-6}
            if entry in ("fm_audio", "bank"):
                tols["audio"] = 2e-6 * float(want[1].abs().max())
            row["errors"], row["ok"] = errs_of(names, got, want, tols)
            if entry == "bank":
                fm_err = float((ingestfir.ingest_fir_demod_audio(*a)[0]
                                - ingestfir.ingest_fir_demod_audio_ref(*a)[0]
                                ).abs().max())
                for f_, (x_, y_) in enumerate(zip(got[7], want[7])):
                    e = float((x_ - y_).abs().max())
                    tol = (2e-6 * float(y_.abs().max()) + max(fm_err, 2.5e-7)
                           * float(np.abs(bank_hs[f_]).sum()))
                    row["errors"][f"bank{f_}"] = e
                    row["ok"] = row["ok"] and e <= tol
        emit(row)
        del first, raw
        torch.cuda.empty_cache()

    # K4: mixers + resampler + RRC at the receivers' shapes
    rrc_h = coeffs.rrc_taps(cfg.rds.rrc_fs, cfg.rds.rrc_taps,
                            cfg.rds.rrc_beta, cfg.rds.symbol_rate)
    k4_cases = [("x19/80 C=1", (1,), MODE0), ("x19/80 C=1024", (1024,), MODE0),
                ("x57/250 C=1024 (MODE1_RDS)", (1024,), MODE1_RDS),
                ("x19/80 wideband (8, 16)", (8, 16), MODE0)]
    for label, lead, cfg_ in (k4_cases if "K4" in only else []):
        comb = composed_resampler_taps(cfg_)
        up, down = cfg_.rds.up, cfg_.rds.down
        n = cfg_.if_len
        t = torch.arange(n, device=dev, dtype=torch.float64)
        ph = 2 * np.pi * 57e3 / cfg_.rf.if_fs * t
        off = torch.rand((*lead, 1), generator=gen, device=dev,
                         dtype=torch.float64) * 6
        ext = (0.3 * torch.cos(ph + off) + 0.01 * torch.randn(
            (*lead, n), generator=gen, device=dev, dtype=torch.float64)
               ).float()
        ni = torch.cos(ph + 2 * off).float()
        nq = torch.sin(ph + 2 * off).float()
        zi = cuda_resample.resample_mul2_tail(ext, ni, nq, len(comb) - 1, up)
        rzi = torch.randn((*lead, 2, len(rrc_h) - 1), generator=gen,
                          device=dev)
        a = (ext, ni, nq, comb, zi, rrc_h, rzi, up, down)
        fn = lambda a=a: cuda_resample.resample_mul2_rrc(*a)
        row = {"label": args.label, "kernel": "K4", "case": label,
               "shape": [*lead, n], "up": up, "down": down,
               **timings(fn, "resample_rrc_kernel", lead == (1,))}
        if args.check:
            got = fn()
            want = cuda_resample.resample_mul2_rrc_ref(*a)
            sc = float(want[0].abs().max())
            row["errors"], row["ok"] = errs_of(
                ("rrc", "new_zi", "new_rrc_zi"), got, want,
                {"rrc": 5e-6 * sc, "new_zi": 0.0, "new_rrc_zi": 5e-6 * sc})
        emit(row)
        del ext, ni, nq, zi, rzi
        torch.cuda.empty_cache()
    # K5: the composed channelizer at K = 16 (the wideband receiver's
    # taps), 8 and 1 captures, with no offsets (every station on the shared
    # prototype), the smoke's one offset (15 + 1) and every station offset
    # (own taps only); random bytes (the work does not depend on them)
    from rtsdr_tpu_torch.ops import channelizer
    wb_k = 16
    h_proto = channelizer.channelizer_taps(wb_k, 16)
    one = np.zeros(wb_k)
    one[4] = 150e3
    k5_offsets = (("no offsets", None), ("one offset (15 + 1)", one),
                  ("all offset", np.linspace(-90e3, 90e3, wb_k) + 1e3))
    for label, offs in (k5_offsets if "K5" in only else ()):
        g = channelizer.composed_rf_taps(wb_k, h_proto, rf_h, cfg.rf.decim,
                                         offsets_hz=offs, fs_ch=cfg.rf.fs)
        for ncap in (8, 1):
            raw = torch.randint(0, 256, (ncap, wb_k * cfg.block_size),
                                generator=gen, device=dev, dtype=torch.uint8)
            zi = torch.randint(0, 256, (ncap, 2 * (g.shape[1] - 1)),
                               generator=gen, device=dev, dtype=torch.uint8)
            a = (raw, g, zi, cfg.rf.decim)
            fn = lambda a=a: channelizer.composed_channelize_u8(*a)
            row = {"label": args.label, "kernel": "K5", "case": label,
                   "captures": ncap, "shape": list(raw.shape),
                   **timings(fn, "composed_kernel", ncap == 1)}
            if hasattr(channelizer, "composed_plan"):
                plan = channelizer.composed_plan(g, cfg.rf.decim)
                row["shared"], row["own"] = len(plan.shared), len(plan.own)
            if args.check:
                got = fn()
                want = channelizer.composed_channelize_u8_ref(*a, block=32)
                tol = 8e-6 * float(np.abs(g).sum(axis=1).max())
                e = float((got[0] - want[0]).abs().max())
                row["errors"] = {"y": e, "new_zi_bytes_differing":
                                 int((got[1] != want[1]).sum())}
                row["ok"] = e <= tol and row["errors"][
                    "new_zi_bytes_differing"] == 0
            emit(row)
            del raw, zi
            torch.cuda.empty_cache()

    # K6: mixers + resampler at the time-sharded receiver's shapes, each
    # arm: T = 4 stacked chunks (MODE0, MODE1_RDS) and one 15,360-sample
    # block of 1,024 channels.  A tree whose resample_mul2 has no segments
    # (the parent) runs the receiver's former route: the halo zi of each
    # chunk made in stock ops, then the kernel over the stacked rows; both
    # the kernel's device time and the route's (wrapper_ms / burst_ms)
    segmented = "segments" in inspect.signature(
        cuda_resample.resample_mul2).parameters
    arms = (("pair", "pair"), ("split", "split" if segmented else "auto"))
    k6_cases = [("T=4 stacked MODE0 (4 x 1024 x 3840)", 4, MODE0, 3840),
                ("1024 x 15360 (T = 1)", 1, MODE0, 15360),
                ("T=4 stacked MODE1_RDS (4 x 1024 x 4000)", 4, MODE1_RDS,
                 4000)]
    for label, t_sh, cfg_, n in (k6_cases if "K6" in only else []):
        comb = composed_resampler_taps(cfg_)
        up, down = cfg_.rds.up, cfg_.rds.down
        lead = (t_sh, 1024)
        t = torch.arange(n, device=dev, dtype=torch.float64)
        ph = 2 * np.pi * 57e3 / cfg_.rf.if_fs * t
        off = torch.rand((*lead, 1), generator=gen, device=dev,
                         dtype=torch.float64) * 6
        ext = (0.3 * torch.cos(ph + off) + 0.01 * torch.randn(
            (*lead, n), generator=gen, device=dev, dtype=torch.float64)
               ).float()
        ni = torch.cos(ph + 2 * off).float()
        nq = torch.sin(ph + 2 * off).float()
        zi = cuda_resample.resample_mul2_tail(ext[0], ni[0], nq[0],
                                              len(comb) - 1, up)
        for arm, impl in arms:
            if segmented:
                fn = (lambda impl=impl: cuda_resample.resample_mul2(
                    ext, ni, nq, comb, zi, up, down, impl=impl,
                    segments=t_sh))
            else:
                def fn(impl=impl):
                    tails = cuda_resample.resample_mul2_tail(
                        ext[:-1], ni[:-1], nq[:-1], len(comb) - 1, up)
                    halo = torch.cat([zi.unsqueeze(0), tails], 0)
                    y, z = cuda_resample.resample_mul2(
                        ext, ni, nq, comb, halo, up, down, impl=impl)
                    return y, z[-1]
            row = {"label": args.label, "kernel": "K6", "case": label,
                   "arm": arm, "segmented": segmented,
                   "shape": [*lead, n], "up": up, "down": down,
                   **timings(fn, "resample_mix_kernel", False)}
            if args.check:
                got = fn()
                tails = cuda_resample.resample_mul2_tail(
                    ext[:-1], ni[:-1], nq[:-1], len(comb) - 1, up)
                want = cuda_resample.resample_mul2_ref(
                    ext, ni, nq, comb, torch.cat([zi.unsqueeze(0), tails]),
                    up, down)
                sc = float(want[0].abs().max())
                row["errors"], row["ok"] = errs_of(
                    ("y", "new_zi"), got, (want[0], want[1][-1]),
                    {"y": 5e-6 * sc, "new_zi": 0.0})
            emit(row)
        del ext, ni, nq, zi
        torch.cuda.empty_cache()
    emit({"label": args.label, "card": card, "repo": args.repo,
          "torch": torch.__version__})
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
