#!/usr/bin/env python3
"""The FIR-bank (K2) and PLL (K3) kernels alone, at the shapes the receivers
give them, on one GPU.

    python3 tools/torch_profile_kernels.py [--repo DIR] [--label NAME]
        [--check] [--host-breakdown] [--out FILE]

Imports ``rtsdr_tpu_torch`` from ``--repo`` (default: this checkout), so
that the same script times another tree's kernels, such as a ``git
archive`` of a parent commit, through the same wrapper signatures
(``cuda_fir.fir_bank_carried``, ``cuda_pll.pll_cuda``).  Per shape:

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

With ``--check`` each case is also held against its plain version (K2:
2e-6 max|ref|; K3 over 2 lanes of a locked pilot and carrier: NCO 5e-5).
Prints one JSON line per case and a last line with the card's name and power
limit; ``--out`` appends the lines to a file too.
"""

import argparse
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
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--host-breakdown", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))

    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile_kernels: no CUDA device", file=sys.stderr)
        return 1
    from rtsdr_tpu_torch.config import MODE0
    from rtsdr_tpu_torch.ops import _cuda, coeffs, cuda_fir, cuda_pll
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
    for label, pre, hl, s, shape in bank_cases:
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
    for label, lanes, n, div, delay, pair in pll_cases:
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
    emit({"label": args.label, "card": card, "repo": args.repo,
          "torch": torch.__version__})
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
