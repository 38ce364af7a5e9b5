#!/usr/bin/env python3
"""Where one step of the port's receiver spends its device time.

    python3 tools/torch_profile_step.py [--channels 1024] [--steps 4]
        [--mode {0,1,1rds}] [--wideband K --captures B]
        [--time-shards T [--handoff {exact,stale,iterate}]
                         [--devices cuda:0,cuda:0,...]]
        [--no-rds] [--no-frame] [--resync] [--fuse-if-bank] [--eager]
        [--out FILE]
    python3 tools/torch_profile_step.py --scan K [--eager] [--out FILE]

Runs ``rtsdr_tpu_torch``'s ``Receiver(cfg, (C,))`` (``--mode 0``, the
default: the full mode-0 step, audio + RDS DSP + bit layer; ``--mode 1``:
MODE1, audio through the x24/125 resampler; ``--mode 1rds``: MODE1_RDS;
``--no-rds`` the audio step alone, ``--no-frame`` without the bit layer,
``--resync`` with the bit layer's sync walk (one launch of K7),
``--fuse-if-bank`` with the band-pass bank inside the ingest kernel) — or,
with ``--scan K``, the band scanner ``make_band_scanner(cfg, K)`` over the
same wideband captures as ``--wideband K`` (one capture per step), compiled
as the CLI runs it (``utils/jit.py::jit_fn``) — or,
with ``--wideband K --captures B``, ``make_wideband_receiver(cfg, K, (B,))``
(B captures at K x the RF rate per step, K x B stations; five live slots in
16, the rest empty) — or, with ``--time-shards T``, the time-sharded
receiver ``make_time_sharded_receiver(cfg, make_mesh(1, T, devices=[dev]),
C, pll_handoff=...)`` (each block split into T chunks stacked on the card;
with ``--devices`` the mesh ``make_mesh(None, T, devices)`` over that list,
the spread route for a grid of n_ch x T: ``cuda:0`` repeated T times puts
each time shard on its own stream of one card) — on
the GPU over noisy synthetic FM stations that carry RDS and traces
``--steps`` steady steps
with ``torch.profiler`` (CPU + CUDA activities), after timing as many
untraced steps on the host clock.  The step is the compiled one
(``utils/jit.py``: one CUDA graph replayed per step, what users run; on
the spread route one graph holds the T shards' branches); ``--eager`` runs
the eager step instead.  Each steady step's block comes as the runners'
loop brings it (``io/staging.py::run_blocks``): from a pinned staging buffer
of ``io/staging.py::Feeder`` (two blocks, filled before the window, in
turn) with one host-to-device copy straight into the compiled step's
input buffer (``step.input_buffer``; the eager step and a composition over
several devices get a new device tensor), then the step ``borrowed``, and
its outputs are fetched as that loop fetches them, one step behind
(``io/staging.py::Fetcher``: ``io/stream.py::fetch_list`` of a receiver's
outputs, every tensor of the scanner's).  The input's copy is reported on
its own (``input_h2d_ms_per_step``), and so are the fetch's copies
(``output_d2h_ms_per_step``, and ``output_d2d_ms_per_step``: every
device-to-device copy, the fetch's snapshot among them);
``step_busy_ms_per_step`` is the device time without the three.
Prints one JSON line (and writes it to ``--out FILE``, the step and PLL
times ``tools/torch_comm_model.py --profile FILE`` reads): which step ran, the card's name
and power limit, the host clock of the first step (a compiled step's
warm-ups and capture included) and per steady step, and device time per
step by kernel name (hand-written kernels and the stock PyTorch ops
around them), with the device's idle share of the traced window; from the
trace's device events, each stream's busy time, the time in which any
stream was busy (``device_busy_union_ms_per_step``, and the idle share
from it) and the time two or more streams overlapped.  If the
profiler reports no device time (CUPTI unavailable), says so instead.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtsdr_tpu_torch.config import MODE0, MODE1, MODE1_RDS  # noqa: E402
from rtsdr_tpu_torch.io.staging import Feeder, Fetcher  # noqa: E402
from rtsdr_tpu_torch.io.stream import fetch_list  # noqa: E402
from rtsdr_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from rtsdr_tpu_torch.parallel.timeshard import (  # noqa: E402
    make_time_sharded_receiver,
)
from rtsdr_tpu_torch.pipeline.receiver import Receiver  # noqa: E402
from rtsdr_tpu_torch.pipeline.wideband import (  # noqa: E402
    make_wideband_receiver,
)
from rtsdr_tpu_torch.pipeline.scan import make_band_scanner  # noqa: E402
from rtsdr_tpu_torch.utils.jit import (  # noqa: E402
    CompiledStep,
    ComposedStep,
    borrowing,
    jit_step,
)
from rtsdr_tpu_torch.utils.trace import profile  # noqa: E402
from rtsdr_tpu_torch.utils.signals import (  # noqa: E402
    encode_rds_blocks,
    fm_multiplex_iq,
    ps_station_words,
    rds_baseband,
    wideband_capture_iq,
)


def stream_times(prof, steps: int) -> dict:
    """Per step, from the trace's device events (kernels, copies, sets):
    each stream's busy time, the union over streams and the time two or
    more streams ran at once (the sum over streams less the union)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    spans, per_stream = [], {}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        spans.append((t0, t1))
        key = str(e.get("args", {}).get("stream", e.get("tid")))
        per_stream[key] = per_stream.get(key, 0.0) + (t1 - t0)
    union, end = 0.0, None
    for t0, t1 in sorted(spans):
        if end is None or t0 > end:
            union += t1 - t0
            end = t1
        elif t1 > end:
            union += t1 - end
            end = t1
    total = sum(per_stream.values())
    return {"stream_busy_ms_per_step": {k: v / 1e3 / steps
                                        for k, v in per_stream.items()},
            "device_busy_union_ms_per_step": union / 1e3 / steps,
            "streams_overlap_ms_per_step": (total - union) / 1e3 / steps}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--channels", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mode", choices=("0", "1", "1rds"), default="0")
    ap.add_argument("--wideband", type=int, default=None, metavar="K")
    ap.add_argument("--scan", type=int, default=None, metavar="K",
                    help="the band scanner over K slots")
    ap.add_argument("--captures", type=int, default=8, metavar="B",
                    help="with --wideband: captures per step")
    ap.add_argument("--time-shards", type=int, default=None, metavar="T")
    ap.add_argument("--handoff", choices=("exact", "stale", "iterate"),
                    default="exact", help="with --time-shards: PLL handoff")
    ap.add_argument("--devices", default=None, metavar="LIST",
                    help="with --time-shards: the mesh's devices, comma-"
                         "separated (cuda:0 repeated T times: the spread "
                         "route on one card)")
    ap.add_argument("--no-rds", action="store_true")
    ap.add_argument("--no-frame", action="store_true")
    ap.add_argument("--resync", action="store_true")
    ap.add_argument("--fuse-if-bank", action="store_true")
    ap.add_argument("--eager", action="store_true",
                    help="the eager step (default: the compiled one)")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="also write the JSON line to FILE")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    cfg = {"0": MODE0, "1": MODE1, "1rds": MODE1_RDS}[args.mode]
    n_blocks = 2 + 2 * args.steps

    def station(k):
        """Keyword arguments of station number k's multiplex."""
        return dict(mono_hz=700.0 + 130.0 * k, stereo_hz=1500.0 + 210.0 * k,
                    pilot_phase=0.37 * k,
                    rds_wave=rds_baseband(encode_rds_blocks(ps_station_words(
                        n_blocks + 4, 0x3A5C + k, f"STN {k:02d}  "))))

    kwargs = dict(enable_frame=not args.no_frame, resync=args.resync)
    if not args.time_shards:
        kwargs["fuse_if_bank"] = args.fuse_if_bank
    elif args.fuse_if_bank or args.wideband:
        ap.error("--time-shards takes neither --fuse-if-bank nor --wideband")
    if args.devices and not args.time_shards:
        ap.error("--devices goes with --time-shards")
    if args.no_rds or cfg.rds is None:
        kwargs["enable_rds"] = False
    if args.scan and (args.wideband or args.time_shards):
        ap.error("--scan takes neither --wideband nor --time-shards")
    if args.wideband or args.scan:
        # every K-th-of-three slot live, the rest empty; captures after the
        # first are the same band under their own noise
        k_w = args.wideband or args.scan
        c = 1 if args.scan else args.captures
        rows = wideband_capture_iq(
            n_blocks * cfg.iq_len, k_w,
            {slot: station(slot) for slot in range(1, k_w, 3)}, cfg.rf.fs
        ).reshape(n_blocks, 1, k_w * cfg.block_size)
        amp = 2
        if args.scan:
            # the scanner's step returns (metrics, state); one capture
            rows = rows[:, 0]
            init_fn, scan_fn = make_band_scanner(cfg, k_w, device=dev)
            if not args.eager:
                from rtsdr_tpu_torch.utils.jit import jit_fn

                scan_fn = jit_fn(scan_fn, dev, name="band scanner")

            def step_fn(state, raw, scan_fn=scan_fn):
                metrics, state = (scan_fn(state, raw) if args.eager
                                  else scan_fn.borrowed(state, raw))
                return state, metrics
            shape = {"scan_slots": k_w}
            kwargs = {}
        else:
            init_fn, step_fn = make_wideband_receiver(cfg, k_w, (c,),
                                                      **kwargs)
            if not args.eager:
                init_fn, step_fn = jit_step(init_fn, step_fn, dev)
            shape = {"wideband_slots": k_w, "captures": c,
                     "channels": k_w * c}
    else:
        c = args.channels
        rows = np.stack([
            fm_multiplex_iq(n_blocks * cfg.iq_len, cfg.rf.fs, **station(k)
                            ).reshape(n_blocks, cfg.block_size)
            for k in range(min(c, 8))], axis=1)            # (blocks, 8, B)
        amp = 8
        shape = {"channels": c}
        if args.time_shards:
            kwargs["pll_handoff"] = args.handoff
            mesh = (make_mesh(None, args.time_shards,
                              devices=args.devices.split(","))
                    if args.devices else
                    make_mesh(1, args.time_shards, devices=[dev]))
            init_fn, step_fn = make_time_sharded_receiver(
                cfg, mesh, c, jit=not args.eager, **kwargs)
            shape.update(time_shards=args.time_shards, spread=mesh.spread,
                         grid=[[str(d) for d in row]
                               for row in mesh.time_devices])
        else:
            rx = Receiver(cfg, (c,), jit=not args.eager, **kwargs)
            init_fn, step_fn = rx.init, rx.step
    rows = torch.as_tensor(rows).to(dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def block(b):
        if args.scan:
            return rows[b]
        x = rows[b].repeat(-(-c // rows.shape[1]), 1)[:c].to(torch.int16)
        x += torch.randint(-amp, amp + 1, x.shape, generator=gen, device=dev,
                           dtype=torch.int16)
        return x.clamp_(0, 255).to(torch.uint8)

    state = init_fn()
    first = block(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step_fn(state, first)       # compiled: warm-ups and capture
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    state, _ = step_fn(state, block(1))
    # the runners' input path: a pinned staging buffer, one copy into the
    # compiled step's input buffer, the step borrowed
    in_shape = tuple(first.shape)
    if args.scan:
        call, into = step_fn, (None if args.eager
                               else scan_fn.static_args()[1])
    else:
        call, into = borrowing(step_fn, in_shape)
    feeder = Feeder(in_shape, dev, into)
    for b in (2, 3):
        feeder.staging()[...] = block(b).cpu().numpy()
    fetcher = Fetcher(dev)
    fetch = ((lambda out: tuple(torch.utils._pytree.tree_leaves(out)))
             if args.scan else fetch_list)
    torch.cuda.synchronize()

    def steady(n):
        nonlocal state
        pending = None
        for _ in range(n):
            feeder.staging()         # the other pre-filled buffer
            state, out = call(state, feeder.push())
            ticket = fetcher.start(fetch(out))
            if pending is not None:
                fetcher.wait(pending)
            pending = ticket
        fetcher.wait(pending)

    # host clock over steady steps, without the profiler ...
    t0 = time.perf_counter()
    steady(args.steps)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # ... then the same number of steps traced
    with profile() as prof:
        steady(args.steps)
        torch.cuda.synchronize()

    def dev_us(e):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, name):
                return float(getattr(e, name))
        return 0.0

    streams = stream_times(prof, args.steps)
    kernels = {}
    for e in prof.key_averages():
        us = dev_us(e)
        # device-side rows only (an operator's row repeats its kernels' time)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = {"ms_per_step": us / 1e3 / args.steps,
                              "calls_per_step": e.count / args.steps}
    busy_ms = sum(k["ms_per_step"] for k in kernels.values())
    launches = sum(k["calls_per_step"] for k in kernels.values())
    copy_ms = {d: sum(k["ms_per_step"] for name, k in kernels.items()
                      if name.startswith(f"Memcpy {d}"))
               for d in ("HtoD", "DtoH", "DtoD")}
    result = {"card": card,
              "step": ("compiled" if isinstance(step_fn, (
                  CompiledStep, ComposedStep)) or (args.scan and not args.eager)
                  else "eager"),
              "mode": args.mode, **shape, "steps": args.steps,
              "receiver": kwargs,
              "input": ("pinned staging -> step.input_buffer "
                        "(io/staging.py::Feeder, as run_blocks)"
                        if into is not None else
                        "pinned staging -> a new device tensor"),
              "first_step_ms": first_ms,
              "wall_ms_per_step": wall_ms / args.steps,
              "device_launches_per_step": launches}
    if not kernels:
        result["device_time"] = "not measured (profiler saw no device time)"
    else:
        top = dict(sorted(kernels.items(),
                          key=lambda kv: -kv[1]["ms_per_step"])[:12])
        small = [k for name, k in kernels.items() if name not in top]
        result.update({
            "device_busy_ms_per_step": busy_ms,
            "input_h2d_ms_per_step": copy_ms["HtoD"],
            "output_d2h_ms_per_step": copy_ms["DtoH"],
            "output_d2d_ms_per_step": copy_ms["DtoD"],
            "step_busy_ms_per_step": busy_ms - sum(copy_ms.values()),
            "device_idle_share_of_wall": max(
                0.0, 1.0 - busy_ms / (wall_ms / args.steps)),
            **streams,
            "device_idle_share_of_wall_union": max(0.0, 1.0 - streams[
                "device_busy_union_ms_per_step"] / (wall_ms / args.steps)),
            "by_kernel": top,
            "all_other_kernels": {
                "ms_per_step": sum(k["ms_per_step"] for k in small),
                "calls_per_step": sum(k["calls_per_step"] for k in small)}})
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(result) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
