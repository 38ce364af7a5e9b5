#!/usr/bin/env python3
"""Does a trace of one compiled MODE0 step show K1-K4 on the card, run after
run?

    python3 tools/torch_trace_check.py [--runs 25] [--channels 1024]
        [--interval SECONDS] [--out FILE]

Each run does what ``chip_smoke.py``'s ``trace`` phase does, after what the
phases before it do: one ``torch.profiler`` session over one replay of the
previous run's compiled step and one eager C = 1 step (as the smoke's
launch counts and kernel timings profile replays and eager kernels), then a
new compiled ``Receiver(MODE0, (C,))`` built and captured, then one step of
it traced under ``utils/trace.py`` (``trace_step``, the phase's own body).
It counts each of K1-K4's device events (``cat == "kernel"`` in the Chrome
trace, by ``__global__`` name) and every device kernel event, and where
the device events lie against the host's: the first kernel's start after
the graph's launch call, after the first host event, and the last host
event's end after the last kernel's (microseconds; each should be >= 0 on
one shared clock).  Prints one
JSON line per run and a last line with the runs that lacked a kernel, the
card's name and power limit, and the ``TEARDOWN_CUPTI`` setting the runs
saw.  Every session opens through ``utils/trace.py::profile``, which has
CUPTI torn down after each; with ``TEARDOWN_CUPTI=0`` in the environment
CUPTI stays up, and ``--interval 8`` (a process that lives a few minutes)
shows the first kernels of the traced step lost.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtsdr_tpu_torch.config import MODE0  # noqa: E402
from rtsdr_tpu_torch.pipeline.receiver import Receiver  # noqa: E402
from rtsdr_tpu_torch.utils.trace import profile, trace  # noqa: E402

#: the CUDA kernels of K1-K4 (their ``__global__`` names), which a trace of
#: one MODE0 step must show as device events
TRACE_KERNELS = {"K1": "ingest_kernel", "K2": "fir_bank_kernel",
                 "K3": "pll_kernel", "K4": "resample_rrc_kernel"}


def trace_step(step, state, raw) -> tuple:
    """One call ``step(state, raw)`` under ``utils/trace.py``: ``(state,
    report)``, the report counting the Chrome trace's files, events, device
    kernel events and the events of each of ``TRACE_KERNELS``."""
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            state, _ = step(state, raw)
        files = [f for f in os.listdir(tmp) if f.endswith(".json")]
        with open(os.path.join(tmp, files[0])) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    seen = {k: sum(1 for e in kernels if name in e.get("name", ""))
            for k, name in TRACE_KERNELS.items()}
    rep = {"trace_files": len(files), "events": len(events),
           "device_kernel_events": len(kernels),
           "kernel_events_by_kernel": seen,
           "all_seen": len(files) == 1 and all(seen.values())}
    # where the device events lie against the host's: a graph's kernels
    # start after its launch call on a clock that both share
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and "GraphLaunch" in e.get("name", "")]
    host = [e for e in events if e.get("cat") in (
        "cpu_op", "user_annotation", "python_function", "cuda_runtime")]
    if kernels and launches and host:
        k0 = min(float(e["ts"]) for e in kernels)
        k1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in kernels)
        rep.update(
            first_kernel_after_graph_launch_us=k0 - float(launches[-1]["ts"]),
            first_kernel_after_first_host_event_us=k0 - min(
                float(e["ts"]) for e in host),
            last_host_event_end_after_last_kernel_us=max(
                float(e["ts"]) + float(e.get("dur", 0)) for e in host) - k1)
    return state, rep


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--runs", type=int, default=25)
    ap.add_argument("--channels", type=int, default=1024)
    ap.add_argument("--interval", type=float, default=0.0,
                    metavar="SECONDS",
                    help="idle time between runs (a long-lived process)")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="also write the JSON lines to FILE")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def block(c):
        return torch.randint(0, 256, (c, MODE0.block_size), generator=gen,
                             device=dev, dtype=torch.uint8)

    small = Receiver(MODE0, (1,), jit=False)
    small_st, small_raw = small.init(), block(1)
    lines, prev = [], None
    t_start = time.perf_counter()
    for run in range(args.runs):
        if run:
            time.sleep(args.interval)
        t0 = time.perf_counter()
        if prev is not None:
            # what the phases before the trace do: a profiler session over
            # a graph replay and eager kernels
            p_step, p_st = prev
            with profile():
                p_st, _ = p_step(p_st, block(args.channels))
                small_st, _ = small.step(small_st, small_raw)
                torch.cuda.synchronize()
            prev = None
        rx = Receiver(MODE0, (args.channels,))
        st, _ = rx.step(rx.init(), block(args.channels))       # capture
        torch.cuda.synchronize()
        st, rep = trace_step(rx.step, st, block(args.channels))
        prev = (rx.step, st)
        rep.update(run=run, seconds=time.perf_counter() - t0,
                   process_seconds=time.perf_counter() - t_start)
        lines.append(rep)
        print(json.dumps(rep), flush=True)
    missed = [r["run"] for r in lines if not r["all_seen"]]
    summary = {"summary": "trace_check", "runs": args.runs,
               "channels": args.channels, "runs_missing_a_kernel": missed,
               "pid": os.getpid(),
               "TEARDOWN_CUPTI": os.environ.get("TEARDOWN_CUPTI"),
               "card": card, "torch": torch.__version__,
               "cuda": torch.version.cuda}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in lines + [summary]:
                f.write(json.dumps(r) + "\n")
    return 0 if not missed else 1


if __name__ == "__main__":
    sys.exit(main())
