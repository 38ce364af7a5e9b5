"""Entry driver ``stream``: one live station through
``io/stream.py::StreamRunner``, the plain ``rtsdr-tpu-torch 0`` pipeline.

Set-up builds the runner and runs it once over a pipe holding the first
``check.start_blocks`` blocks of the stream (the step's capture, the
staging buffers, the reader): the runner's own loop, warmed.  The measured
run is a second ``run`` over a new pipe, from the receiver's initial state,
written by ``benchmark/traffic/feeder.py`` in a process of its own on an
open loop at the air rate: block b in one write at ``t0 + (b + 1) * 64 ms``
(``CLOCK_MONOTONIC``).  The runner's ``emit`` stamps each block's int16
audio.  The window holds the blocks due after the traffic's
``lead_blocks``, ``--seconds`` of them, and one block more is written
after it, so that every block in the window is followed by another, as on
the air.  A block's latency runs from when its last byte was due to its
emit; a block never emitted fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from benchmark.harness import check, core, drive


def run(ctx: core.Ctx) -> core.Run:
    from rtsdr_tpu_torch.io.stream import StreamRunner

    dev = torch.device(ctx.device)
    cfg = core.port_config(ctx.config)
    traffic = drive.Traffic(ctx)
    bs = ctx.config["block_size"]
    scale = ctx.config["audio_scale"]
    period = core.AIR_SECONDS_PER_BLOCK

    t0 = time.perf_counter()
    runner = StreamRunner(cfg, torch.float32, device=dev, jit=True,
                          **core.receiver_kwargs(ctx.config))
    ctx.note(setup_part="receiver_s", seconds=time.perf_counter() - t0)

    samples = drive.Samples(ctx, 1, batched=False)
    trace = drive.Slice(ctx, dev)
    compiled = runner.rx.step
    inner = compiled.borrowed
    calls = {"k": 0, "window_t0": None}

    def borrowed(state, raw):
        k = calls["k"]
        now = time.perf_counter()
        trace.tick(k, now, calls["window_t0"])
        samples.before_step(k, state, now)
        calls["k"] = k + 1
        with ctx.span("step"):
            return inner(state, raw)
    compiled.borrowed = borrowed     # StreamRunner.run takes it from here

    # warm-up: the runner's own loop over the stream's first blocks
    t0 = time.perf_counter()
    warm = samples.start_blocks
    r_fd, w_fd = os.pipe()

    def fill():
        with os.fdopen(w_fd, "wb") as f:
            for b in range(warm):
                f.write(traffic.block(0, b).tobytes())
    writer = threading.Thread(target=fill)
    writer.start()
    runner.run(r_fd, emit=lambda pcm: None)
    writer.join()
    os.close(r_fd)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ctx.note(setup_part="warmup_and_capture_s",
             seconds=time.perf_counter() - t0, blocks=warm)

    # the measured run: a fresh stream at the air rate
    lead = ctx.traffic["lead_blocks"]
    n_window = int(round(ctx.seconds / period))
    n_blocks = lead + n_window + 1
    calls["k"] = 0
    emitted: dict = {}
    frames: dict = {}

    def emit(pcm: bytes):
        b = len(emitted)
        emitted[b] = time.monotonic()
        if b < samples.start_blocks or b in samples.wanted:
            x = np.frombuffer(pcm, np.int16).astype(np.float64) / scale
            frames.setdefault(b, {})["audio"] = (x[0::2], x[1::2])

    def frame_hook(fo):
        b = len(frames_seen)
        frames_seen.append(b)
        if b in frames:
            frames[b]["frame"] = check.frame_dict(fo)
            left, right = frames[b]["audio"]
            samples.outputs(b, lambda c: {"left": left, "right": right,
                                          "frame": frames[b]["frame"]})
    frames_seen: list = []

    r_fd, w_fd = os.pipe()
    feeder = os.path.join(core.BENCH_DIR, "traffic", "feeder.py")
    proc = subprocess.Popen([sys.executable, feeder], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, pass_fds=[w_fd])
    head = {"mode": "air", "fds": [w_fd], "shape": list(traffic.ring.shape),
            "station": [int(traffic.station[0])],
            "offset": [int(traffic.offset[0])], "period": period,
            "n_blocks": n_blocks}
    proc.stdin.write((json.dumps(head) + "\n").encode())
    proc.stdin.write(traffic.ring.tobytes())
    proc.stdin.flush()
    if proc.stdout.readline().strip() != b"ready":
        raise RuntimeError("the feeder did not start")
    t_start = time.monotonic() + 0.1
    proc.stdin.write(f"{t_start!r}\n".encode())
    proc.stdin.close()
    os.close(w_fd)
    window_t0 = t_start + lead * period
    setup_s = core.process_age_s() + max(0.0, window_t0 - time.monotonic())
    samples.start_window(time.perf_counter()
                         + max(0.0, window_t0 - time.monotonic()))
    calls["window_t0"] = samples.window_t0
    try:
        runner.run(r_fd, emit=emit, frame_hook=frame_hook)
    finally:
        os.close(r_fd)
        out = proc.stdout.read()
        proc.wait(timeout=120)
    late = np.asarray(json.loads(out)["late_s"]) * 1e3
    ctx.note(generator_late_ms={"median": float(np.median(late)),
                                "p95": float(np.percentile(late, 95)),
                                "max": float(late.max()),
                                "blocks": int(len(late))})
    latencies = []
    failed = 0
    for b in range(lead, lead + n_window):
        if b in emitted:
            latencies.append(emitted[b] - (t_start + (b + 1) * period))
        else:
            failed += 1
    peak = drive.memory_peak(dev)
    trace_summary = trace.summary()
    del runner
    return core.Run(setup_s=setup_s, window_s=n_window * period, channels=1,
                    blocks_done=len(latencies), attempted=n_window,
                    failed=failed, items=samples.finished(),
                    block_of=traffic.block, memory_peak_bytes=peak,
                    latencies_s=latencies, trace=trace_summary)
