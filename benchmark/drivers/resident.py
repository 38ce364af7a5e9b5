"""Entry driver ``resident``: the captures already on the card, through
``Receiver``'s documented loop.

Set-up builds the traffic's ring, puts it on the device as
``ring_blocks`` per-step slabs of every stream's next block, builds
``Receiver(cfg, (C,))`` (compiled: its first step captures the CUDA
graph) and runs the first ``check.start_blocks`` steps through the same
loop as the window.  Each step: one device-to-device copy of the next
slab into ``rx.step.input_buffer``, ``rx.step.borrowed``, and the fetch of
the outputs (``io/stream.py::fetch_list``: L, R and the bit layer's
leaves) through ``io/staging.py::Fetcher``, one step behind, as
``io/batch.py::BatchRunner.run`` does.  The window runs steps until
``--seconds`` have passed; a block counts when its outputs are on the
host inside the window.
"""

from __future__ import annotations

import time

import torch

from benchmark.harness import core, drive


def run(ctx: core.Ctx) -> core.Run:
    from rtsdr_tpu_torch.io.staging import Fetcher
    from rtsdr_tpu_torch.io.stream import fetch_list
    from rtsdr_tpu_torch.pipeline.receiver import Receiver

    dev = torch.device(ctx.device)
    cfg = core.port_config(ctx.config)
    traffic = drive.Traffic(ctx)
    c_n, bs = traffic.streams, ctx.config["block_size"]
    n_ring = ctx.traffic["ring_blocks"]

    t0 = time.perf_counter()
    ring = traffic.ring_dev
    station = torch.as_tensor(traffic.station, device=dev)
    offset = torch.as_tensor(traffic.offset, device=dev)
    slabs = torch.empty((n_ring, c_n, bs), dtype=torch.uint8, device=dev)
    for t in range(n_ring):
        slabs[t] = ring[station, (t + offset) % n_ring]
    del ring
    traffic.ring_dev = None
    ctx.note(setup_part="slabs_s", seconds=time.perf_counter() - t0,
             bytes=slabs.numel())

    t0 = time.perf_counter()
    rx = Receiver(cfg, (c_n,), torch.float32, device=dev, jit=True,
                  **core.receiver_kwargs(ctx.config))
    raw = rx.step.input_buffer((c_n, bs))
    fetcher = Fetcher(dev)
    state = rx.init()
    ctx.note(setup_part="receiver_s", seconds=time.perf_counter() - t0)

    samples = drive.Samples(ctx, c_n)
    trace = drive.Slice(ctx, dev)
    done_at: list = []
    pending = None

    def drain(ticket):
        k, tk = ticket
        arrays = fetcher.wait(tk)
        done_at.append(time.perf_counter())
        samples.outputs(k, lambda c: drive.host_outputs(arrays, c))

    def step(k: int, window_t0):
        nonlocal state, pending
        now = time.perf_counter()
        trace.tick(k, now, window_t0)
        samples.before_step(k, state, now)
        with ctx.span("feed"):
            raw.copy_(slabs[k % n_ring], non_blocking=True)
        with ctx.span("step"):
            state, out = rx.step.borrowed(state, raw)
        ticket = (k, fetcher.start(fetch_list(out)))
        if pending is not None:
            with ctx.span("fetch_wait"):
                drain(pending)
        pending = ticket

    t0 = time.perf_counter()
    warm = samples.start_blocks
    for k in range(warm):
        step(k, None)
    drain(pending)
    pending = None
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ctx.note(setup_part="warmup_and_capture_s",
             seconds=time.perf_counter() - t0, steps=warm)

    setup_s = core.process_age_s()
    w0 = time.perf_counter()
    samples.start_window(w0)
    first_done = len(done_at)
    k = warm
    while time.perf_counter() < w0 + ctx.seconds:
        step(k, w0)
        k += 1
    drain(pending)
    end = w0 + ctx.seconds
    blocks = sum(1 for t in done_at[first_done:] if t <= end)
    peak = drive.memory_peak(dev)
    trace_summary = trace.summary()
    del slabs, rx, state, raw
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return core.Run(setup_s=setup_s, window_s=ctx.seconds, channels=c_n,
                    blocks_done=blocks, attempted=blocks * c_n, failed=0,
                    items=samples.finished(), block_of=traffic.block,
                    memory_peak_bytes=peak, trace=trace_summary)
