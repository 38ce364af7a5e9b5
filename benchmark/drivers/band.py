"""Entry driver ``band``: whole-band captures of a dense market already on
the card, several stations a slot, through the CLI's wideband loop
(``rtsdr_tpu_torch/cli.py::_wideband_decode`` with ``--wideband-centers``
listing every station).

Set-up builds the step as the CLI does: ``jit_step(*make_wideband_receiver(
cfg, K, batch_shape=(captures,), channel_offsets_hz=offsets_hz,
channel_slots=slots_of, ...), device)`` then ``borrowing`` (one CUDA graph,
the state donated; the channelizer's route is the configuration's
``channelizer_impl``).  Then the traffic's captures
(``traffic/synth_market.py``), on the device as ``ring_blocks`` per-step
slabs of every capture's next block.  It runs the first
``check.start_blocks`` steps through the same loop as the window.  Each
step: one device-to-device copy of the next slab into the step's input, the
step, and the fetch of the outputs (``io/stream.py::fetch_list``) through
``io/staging.py::Fetcher``, one step behind.  A block counts when its
outputs are on the host inside the window.

Streams: ``captures * S`` stations, stream s decoding station ``s //
captures`` of capture ``s % captures`` (its row ``(capture, station)``), so
that the check's window items, one in each equal part of the streams,
spread over the stations in the configuration's order.  What a stream
carries at a block (``block_of``) is its capture's bytes and its station,
as ``reference/front_band.py`` takes them.

With ``--trace 1`` the slice's kernels are kept by name
(``run.trace["kernels"]``: seconds each) for the channelizer's metrics.
"""

from __future__ import annotations

import time

import torch

from benchmark.drivers.wideband import kernels_by_name
from benchmark.harness import core, drive
from benchmark.traffic import synth_market


class Market:
    """The ring of whole-band captures from the seed, and each stream's
    capture and station at each of its blocks."""

    def __init__(self, ctx: core.Ctx):
        t0 = time.perf_counter()
        (self.ring, self.capture_of, self.offset, self.params,
         self.ring_dev) = synth_market.make_band(ctx.traffic, ctx.config,
                                                 ctx.seed, ctx.device)
        self.captures = ctx.traffic["captures"]
        self.stations = len(ctx.config["wideband"]["slots_of"])
        ctx.note(setup_part="traffic_synthesis_s",
                 seconds=time.perf_counter() - t0,
                 stations=[[{k: p[k] for k in ("station", "slot", "pi",
                                                "cnr_db", "detune_hz")}
                            for p in cap] for cap in self.params])

    def row(self, stream: int) -> tuple:
        """Stream ``stream``'s (capture, station)."""
        return stream % self.captures, stream // self.captures

    def block(self, stream: int, b: int):
        """What the stream carries at its block ``b``: (its capture's
        bytes, its station)."""
        c, j = self.row(stream)
        r = self.ring.shape[1]
        return self.ring[self.capture_of[c], (b + self.offset[c]) % r], j


def run(ctx: core.Ctx) -> core.Run:
    from rtsdr_tpu_torch.io.staging import Fetcher
    from rtsdr_tpu_torch.io.stream import fetch_list
    from rtsdr_tpu_torch.pipeline import wideband
    from rtsdr_tpu_torch.utils.jit import borrowing, jit_step

    dev = torch.device(ctx.device)
    cfg = core.port_config(ctx.config)
    wb = ctx.config["wideband"]
    n_cap, k = ctx.traffic["captures"], wb["slots"]
    wbs = k * ctx.config["block_size"]

    t0 = time.perf_counter()
    init_fn, step = jit_step(*wideband.make_wideband_receiver(
        cfg, k, batch_shape=(n_cap,), taps_per_branch=wb["taps_per_branch"],
        channel_offsets_hz=wb["offsets_hz"], channel_slots=wb["slots_of"],
        channelizer_impl=wb["channelizer_impl"], device=dev,
        **core.receiver_kwargs(ctx.config)), dev,
        name=f"wideband receiver K={k}, {len(wb['slots_of'])} stations")
    call, raw = borrowing(step, (n_cap, wbs))
    fetcher = Fetcher(dev)
    state = init_fn()
    ctx.note(setup_part="receiver_s", seconds=time.perf_counter() - t0)

    band = Market(ctx)
    n_ring = ctx.traffic["ring_blocks"]
    t0 = time.perf_counter()
    capture_of = torch.as_tensor(band.capture_of, device=dev)
    offset = torch.as_tensor(band.offset, device=dev)
    slabs = torch.empty((n_ring, n_cap, wbs), dtype=torch.uint8, device=dev)
    for t in range(n_ring):
        slabs[t] = band.ring_dev[capture_of, (t + offset) % n_ring]
    band.ring_dev = None
    ctx.note(setup_part="slabs_s", seconds=time.perf_counter() - t0,
             bytes=slabs.numel())

    n_streams = n_cap * band.stations
    samples = drive.Samples(ctx, n_streams,
                            rows=[band.row(s) for s in range(n_streams)])
    trace = drive.Slice(ctx, dev)
    done_at: list = []
    pending = None

    def drain(ticket):
        k_step, tk = ticket
        arrays = fetcher.wait(tk)
        done_at.append(time.perf_counter())
        samples.outputs(k_step, lambda row: drive.host_outputs(arrays, row))

    def one_step(k_step: int, window_t0):
        nonlocal state, pending
        now = time.perf_counter()
        trace.tick(k_step, now, window_t0)
        samples.before_step(k_step, state.rx, now)
        with ctx.span("feed"):
            raw.copy_(slabs[k_step % n_ring], non_blocking=True)
        with ctx.span("step"):
            state, out = call(state, raw)
        ticket = (k_step, fetcher.start(fetch_list(out)))
        if pending is not None:
            with ctx.span("fetch_wait"):
                drain(pending)
        pending = ticket

    t0 = time.perf_counter()
    warm = samples.start_blocks
    for k_step in range(warm):
        one_step(k_step, None)
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
    k_step = warm
    while time.perf_counter() < w0 + ctx.seconds:
        one_step(k_step, w0)
        k_step += 1
    drain(pending)
    end = w0 + ctx.seconds
    blocks = sum(1 for t in done_at[first_done:] if t <= end)
    peak = drive.memory_peak(dev)
    trace_summary = trace.summary()
    if trace_summary is not None:
        trace_summary["kernels"] = kernels_by_name(trace.tracer.events)
    del slabs, step, call, state, raw
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return core.Run(setup_s=setup_s, window_s=ctx.seconds,
                    channels=n_streams, blocks_done=blocks,
                    attempted=blocks * n_streams, failed=0,
                    items=samples.finished(), block_of=band.block,
                    memory_peak_bytes=peak, trace=trace_summary)
