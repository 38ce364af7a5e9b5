#!/usr/bin/env python3
"""Channel sweep to the real-time knee, and the single-station latency, of
the port's receiver on one card.

    python3 tools/torch_scaling_sweep.py [--channels 1 64 ... 8192]
        [--chains mono full] [--repeats 8] [--latency-runs 8]
        [--mesh] [--out FILE] [--device cuda|cpu]

Counterpart of ``tools/scaling_sweep.py``.  For the mono chain
(``enable_rds=False, enable_stereo=False``) and the full MODE0 chain, at
each channel count C the compiled ``Receiver(MODE0, (C,))`` steps over one
block of random bytes written once into the step's input buffer
(``step.input_buffer``), so the host link is left out as in the JAX tool;
the steps use ``borrowed``, as the runners do.  Time per step is a slope
(``slope_seconds``, the scheme of ``bench.py::_bench_chain``): K2 = 24 and
K1 = 4 dependent steps from a fresh state, one synchronisation at the end,
each the minimum over ``--repeats`` runs.  Each count reports
``ms_per_step``, ``realtime_multiple`` (C x 64 ms / step: stations decoded
in real time), ``iq_msamples_per_sec`` and the device's peak allocated
memory above what the process held before the count.  The counts run in
order; before each, the last count's peak scaled by C, on top of what the
process holds, says whether it fits on the card, and the sweep of a chain stops at
the first count that does not (or that runs out of memory).  Each chain
reports its best count (the knee) and ``single_station_latency_ms`` (the
step at C = 1).

Then ``stream_latency``: one block's trip through the compiled
``StreamRunner`` at C = 1 with the CLI's settings (``resync`` on), on the
host clock.  A writer thread feeds a pipe at the air rate (one
307,200-byte block per 64 ms) and notes when each block's last byte went
in; the runner's ``emit`` notes when that block's int16 audio came out.
The runner releases block b's audio after it has queued block b + 1 (its
fetch overlaps the next step), so a block followed by another waits for
it: ``held_back_ms``; the last block of a stream, followed by the end of
the stream, gives the runner's own latency, read + copy in + replay +
fetch + int16 out: ``last_block_ms``, one per run.  A first stream, left
out of every figure but ``capture_run_ms``, takes the warm-ups and the
capture (they hold up the blocks behind block 0 too).

``--mesh`` runs ``parallel/scaling.py::measure_scaling`` over the devices
present (the counterpart of ``--cpu-mesh``); the record says how many
there were.

One JSON line per record, each with the card's name and power limit, and
the whole result written to ``--out`` (default ``SCALING_torch.json``).
``--device cpu`` runs the same code on the kernels' plain versions: it
shows the path works, and no time from it is a device time.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtsdr_tpu_torch.config import MODE0  # noqa: E402
from rtsdr_tpu_torch.device import resolve_device  # noqa: E402
from rtsdr_tpu_torch.io.stream import StreamRunner  # noqa: E402
from rtsdr_tpu_torch.pipeline.receiver import Receiver  # noqa: E402
from rtsdr_tpu_torch.utils.jit import borrowing  # noqa: E402
from rtsdr_tpu_torch.utils.signals import (  # noqa: E402
    encode_rds_blocks,
    fm_multiplex_iq,
    ps_station_words,
    rds_baseband,
)

CHANNELS = (1, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
CHAINS = {"mono": dict(enable_rds=False, enable_stereo=False), "full": {}}
K1, K2, REPEATS = 4, 24, 8
#: air time of one block: 153,600 I/Q pairs at 2.4 MS/s = 64 ms
BLOCK_S = MODE0.iq_len / MODE0.rf.fs
#: fraction of the card's memory a predicted peak may take
MEMORY_HEADROOM = 0.9


def card_of(device: torch.device) -> str | None:
    """``nvidia-smi``'s name and power limit of the card, None on the
    CPU."""
    if device.type != "cuda":
        return None
    from rtsdr_tpu_torch.utils.profiling import card_name_and_power_limit

    return card_name_and_power_limit()


def slope_seconds(step, init_fn, raw: torch.Tensor, k1: int = K1,
                  k2: int = K2, repeats: int = REPEATS) -> float:
    """Seconds per call of ``step(state, raw)``: (t(k2) - t(k1)) / (k2 -
    k1), each t the minimum over ``repeats`` runs of k dependent steps from
    a fresh ``init_fn()`` state, one synchronisation at the end (host
    clock).  A compiled step gets ``raw`` written once into its input
    buffer and is called ``borrowed``; the first run takes the capture."""
    device = raw.device
    call, buf = borrowing(step, raw.shape)
    if buf is not None:
        buf.copy_(raw)
        raw = buf

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run(k):
        state = init_fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(k):
            state, _ = call(state, raw)
        sync()
        return time.perf_counter() - t0

    run(k1)
    run(k2)
    t1 = min(run(k1) for _ in range(repeats))
    t2 = min(run(k2) for _ in range(repeats))
    return max(t2 - t1, 1e-9) / (k2 - k1)


def chain_record(chain: str, n_ch: int, sec: float, peak) -> dict:
    return {"chain": chain, "channels": n_ch, "ms_per_step": sec * 1e3,
            "realtime_multiple": n_ch * BLOCK_S / sec,
            "iq_msamples_per_sec": n_ch * MODE0.iq_len / sec / 1e6,
            "max_memory_allocated_bytes": peak}


def sweep_chain(chain: str, counts, device="cuda", k1=K1, k2=K2,
                repeats=REPEATS, card=None) -> list[dict]:
    """One record per channel count of ``counts`` (in order) for chain
    ``chain`` of ``CHAINS``; the last record has ``fits: False`` where a
    count would not fit on the card (predicted from the last peak, or out
    of memory), and the sweep stops there."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    total = torch.cuda.get_device_properties(dev).total_memory if cuda else 0
    rng = np.random.default_rng(0)
    recs, last = [], None
    for n_ch in counts:
        if cuda:
            torch.cuda.empty_cache()
            # what the process held before: the count's own peak is above it
            held = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        if cuda and last is not None:
            predicted = held + last[1] * n_ch / last[0]
            if predicted > MEMORY_HEADROOM * total:
                recs.append({"chain": chain, "channels": n_ch, "fits": False,
                             "predicted_peak_bytes": int(predicted),
                             "card_memory_bytes": total, "card": card})
                break
        raw = torch.as_tensor(rng.integers(
            0, 256, (n_ch, MODE0.block_size), dtype=np.uint8)).to(dev)
        rx = Receiver(MODE0, (n_ch,), device=dev, **CHAINS[chain])
        try:
            sec = slope_seconds(rx.step, rx.init, raw, k1, k2, repeats)
        except torch.OutOfMemoryError as e:
            recs.append({"chain": chain, "channels": n_ch, "fits": False,
                         "out_of_memory": str(e).splitlines()[0],
                         "card_memory_bytes": total, "card": card})
            break
        finally:
            del rx, raw
        peak = torch.cuda.max_memory_allocated(dev) - held if cuda else None
        recs.append({**chain_record(chain, n_ch, sec, peak), "fits": True,
                     "card": card})
        last = (n_ch, peak)
    return recs


def knee(recs: list[dict]) -> dict:
    """The record with the highest real-time multiple among those that
    ran: the most stations the card decodes in real time."""
    return max((r for r in recs if r.get("fits", True)),
               key=lambda r: r["realtime_multiple"])


def _station_stream(n_blocks: int) -> np.ndarray:
    """``n_blocks`` blocks of one RDS-bearing stereo station, interleaved
    u8."""
    wave = rds_baseband(encode_rds_blocks(ps_station_words(
        n_blocks + 4, 0x3A5C, "H100 FM ")))
    return fm_multiplex_iq(n_blocks * MODE0.iq_len, MODE0.rf.fs,
                           rds_wave=wave)


def stream_latency(device="cuda", runs: int = 8, blocks: int = 4,
                   pace_s: float = BLOCK_S, card=None, **rx_kwargs) -> dict:
    """Host-clock latency of a block through one compiled ``StreamRunner``
    (C = 1; ``rx_kwargs`` go to it, default the CLI's ``resync=True``):
    ``runs`` streams of ``blocks`` blocks written at one block per
    ``pace_s``, after one that takes the capture.  See the module's
    docstring for what each figure is."""
    dev = resolve_device(device)
    rx_kwargs = {"resync": True, **rx_kwargs}
    runner = StreamRunner(MODE0, device=dev, **rx_kwargs)
    payload = _station_stream(blocks).reshape(blocks, MODE0.block_size)
    held, last, release, capture_run = [], [], [], None
    n_bytes = 0
    for run in range(runs + 1):
        r_fd, w_fd = os.pipe()
        written = [0.0] * blocks
        emitted: list = []

        def writer(w_fd=w_fd, written=written):
            t0 = time.perf_counter()
            try:
                for b in range(blocks):
                    delay = t0 + b * pace_s - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
                    view = memoryview(payload[b])
                    while view:
                        view = view[os.write(w_fd, view):]
                    written[b] = time.perf_counter()
            finally:
                os.close(w_fd)

        def emit(pcm, emitted=emitted):
            emitted.append((time.perf_counter(), len(pcm)))

        th = threading.Thread(target=writer, daemon=True)
        th.start()
        try:
            stats = runner.run(r_fd, emit=emit, rds_log=lambda line: None)
        finally:
            os.close(r_fd)
        th.join(timeout=60)
        if th.is_alive() or stats["blocks"] != blocks or len(emitted) != blocks:
            raise RuntimeError(f"stream_latency: {stats['blocks']} blocks "
                               f"read, {len(emitted)} emitted of {blocks}")
        lat = [(emitted[b][0] - written[b]) * 1e3 for b in range(blocks)]
        if run == 0:
            capture_run = lat
            continue
        held += lat[:-1]
        last.append(lat[-1])
        release += [(emitted[b][0] - written[b + 1]) * 1e3
                    for b in range(blocks - 1)]
        n_bytes += sum(n for _, n in emitted)
    return {"stream_latency": {
        "channels": 1, "receiver": rx_kwargs, "runs": runs,
        "blocks_per_run": blocks, "pace_ms": pace_s * 1e3,
        "last_block_ms": last,
        "last_block_ms_median": statistics.median(last),
        "held_back_ms_median": statistics.median(held) if held else None,
        "held_back_ms_max": max(held) if held else None,
        "release_after_next_block_ms_median":
            statistics.median(release) if release else None,
        "capture_run_ms": capture_run, "int16_bytes_out": n_bytes,
        "int16_bytes_expected": runs * blocks * MODE0.audio_len * 4,
        "device": str(dev), "card": card}}


def mesh_records(card=None) -> dict:
    """``measure_scaling`` over the CUDA devices present."""
    from rtsdr_tpu_torch.parallel.scaling import measure_scaling

    recs = measure_scaling(MODE0, channels_per_device=4,
                           enable_rds=False, enable_stereo=False)
    return {"devices_present": torch.cuda.device_count(),
            "note": "measure_scaling over every CUDA device of this "
                    "machine; one device is no scaling",
            "records": recs, "card": card}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--channels", type=int, nargs="+", default=CHANNELS)
    ap.add_argument("--chains", nargs="+", choices=tuple(CHAINS),
                    default=tuple(CHAINS))
    ap.add_argument("--repeats", type=int, default=REPEATS)
    ap.add_argument("--latency-runs", type=int, default=8,
                    help="streams for stream_latency (0: none)")
    ap.add_argument("--mesh", action="store_true",
                    help="measure_scaling over the devices present, instead "
                         "of the sweep")
    ap.add_argument("--out", default="SCALING_torch.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_of(dev)

    if args.mesh:
        data = {"mesh_weak_scaling": mesh_records(card)}
        print(json.dumps(data), flush=True)
    else:
        data = {"device": str(dev), "card": card, "torch": torch.__version__,
                "input": "written once into step.input_buffer (host link "
                         "excluded)", "k1": K1, "k2": K2,
                "repeats": args.repeats}
        for chain in args.chains:
            recs = sweep_chain(chain, args.channels, dev,
                               repeats=args.repeats, card=card)
            for r in recs:
                print(json.dumps(r), flush=True)
            data[chain] = recs
            data[f"{chain}_best"] = knee(recs)
            data[f"{chain}_single_station_latency_ms"] = next(
                (r["ms_per_step"] for r in recs if r["channels"] == 1), None)
            print(json.dumps({"chain": chain, "knee": data[f"{chain}_best"],
                              "card": card}), flush=True)
        if args.latency_runs:
            data.update(stream_latency(dev, args.latency_runs, card=card))
            print(json.dumps({"stream_latency": data["stream_latency"]}),
                  flush=True)
    with open(args.out, "w") as f:
        json.dump(data, f, indent=1)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
