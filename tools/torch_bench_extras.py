#!/usr/bin/env python3
"""Throughput of the port beyond the MODE0 chains: mode 1, MODE1_RDS and the
wideband receiver, compiled, on one card.

    python3 tools/torch_bench_extras.py [--channels 512] [--slots 16]
        [--captures 8] [--repeats 8] [--out FILE] [--device cuda|cpu]

Counterpart of ``tools/bench_extras.py``:

  * mode 1 (2.5 MS/s, the x24/125 audio resampler, RDS off: the reference's
    mode-1 product), ``Receiver(MODE1, (C,))``;
  * MODE1_RDS, ``Receiver(MODE1_RDS, (C,))``;
  * the wideband receiver, ``make_wideband_receiver(MODE0, K, (B,))``
    compiled (``utils/jit.py::jit_step``): B captures of K slots per step,
    K x B stations.

Each is timed by ``tools/torch_scaling_sweep.py::slope_seconds`` (K2 = 24
and K1 = 4 dependent steps, one synchronisation, minimum over repeats)
over one block of random bytes written once into the step's input buffer.
One JSON line per receiver: ms per step and stations decoded in real time
(stations x 64 ms / step), with the card's name and power limit.  The
band scanner's compiled step is timed by ``tools/torch_profile_step.py
--scan 16``.  ``--device cpu`` runs the plain versions (no device time).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_scaling_sweep import K1, K2, REPEATS, card_of, slope_seconds  # noqa: E402,I001

from rtsdr_tpu_torch.config import MODE0, MODE1, MODE1_RDS  # noqa: E402
from rtsdr_tpu_torch.device import resolve_device  # noqa: E402
from rtsdr_tpu_torch.pipeline.receiver import Receiver  # noqa: E402
from rtsdr_tpu_torch.pipeline.wideband import (  # noqa: E402
    make_wideband_receiver,
)
from rtsdr_tpu_torch.utils.jit import jit_step  # noqa: E402


def _raw(shape, device) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, shape, dtype=np.uint8)).to(device)


def _record(metric: str, cfg, stations: int, sec: float, **shape) -> dict:
    block_s = cfg.block_size / 2 / cfg.rf.fs
    return {"metric": metric, **shape, "stations": stations,
            "ms_per_step": sec * 1e3, "value": stations * block_s / sec,
            "unit": "x_realtime"}


def bench_mode1(n_ch: int = 512, rds: bool = False, device="cuda",
                k1=K1, k2=K2, repeats=REPEATS) -> dict:
    """Mode 1 (``rds``: MODE1_RDS) at ``n_ch`` channels."""
    dev = resolve_device(device)
    cfg = MODE1_RDS if rds else MODE1
    rx = Receiver(cfg, (n_ch,), device=dev)
    sec = slope_seconds(rx.step, rx.init, _raw((n_ch, cfg.block_size), dev),
                        k1, k2, repeats)
    name = "mode1_rds" if rds else "mode1"
    return _record(f"{name}_chain_realtime_multiple_per_card", cfg, n_ch,
                   sec, channels=n_ch)


def bench_wideband(k: int = 16, batch: int = 8, device="cuda",
                   k1=K1, k2=K2, repeats=REPEATS) -> dict:
    """The wideband receiver: ``batch`` captures of ``k`` slots."""
    dev = resolve_device(device)
    init_fn, step = jit_step(*make_wideband_receiver(
        MODE0, k, (batch,), device=dev), dev, name="wideband")
    sec = slope_seconds(step, init_fn,
                        _raw((batch, k * MODE0.block_size), dev),
                        k1, k2, repeats)
    return _record("wideband_realtime_multiple_per_card", MODE0, k * batch,
                   sec, channelizer="composed", rf_channels=k,
                   captures=batch)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--channels", type=int, default=512)
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--captures", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=REPEATS)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_of(dev)
    recs = [bench_mode1(args.channels, False, dev, repeats=args.repeats),
            bench_mode1(args.channels, True, dev, repeats=args.repeats),
            bench_wideband(args.slots, args.captures, dev,
                           repeats=args.repeats)]
    for r in recs:
        r.update(device=str(dev), card=card, compiled=True,
                 input="written once into step.input_buffer")
        print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(recs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
