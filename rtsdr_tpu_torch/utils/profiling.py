"""Per-stage timing table (counterpart of ``rtsdr_tpu/utils/profiling.py``)
— apples-to-apples with the C++ reference's report: runtime per block per
stage on its hardware.

Each stage is timed with the slope method (k1 and k2 chained calls, one
synchronisation, min over repeats; the difference over k2 - k1 removes the
fixed cost) on representative block-sized inputs, batched over channels.
On a CUDA device the interval is read from CUDA events, on the CPU from
``time.perf_counter``.  Each stage is compiled before it is timed, as the
JAX package jits each stage: ``utils/jit.py::jit_fn`` captures it as one
CUDA graph, and the timed calls replay it over the graph's own argument and
output buffers (no copy in or out), so a row is the stage's device time and
not the host's launch overhead.

Where each stage runs on the card: ``fir_decimate``, ``fir_block`` and the
mono ``fir_resample`` (up = 1) launch the FIR-bank kernel
(``csrc/fir_bank.cu``), ``pll`` the PLL kernel (``csrc/pll.cu``); the
↑19/↓80 ``fir_resample``, the discriminator and the mixer are stock tensor
ops.

The ``reference_note`` strings are the C++ reference's own report numbers,
measured on a Raspberry Pi 4 — neither this port's nor a TPU's.

    python -m rtsdr_tpu_torch.utils.profiling [--channels C] [--device D]

prints one JSON record per stage (on a CUDA device with the card's name and
power limit).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rtsdr_tpu_torch.config import MODE0, ReceiverConfig
from rtsdr_tpu_torch.device import require_kernel_dtype, resolve_device
from rtsdr_tpu_torch.ops import coeffs
from rtsdr_tpu_torch.ops.demod import demod_init, fm_discriminator
from rtsdr_tpu_torch.ops.fir import (
    fir_block,
    fir_decimate,
    fir_resample,
    fir_zi,
    resample_zi,
)
from rtsdr_tpu_torch.ops.pll import pll, pll_init
from rtsdr_tpu_torch.utils.jit import jit_fn

K1, K2, REPEATS = 4, 14, 2


def _slope(fn, args, device: torch.device, name: str = "stage", k1=K1,
           k2=K2, repeats=REPEATS):
    """Seconds per call of ``fn`` compiled (``jit_fn``): (t(k2) - t(k1)) /
    (k2 - k1), each t the min of ``repeats`` runs of k chained calls and
    one synchronisation."""
    cuda = device.type == "cuda"
    jf = jit_fn(fn, device, name=name)
    jf.borrowed(*args)                       # the capture
    args = jf.static_args()
    fn = jf.borrowed

    def run(k):
        if cuda:
            torch.cuda.synchronize(device)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        else:
            t0 = time.perf_counter()
        for _ in range(k):
            fn(*args)
        if cuda:
            b.record()
            b.synchronize()
            return a.elapsed_time(b) * 1e-3
        return time.perf_counter() - t0

    run(k1)
    run(k2)
    t1 = min(run(k1) for _ in range(repeats))
    t2 = min(run(k2) for _ in range(repeats))
    return (t2 - t1) / (k2 - k1)


@torch.no_grad()
def stage_timings(cfg: ReceiverConfig = MODE0, n_channels: int = 256,
                  pll_impl: str = "auto", device="cuda") -> list[dict]:
    """Time each pipeline stage on one block batch; returns records with
    seconds-per-block-batch and per-channel-block (the JAX package's
    stages, names and keys)."""
    dev = resolve_device(device)
    require_kernel_dtype(dev, torch.float32)
    rng = np.random.default_rng(0)
    C = n_channels
    if_fs = cfg.rf.if_fs
    n_if = cfg.if_len
    f32 = torch.float32

    def noise(*shape):
        return torch.as_tensor(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    iq = noise(C, 2, cfg.iq_len)
    fm = noise(C, n_if)

    rf_h = coeffs.lowpass_taps(cfg.rf.fs, cfg.rf.fc, cfg.rf.taps)
    mono_h = coeffs.lowpass_taps(if_fs * cfg.mono.up, cfg.mono.fc,
                                 cfg.mono.taps * cfg.mono.up)
    pilot_h = coeffs.bandpass_taps(if_fs, cfg.stereo.pilot_lo,
                                   cfg.stereo.pilot_hi, cfg.stereo.taps)
    r = cfg.rds
    anti_h = coeffs.lowpass_taps(if_fs * r.up, r.rrc_fs / 2, r.anti_img_taps) \
        if r else None
    rrc_h = coeffs.rrc_taps(r.rrc_fs, r.rrc_taps) if r else None

    stages = []

    def add(name, fn, args, ref_note=""):
        dt = _slope(fn, args, dev, name)
        stages.append({
            "stage": name,
            "sec_per_block_batch": dt,
            "sec_per_channel_block": dt / C,
            "channels": C,
            "reference_note": ref_note,
        })

    zi2 = fir_zi(cfg.rf.taps, (C, 2), f32, dev)
    add("rf_frontend_fir_decim",
        lambda x, z: fir_decimate(x, rf_h, z, cfg.rf.decim),
        (iq, zi2), "report: 9.294e-3 s/blk on RPi4")
    add("fm_discriminator",
        lambda i, q: fm_discriminator(i, q, demod_init((C,), f32, dev)),
        (iq[:, 0, :n_if], iq[:, 1, :n_if]), "report: 9.246e-5")
    zim = resample_zi(cfg.mono.taps * cfg.mono.up, (C,), f32, dev)
    add("mono_resample", lambda x, z: fir_resample(x, mono_h, z, cfg.mono.up,
                                                   cfg.mono.down),
        (fm, zim), "report: 5.944e-4 (mode 0)")
    zi1 = fir_zi(cfg.stereo.taps, (C,), f32, dev)
    add("pilot_bpf", lambda x, z: fir_block(x, pilot_h, z), (fm, zi1),
        "report: 2.975e-3")
    add("pll_x2", lambda x: pll(x, pll_init((C,), f32, dev), freq=19e3,
                                fs=if_fs, nco_scale=2.0, impl=pll_impl),
        (fm,), "report: 1.949e-3")
    add("mixer", lambda a, b: 2.0 * a * b, (fm, fm), "report: 1.018e-5")
    if r:
        ziu = resample_zi(r.anti_img_taps, (C, 2), f32, dev)
        lpf = noise(C, 2, n_if)
        add("rds_resampler_19_80",
            lambda x, z: fir_resample(x, anti_h, z, r.up, r.down),
            (lpf, ziu), "report: 5.886e-3")
        res = noise(C, 2, cfg.rds_len)
        zir = fir_zi(r.rrc_taps, (C, 2), f32, dev)
        add("rrc_filter", lambda x, z: fir_block(x, rrc_h, z), (res, zir),
            "report: 7.72e-4")
    return stages


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--channels", type=int, default=256)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    recs = stage_timings(n_channels=args.channels, device=args.device)
    card = (card_name_and_power_limit()
            if torch.device(args.device).type == "cuda" else None)
    for rec in recs:
        if card is not None:
            rec["card"] = card
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
