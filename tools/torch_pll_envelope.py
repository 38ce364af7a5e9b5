#!/usr/bin/env python3
"""Operating envelope of the PLL loop-rate division (``loop_div``) through
the port: carrier detune x in-band SNR for both production PLL instances,
each seen through its production band-pass, at ``loop_div`` 1, 2 and 4.

    python3 tools/torch_pll_envelope.py [--blocks 10] [--device cuda|cpu]
        [--out FILE]

Counterpart of ``tools/pll_envelope.py``, with the same grid and the same
noise draws (``numpy.random.default_rng(7)``, the instances in order):

  stereo pilot: 19 kHz tone +/- 300 Hz, BPF 18.5-19.5 kHz, nco x2, B=0.01
  RDS carrier: 114 kHz tone +/- 1.5 kHz, BPF 113.5-114.5 kHz, nco x0.5,
      B=0.001 (the squared-carrier loop)

SNR is in-band: tone power over noise power inside the 1 kHz pass band.
Every grid point of an instance is one lane of one batched call per block
(``ops/fir.py::fir_block`` then ``ops/pll.py::pll(loop_div=...)``), so on
the card each block runs the FIR-bank kernel K2 (pre-op none) and the PLL
kernel K3 once; ``--device cpu`` runs their plain versions.

Per (instance, div, detune, SNR): the lock amplitude |<nco . e^{-jwt}>| on
the last block (1 = perfect lock), the RMS phase jitter about it, and the
first block whose lock amplitude reaches 0.9 (-1: never); then, per
instance and div > 1, the JAX tool's summary of the worst degradation
against div = 1.  One JSON line each, with the card's name and power
limit on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtsdr_tpu_torch.config import MODE0  # noqa: E402
from rtsdr_tpu_torch.device import resolve_device  # noqa: E402
from rtsdr_tpu_torch.ops import coeffs  # noqa: E402
from rtsdr_tpu_torch.ops.fir import fir_block, fir_zi  # noqa: E402
from rtsdr_tpu_torch.ops.pll import pll, pll_init  # noqa: E402

FS = MODE0.rf.if_fs            # 240 kS/s
N = MODE0.if_len               # 15,360 per block
BLOCKS = 10
SETTLE = 0.9
DIVS = (1, 2, 4)
SNRS_DB = (np.inf, 20.0, 10.0, 5.0)
SEED = 7

INSTANCES = {
    "stereo": dict(
        f0=MODE0.stereo.pll.freq,
        detunes=np.array([-300, -200, -100, -50, 0, 50, 100, 200, 300],
                         np.float64),
        bpf=(MODE0.stereo.pilot_lo, MODE0.stereo.pilot_hi,
             MODE0.stereo.taps),
        nco_scale=MODE0.stereo.pll.nco_scale,
        bw=MODE0.stereo.pll.norm_bandwidth,
    ),
    "rds": dict(
        f0=MODE0.rds.pll.freq,
        detunes=np.array([-1500, -1000, -500, -200, 0, 200, 500, 1000,
                          1500], np.float64),
        bpf=(MODE0.rds.squared_lo, MODE0.rds.squared_hi, MODE0.rds.taps),
        nco_scale=MODE0.rds.pll.nco_scale,
        bw=MODE0.rds.pll.norm_bandwidth,
    ),
}


def grid_signals(spec: dict, rng, blocks: int = BLOCKS, detunes=None,
                 snrs=SNRS_DB) -> tuple[list, np.ndarray]:
    """``(grid, sig)``: the (detune, SNR) points in order and their
    float32 rows (tone + in-band-scaled white noise, ``blocks`` x N
    samples), drawing noise from ``rng`` as the JAX tool does."""
    detunes = spec["detunes"] if detunes is None else detunes
    lo, hi, _ = spec["bpf"]
    grid = [(d, s) for d in detunes for s in snrs]
    t = np.arange(blocks * N, dtype=np.float64) / FS
    sig = np.zeros((len(grid), blocks * N), np.float32)
    for k, (d, snr) in enumerate(grid):
        x = np.cos(2 * np.pi * (spec["f0"] + d) * t)
        if np.isfinite(snr):
            # tone power 0.5; in-band noise power = sigma^2 * bw / (fs / 2)
            sigma = np.sqrt(0.5 / 10 ** (snr / 10) * (FS / 2) / (hi - lo))
            x = x + sigma * rng.standard_normal(len(t))
        sig[k] = x.astype(np.float32)
    return grid, sig


def lock_jitter(ni, nq, b: int, grid: list, spec: dict):
    """Lock amplitude and RMS phase jitter of each lane over block ``b``
    from its NCO outputs (host arrays)."""
    tb = np.arange(b * N, (b + 1) * N, dtype=np.float64) / FS
    locks = np.zeros(len(grid))
    jitters = np.zeros(len(grid))
    for k, (d, _) in enumerate(grid):
        f_nco = (spec["f0"] + d) * spec["nco_scale"]
        z = ((np.asarray(ni[k], np.float64) + 1j * np.asarray(nq[k],
                                                              np.float64))
             * np.exp(-2j * np.pi * f_nco * tb))
        zm = z.mean()
        locks[k] = np.abs(zm)                 # the NCO's amplitude is 1
        ph = np.angle(z * np.conj(zm / (np.abs(zm) + 1e-30)))
        jitters[k] = np.sqrt(np.mean(ph ** 2))
    return locks, jitters


def records(name: str, div: int, grid: list, locks, jitters) -> list[dict]:
    """One record per grid point from per-block ``locks`` / ``jitters``
    (blocks x points)."""
    out = []
    for k, (d, snr) in enumerate(grid):
        settled = np.where(locks[:, k] >= SETTLE)[0]
        out.append({
            "pll": name, "div": div, "detune_hz": float(d),
            "snr_db": None if not np.isfinite(snr) else float(snr),
            "lock": float(locks[-1, k]), "jitter_rad": float(jitters[-1, k]),
            "settle_block": int(settled[0]) if len(settled) else -1})
    return out


def run_instance(name: str, spec: dict, grid: list, sig: np.ndarray,
                 divs=DIVS, device="cuda") -> dict:
    """``{div: records}``: every grid point a lane of one batched
    ``fir_block`` + ``pll`` call per block."""
    dev = resolve_device(device)
    lo, hi, taps = spec["bpf"]
    h = coeffs.bandpass_taps(FS, lo, hi, taps)
    c, blocks = len(grid), sig.shape[1] // N
    x_all = torch.as_tensor(sig).to(dev)
    out = {}
    for div in divs:
        zi = fir_zi(taps, (c,), torch.float32, dev)
        st = pll_init((c,), torch.float32, dev)
        locks = np.zeros((blocks, c))
        jitters = np.zeros((blocks, c))
        for b in range(blocks):
            filt, zi = fir_block(x_all[:, b * N:(b + 1) * N], h, zi)
            ni, nq, st = pll(filt, st, freq=spec["f0"], fs=FS,
                             nco_scale=spec["nco_scale"],
                             norm_bandwidth=spec["bw"], impl="auto",
                             loop_div=div)
            locks[b], jitters[b] = lock_jitter(ni.cpu().numpy(),
                                               nq.cpu().numpy(), b, grid,
                                               spec)
        out[div] = records(name, div, grid, locks, jitters)
    return out


def envelope(blocks: int = BLOCKS, divs=DIVS, device="cuda") -> dict:
    """``{instance: {div: records}}`` over the full grid."""
    rng = np.random.default_rng(SEED)
    res = {}
    for name, spec in INSTANCES.items():
        grid, sig = grid_signals(spec, rng, blocks)
        res[name] = run_instance(name, spec, grid, sig, divs, device)
    return res


def summary(res: dict) -> list[dict]:
    """Per instance and div > 1: the worst lock drop, jitter increase and
    settle delay against div = 1 over the grid, and the points whose
    settled / never-settled state differs."""
    out = []
    for name, per_div in res.items():
        base = per_div[1]
        for div in sorted(per_div):
            if div == 1:
                continue
            pairs = list(zip(base, per_div[div]))
            ds = [rd["settle_block"] - r1["settle_block"] for r1, rd in pairs
                  if r1["settle_block"] >= 0 and rd["settle_block"] >= 0]
            out.append({
                "summary": name, "div": div,
                "max_lock_drop": max(r1["lock"] - rd["lock"]
                                     for r1, rd in pairs),
                "max_jitter_increase_rad": max(
                    rd["jitter_rad"] - r1["jitter_rad"] for r1, rd in pairs),
                "max_settle_delay_blocks": max(ds) if ds else None,
                "lock_state_flips": sum(
                    (r1["settle_block"] >= 0) != (rd["settle_block"] >= 0)
                    for r1, rd in pairs)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--blocks", type=int, default=BLOCKS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = None
    if dev.type == "cuda":
        from rtsdr_tpu_torch.utils.profiling import card_name_and_power_limit

        card = card_name_and_power_limit()
    res = envelope(args.blocks, device=dev)
    lines = [r for per_div in res.values() for recs in per_div.values()
             for r in recs] + summary(res)
    for r in lines:
        r["device"] = str(dev)
        r["card"] = card
        print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for r in lines:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
