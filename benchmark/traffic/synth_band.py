"""Whole-band captures: one 8-bit I/Q capture at K times ``rf.fs`` holding
one FM station in each of the K slots of a configuration's ``wideband``
block, made from a seed and a traffic file (``arrival`` "resident",
``captures``, ``distinct_captures``, ``ring_blocks``, ``cnr_db``,
``detune_hz``).

Each station is ``synth.py``'s program (mono tone, pilot detuned by up to
``detune_hz`` with its harmonics, an L - R tone on 38 kHz, RDS with PS
and RadioText on 57 kHz) frequency modulated at 75 kHz deviation,
synthesized directly at the wideband rate on its carrier
``stations_hz[k] - capture_center_hz``.  One complex white noise floor
lies under the whole capture, and each station's carrier-to-noise ratio,
drawn from ``cnr_db``, is the ratio in its own 200 kHz, so stations
differ in level as on a real band.  The sum is quantized once to u8 by
``rtsdr_tpu_torch/utils/signals.py::quantize_iq_u8``'s rule (copied):
scaled down, never up, to a peak of 0.95 of full scale, then
``round(128 x + 128)``.  Made with PyTorch on the run's device in float64,
one block of samples at a time; the RDS bits and shapes in NumPy.

``make_band(traffic, config, seed, device)`` gives the ring a driver
loops: ``distinct_captures`` captures of ``ring_blocks`` blocks each;
capture c of ``captures`` carries distinct capture ``c %
distinct_captures`` from a seeded block offset.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.traffic import synth

CHANNEL_HZ = 200e3           # a station's channel on the raster
DEVIATION_HZ = 75e3
PEAK = 0.95


def station_params(traffic: dict, config: dict, seed: int) -> list:
    """Each distinct capture's K stations' parameters (a list of lists),
    drawn from the seed within the traffic file's ranges."""
    wb = config["wideband"]
    lo, hi = traffic["cnr_db"]
    d = traffic["detune_hz"]
    out = []
    for cap in range(traffic["distinct_captures"]):
        rng = synth.rng_for(seed, 11, cap)
        stations = []
        for k in range(wb["slots"]):
            pi = int(rng.integers(0x1000, 0xFFFF))
            stations.append({
                "slot": k,
                "carrier_hz": int(wb["stations_hz"][k]
                                  - wb["capture_center_hz"]),
                "pi": pi,
                "cnr_db": float(rng.uniform(lo, hi)),
                "detune_hz": float(rng.uniform(-d, d)),
                "pilot_phase": float(rng.uniform(0, 2 * np.pi)),
                "mono_hz": float(rng.uniform(300.0, 3000.0)),
                "stereo_hz": float(rng.uniform(300.0, 3000.0)),
                "ps": f"BAND {cap}.{k}",
                "rt": f"capture {cap} slot {k} pi {pi:04X} seed {seed}",
                "pty": int(rng.integers(1, 31)),
            })
        out.append(stations)
    return out


def _station(p: dict, wave, n0: int, n: int, fs_w: float, phase0: float,
             dev):
    """Samples ``n0 .. n0 + n`` of one station's unit-amplitude complex
    signal at ``fs_w``, and its FM phase after them (``phase0`` before)."""
    import torch

    f64 = torch.float64
    idx = torch.arange(n0, n0 + n, dtype=torch.int64, device=dev)
    t = idx.to(f64) / fs_w
    c1 = torch.cos(2 * math.pi * (19e3 + p["detune_hz"]) * t
                   + p["pilot_phase"])
    c2 = 2 * c1 * c1 - 1                      # cos of twice the pilot
    c3 = c1 * (4 * c1 * c1 - 3)               # cos of three times
    # the RDS wave at 57 kS/s, interpolated linearly onto the wide grid
    pos = t * 57e3
    i0 = pos.floor().long().clamp(max=wave.shape[0] - 2)
    frac = pos - i0
    rds = wave[i0] * (1 - frac) + wave[i0 + 1] * frac
    m = (0.45 * torch.sin(2 * math.pi * p["mono_hz"] * t) + 0.1 * c1
         + 0.45 * torch.sin(2 * math.pi * p["stereo_hz"] * t) * c2
         + 0.25 * rds * c3)
    del c1, c2, c3, rds
    phase = torch.cumsum(m, 0) * (2 * math.pi * DEVIATION_HZ / fs_w) + phase0
    # the carrier in cycles, reduced mod 1 in integers
    cycles = (idx * p["carrier_hz"]).remainder(int(fs_w)).to(f64) / fs_w
    angle = 2 * math.pi * cycles + phase
    return torch.polar(torch.ones_like(angle), angle), float(phase[-1])


def capture_iq(stations: list, n_blocks: int, config: dict, seed: int,
               device="cpu"):
    """One capture's interleaved u8 I/Q, (n_blocks, K * block_size), made
    on ``device``."""
    import torch

    dev = torch.device(device)
    k = config["wideband"]["slots"]
    fs_w = k * config["rf"]["fs"]
    n_blk = k * config["block_size"] // 2      # wideband samples a block
    n_all = n_blocks * n_blk
    bits_needed = n_all / fs_w * synth.RDS_BITS_PER_S
    n_groups = int(bits_needed // 104) + 2
    waves = [torch.tensor(synth.rds_baseband(synth.encode_rds_blocks(
        synth.station_words(n_groups, p["pi"], p["ps"], p["rt"], p["pty"]))),
        dtype=torch.float64, device=dev) for p in stations]
    # one complex noise floor of unit power over fs_w; a station's
    # carrier-to-noise ratio is in its own 200 kHz of it
    amp = [math.sqrt(10.0 ** (p["cnr_db"] / 10.0) * CHANNEL_HZ / fs_w)
           for p in stations]
    gen = torch.Generator(device=dev).manual_seed(seed % (1 << 63))
    wide = torch.empty(n_all, dtype=torch.complex128, device=dev)
    phases = [0.0] * len(stations)
    for b in range(n_blocks):
        sl = wide[b * n_blk:(b + 1) * n_blk]
        noise = torch.randn((n_blk, 2), generator=gen, dtype=torch.float32,
                            device=dev).to(torch.float64) / math.sqrt(2.0)
        sl.copy_(torch.view_as_complex(noise))
        for j, p in enumerate(stations):
            sig, phases[j] = _station(p, waves[j], b * n_blk, n_blk, fs_w,
                                      phases[j], dev)
            sl += amp[j] * sig
    # quantize_iq_u8's rule: scaled down (never up) to a peak of 0.95 of
    # full scale, then round(128 x + 128)
    wide /= max(1.0, float(wide.abs().max()) / PEAK)
    raw = torch.view_as_real(wide).reshape(n_blocks, 2 * n_blk)
    return (raw * 128 + 128).round_().clamp_(0, 255).to(torch.uint8)


def make_band(traffic: dict, config: dict, seed: int, device="cpu"):
    """``(ring, capture_of, offset, params, ring_dev)``: ``ring``
    (distinct_captures, ring_blocks, K * block_size) u8 on the host,
    ``ring_dev`` the same on ``device``; capture c carries distinct
    capture ``capture_of[c]`` and at its b-th block the ring block
    ``(b + offset[c]) % ring_blocks``."""
    import torch

    params = station_params(traffic, config, seed)
    n_blocks = traffic["ring_blocks"]
    ring_dev = torch.stack([
        capture_iq(stations, n_blocks, config,
                   int(synth.rng_for(seed, 12, cap).integers(1 << 62)),
                   device)
        for cap, stations in enumerate(params)])
    ring = ring_dev.cpu().numpy()
    n = traffic["captures"]
    capture_of = np.arange(n) % len(params)
    offset = synth.rng_for(seed, 13).integers(0, n_blocks, n)
    return ring, capture_of, offset, params, ring_dev
