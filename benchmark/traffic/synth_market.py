"""Whole-band captures of a dense market: one 8-bit I/Q capture at K times
``rf.fs`` holding every station of a configuration's ``wideband`` block,
several a slot (``stations_hz``, each with its slot in ``slots_of``), made
from a seed and a traffic file (``arrival`` "resident", ``captures``,
``distinct_captures``, ``ring_blocks``, ``cnr_db``, ``detune_hz``).

The stations are ``synth_band.py``'s (its synthesis is imported, not
copied): each one ``synth.py``'s program frequency modulated at 75 kHz
deviation on its carrier ``stations_hz[j] - capture_center_hz``, its
carrier-to-noise ratio drawn from ``cnr_db`` in its own 200 kHz over one
noise floor under the whole capture, the sum quantized once to u8 at 0.95
of full scale.  Only the station list differs: S stations a capture in
place of one a slot.

``make_band(traffic, config, seed, device)`` gives the ring a driver
loops, as ``synth_band.make_band`` does: ``distinct_captures`` captures of
``ring_blocks`` blocks each; capture c of ``captures`` carries distinct
capture ``c % distinct_captures`` from a seeded block offset.
"""

from __future__ import annotations

import numpy as np

from benchmark.traffic import synth, synth_band


def station_params(traffic: dict, config: dict, seed: int) -> list:
    """Each distinct capture's S stations' parameters (a list of lists),
    drawn from the seed within the traffic file's ranges."""
    wb = config["wideband"]
    lo, hi = traffic["cnr_db"]
    d = traffic["detune_hz"]
    out = []
    for cap in range(traffic["distinct_captures"]):
        rng = synth.rng_for(seed, 21, cap)
        stations = []
        for j, (hz, slot) in enumerate(zip(wb["stations_hz"],
                                           wb["slots_of"])):
            pi = int(rng.integers(0x1000, 0xFFFF))
            stations.append({
                "station": j,
                "slot": int(slot),
                "carrier_hz": int(hz - wb["capture_center_hz"]),
                "pi": pi,
                "cnr_db": float(rng.uniform(lo, hi)),
                "detune_hz": float(rng.uniform(-d, d)),
                "pilot_phase": float(rng.uniform(0, 2 * np.pi)),
                "mono_hz": float(rng.uniform(300.0, 3000.0)),
                "stereo_hz": float(rng.uniform(300.0, 3000.0)),
                "ps": f"MKT {cap}.{j:02d}",
                "rt": f"capture {cap} station {j} pi {pi:04X} seed {seed}",
                "pty": int(rng.integers(1, 31)),
            })
        out.append(stations)
    return out


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
        synth_band.capture_iq(
            stations, n_blocks, config,
            int(synth.rng_for(seed, 22, cap).integers(1 << 62)), device)
        for cap, stations in enumerate(params)])
    ring = ring_dev.cpu().numpy()
    n = traffic["captures"]
    capture_of = np.arange(n) % len(params)
    offset = synth.rng_for(seed, 23).integers(0, n_blocks, n)
    return ring, capture_of, offset, params, ring_dev
