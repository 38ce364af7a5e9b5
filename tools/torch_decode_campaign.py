"""Adversarial decode campaign on the PyTorch port: transmitter-grade
synthetics under combined impairments, the port's receiver at CLI
defaults beside the golden decoder.

Counterpart of ``tools/decode_campaign.py`` with its own copy of the
scenario table and the impaired-stream synthesizer (the streams are built
by the port's numpy synthesizer, ``rtsdr_tpu_torch/utils/signals.py``,
which gives the streams of ``tests/oracles.py`` value for value and is
independent of either decode path), reporting RDS group yield for

  * the port's receiver at CLI defaults (hold clock, resync on, pll_div 1,
    error correction off), and in a second pass with the robust options
    (``--clock gardner --derotate``);
  * the golden decoder (scipy golden front end + ``golden_rds_dsp`` +
    ``GoldenFrameDecoder`` of ``tests/torch_oracles.py``, the jax-free copy
    of ``tests/oracles.py``'s), numpy and scipy on the host beside either
    device; ``--no-golden`` leaves it out.  Nothing of this tool imports
    JAX or the JAX package.

``--channels C`` runs the scenario streams as the rows of ONE batched
receiver of C channels (the scenarios repeated in order to fill the rows),
so that one run covers the table at batch width; each scenario's yield is
its first row's, and ``rows_agree`` says whether every row that carries
the same stream decoded the same.

Usage (the GPU by default; ``--device cpu`` runs the plain versions at
about a second per block):

    python tools/torch_decode_campaign.py [--blocks N] [--channels C]
        [--scenarios a,b] [--no-golden] [--json F] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

#  Scenario grid: name -> synth kwargs + channel impairments applied to
#  the complex envelope before uint8 quantization (the values of
#  tools/decode_campaign.py: XO error tens of ppm, pilot detune far past
#  the IEC 62106 tolerance, flutter = slow AM from multipath).
SCENARIOS = {
    "clean":        {},
    "ppm+50":       {"ppm": 50.0},
    "ppm-50":       {"ppm": -50.0},
    "detune+200":   {"pilot_hz": 19e3 + 200.0},
    "phase_noise":  {"phase_noise_std": 3e-3},
    "am_ripple":    {"ripple_depth": 0.5, "ripple_hz": 11.0},
    "snr20":        {"snr_db": 20.0},
    "snr15":        {"snr_db": 15.0},
    "snr10":        {"snr_db": 10.0},
    "combined_mild": {"ppm": 20.0, "pilot_hz": 19e3 + 100.0,
                      "phase_noise_std": 1e-3, "ripple_depth": 0.3,
                      "ripple_hz": 7.0, "snr_db": 20.0},
    "combined_harsh": {"ppm": 50.0, "pilot_hz": 19e3 + 200.0,
                       "phase_noise_std": 3e-3, "ripple_depth": 0.5,
                       "ripple_hz": 11.0, "snr_db": 12.0},
}

STATION_PI = 0x3A5C


def synth_impaired(n_blocks, scenario, seed=0x5A):
    """uint8 stream + the number of transmitted groups."""
    import numpy as np

    from rtsdr_tpu_torch.utils.signals import (
        encode_rds_blocks, rds_baseband, synth_multiplex_iq)

    block_size = 307200
    rng = np.random.default_rng(seed)
    # ~0.73 groups/block on the 2375 bit/s stream; over-provision words
    n_groups = int(n_blocks * 0.8) + 4
    words = []
    for g in range(n_groups):   # 0A PS cycle: every group checkable
        seg = g % 4
        b = (0 << 12) | (0 << 11) | (1 << 10) | (5 << 5) | seg
        words.extend([STATION_PI, b, (226 << 8) | 106,
                      (ord("T") << 8) | ord("P")])
    wave = rds_baseband(encode_rds_blocks(words))

    kw = {k: v for k, v in scenario.items()
          if k in ("ppm", "pilot_hz", "phase_noise_std",
                   "carrier_offset_hz", "pilot_drift_hz_per_s")}
    iq = synth_multiplex_iq(n_blocks * block_size // 2, rds_wave=wave,
                            rng=rng, quantize=False, **kw)
    # groups actually on air: 2375 sym/s Manchester -> 1187.5 bit/s ->
    # 76 bits per 64 ms block; a group is 104 bits
    n_groups = min(n_groups, (n_blocks * 76) // 104)
    z = iq[0::2] + 1j * iq[1::2]

    # channel impairments on the complex envelope (scipy/numpy only)
    fs = 2.4e6
    t = np.arange(len(z)) / fs
    depth = scenario.get("ripple_depth", 0.0)
    if depth:
        z = z * (1.0 - depth * 0.5 * (1.0 + np.cos(
            2 * np.pi * scenario.get("ripple_hz", 10.0) * t)))
    snr_db = scenario.get("snr_db")
    if snr_db is not None:
        # unit-envelope FM carrier: signal power 1; complex AWGN
        sigma = 10.0 ** (-snr_db / 20.0) / np.sqrt(2.0)
        z = z + sigma * (rng.standard_normal(len(z))
                         + 1j * rng.standard_normal(len(z)))
    iq2 = np.empty(2 * len(z))
    iq2[0::2] = z.real
    iq2[1::2] = z.imag
    u8 = np.clip(np.round(iq2 * 100.0 + 128.0), 0, 255).astype(np.uint8)
    return u8, n_groups


_RX = {}


def receiver_yield(u8, n_blocks, clock="hold", derotate=False,
                   device="cuda"):
    """The port's receiver -> (synced windows, decoded groups of the
    station's PI).  ``u8`` is one stream (n,) or C streams (C, n) run as
    the rows of one batched receiver; then both counts are lists, one per
    row.  Defaults are the CLI defaults; ``clock='gardner',
    derotate=True`` is the robust configuration for impaired air."""
    import numpy as np
    import torch

    from rtsdr_tpu_torch.config import MODE0
    from rtsdr_tpu_torch.pipeline.groups import GroupDecoder
    from rtsdr_tpu_torch.pipeline.receiver import make_receiver

    u8 = np.asarray(u8)
    rows = u8.reshape(-1, u8.shape[-1])
    batch = () if u8.ndim == 1 else (rows.shape[0],)
    key = (clock, derotate, batch, str(device))
    if _RX.get("key") != key:   # one build per configuration
        kw = {} if clock == "hold" else {"offset_mode": clock}
        init_fn, step_fn = make_receiver(MODE0, batch, torch.float32,
                                         resync=True, derotate=derotate,
                                         device=device, **kw)
        _RX.update(key=key, init=init_fn, step=step_fn)
    init_fn, step = _RX["init"], _RX["step"]
    state = init_fn()
    decs = [GroupDecoder() for _ in rows]
    bs = MODE0.block_size
    syncs = [0] * len(rows)
    for b in range(n_blocks):
        raw = torch.as_tensor(
            np.ascontiguousarray(u8[..., b * bs:(b + 1) * bs])).to(device)
        state, out = step(state, raw)
        fields = [x.cpu().numpy() for x in out.rds]
        if not batch:
            fields = [x[None] for x in fields]
        for r, dec in enumerate(decs):
            row = type(out.rds)(*(x[r] for x in fields))
            n_w = int(row.n_windows)
            syncs[r] += int(row.is_sync[:n_w].sum())
            dec.feed(row)
    groups = [sum(1 for g in dec.groups if g.pi == STATION_PI)
              for dec in decs]
    if not batch:
        return syncs[0], groups[0]
    return syncs, groups


def golden_yield(u8, n_blocks):
    """Golden chain (scipy front end + model bit layer) -> accepted
    syndrome count and assembled-group estimate (4 consecutive accepted
    syndromes at 26-bit spacing ~= 1 group)."""
    from torch_oracles import (
        GoldenFrameDecoder, golden_mono_stereo, golden_rds_dsp)

    outs = golden_mono_stereo(u8, n_blocks)
    fm = outs["fm"].reshape(n_blocks, -1)
    rrc = golden_rds_dsp(list(fm))
    dec = GoldenFrameDecoder(offset_mode="hold")
    accepted = 0
    groups = 0
    names = []
    for (ri, rq) in rrc:
        _, events = dec.step(ri, rq)
        for name, pos, is_sync in events:
            if not is_sync:
                continue
            accepted += 1
            names.append(name)
    #  group estimate: count A,B,C/C',D runs in the accepted sequence
    want = ["A", "B", None, "D"]
    k = 0
    for nm in names:
        expect = want[k % 4]
        ok = (nm == expect) if expect else nm in ("C", "C'")
        if ok:
            k += 1
            if k % 4 == 0:
                groups += 1
        else:
            k = 1 if nm == "A" else 0
    return accepted, groups


def campaign(names, n_blocks, channels=None, clock="hold", derotate=False,
             device="cuda", streams=None):
    """Yield rows of one pass: every scenario of ``names`` as rows of one
    batched receiver of ``channels`` rows (default one row each).
    ``streams``: name -> (u8, n_groups), made here when absent."""
    import numpy as np

    if streams is None:
        streams = {n: synth_impaired(n_blocks, SCENARIOS[n]) for n in names}
    c = channels or len(names)
    if c < len(names):
        raise ValueError(f"{c} channels for {len(names)} scenarios")
    order = [names[r % len(names)] for r in range(c)]
    u8 = np.stack([streams[n][0] for n in order])
    syncs, groups = receiver_yield(u8, n_blocks, clock=clock,
                                   derotate=derotate, device=device)
    out = []
    for k, name in enumerate(names):
        mine = [r for r, n in enumerate(order) if n == name]
        n_groups = streams[name][1]
        out.append({
            "scenario": name if clock == "hold" and not derotate
            else name + "/robust",
            "blocks": n_blocks, "channels": c,
            "tx_groups": n_groups, "rx_syncs": syncs[k],
            "rx_groups": groups[k],
            "rx_group_yield": round(groups[k] / n_groups, 3),
            "rows_agree": len({(syncs[r], groups[r]) for r in mine}) == 1,
        })
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--blocks", type=int, default=12)
    ap.add_argument("--channels", type=int, default=None,
                    help="rows of the batched receiver (default: one per "
                    "scenario)")
    ap.add_argument("--no-golden", action="store_true")
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--scenarios", type=str, default=None,
                    help="comma list (default: all)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    card = None
    if torch.device(args.device).type == "cuda":
        from rtsdr_tpu_torch.device import resolve_device
        from rtsdr_tpu_torch.utils.profiling import card_name_and_power_limit

        resolve_device(args.device)
        card = card_name_and_power_limit()
    names = (args.scenarios.split(",") if args.scenarios
             else list(SCENARIOS))
    streams = {n: synth_impaired(args.blocks, SCENARIOS[n]) for n in names}
    rows = []
    for clock, derotate in (("hold", False), ("gardner", True)):
        for row in campaign(names, args.blocks, args.channels, clock,
                            derotate, args.device, streams):
            row["device"] = args.device
            if card is not None:
                row["card"] = card
            name = row["scenario"]
            if not args.no_golden and clock == "hold":
                g_acc, g_groups = golden_yield(streams[name][0], args.blocks)
                row["golden_syncs"] = g_acc
                row["golden_groups"] = g_groups
                row["golden_group_yield"] = round(
                    g_groups / row["tx_groups"], 3)
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
