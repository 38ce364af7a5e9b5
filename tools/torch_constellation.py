"""RDS constellation diagnostics + PLL phase_adjust tuning on the PyTorch
port (counterpart of ``tools/constellation.py``).

The reference added a Q output to its PLL so that a human could scatter
the I/Q symbols and hand-tune ``phaseAdjust`` until the cloud collapsed
onto the I axis.  Here the tuning is analytic: changing ``phase_adjust``
by delta rotates the (I, Q) symbol cloud by exactly -delta, so one
receiver pass yields the whole sweep by post-rotation, and the best
adjustment is the principal axis of the symbols' second-moment matrix:

    delta* = -1/2 * atan2(2*sum(I*Q), sum(I^2 - Q^2))

Usage (the GPU by default; ``--device cpu`` for the plain versions):
    python tools/torch_constellation.py capture.u8 [--blocks N] [--out data]
    python tools/torch_constellation.py --synth 6 [--detune HZ]
        [--phase-adjust R] [--device cuda|cpu]

Writes gnuplot scatter files ``constellation.dat`` (as decoded) and
``constellation_tuned.dat`` (after the recommended rotation):
    plot 'data/constellation.dat' using 1:2 with points pt 7 ps 0.3
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def collect_symbols(iq_u8, cfg, n_blocks, phase_adjust=None, skip=2,
                    offset_mode="hold", use_abs_clock=True, device="cuda"):
    """Run the port's receiver over a capture; return (sym_i, sym_q)
    numpy arrays of all valid RDS symbols after ``skip`` warm-up blocks."""
    import dataclasses

    import numpy as np
    import torch

    from rtsdr_tpu_torch.pipeline.receiver import make_receiver

    if phase_adjust is not None:
        cfg = dataclasses.replace(
            cfg, rds=dataclasses.replace(
                cfg.rds, pll=dataclasses.replace(
                    cfg.rds.pll, phase_adjust=phase_adjust)))
    init_fn, step = make_receiver(cfg, dtype=torch.float32,
                                  offset_mode=offset_mode,
                                  use_abs_clock=use_abs_clock, device=device)
    state = init_fn()
    bs = cfg.block_size
    si, sq = [], []
    for b in range(n_blocks):
        blk = torch.as_tensor(
            np.ascontiguousarray(iq_u8[b * bs:(b + 1) * bs])).to(device)
        state, out = step(state, blk)
        if b < skip:
            continue
        fo = out.rds
        n = int(fo.n_sym)
        si.append(fo.symbols_i[:n].cpu().numpy())
        sq.append(fo.symbols_q[:n].cpu().numpy())
    return np.concatenate(si), np.concatenate(sq)


def i_axis_concentration(sym_i, sym_q) -> float:
    """Fraction of symbol energy on the I axis — 1.0 = perfectly tuned."""
    import numpy as np

    e = float(np.sum(sym_i**2) + np.sum(sym_q**2))
    return float(np.sum(sym_i**2)) / e if e else 0.0


def optimal_phase_delta(sym_i, sym_q) -> float:
    """Closed-form phase_adjust correction that maximizes I-axis energy:
    d* = -1/2 atan2(2 sum(IQ), sum(I^2 - Q^2))."""
    import numpy as np

    num = 2.0 * float(np.sum(sym_i * sym_q))
    den = float(np.sum(sym_i**2) - np.sum(sym_q**2))
    return -0.5 * math.atan2(num, den)


def rotate(sym_i, sym_q, delta):
    """Symbols as they would decode with phase_adjust += delta."""
    import numpy as np

    c, s = np.cos(delta), np.sin(delta)
    return c * sym_i - s * sym_q, s * sym_i + c * sym_q


def phase_sweep(sym_i, sym_q, n=16):
    """(delta, concentration) table over one BPSK period [-pi/2, pi/2)."""
    import numpy as np

    out = []
    for d in np.linspace(-math.pi / 2, math.pi / 2, n, endpoint=False):
        i2, q2 = rotate(sym_i, sym_q, d)
        out.append((float(d), i_axis_concentration(i2, q2)))
    return out


def log_scatter(name, sym_i, sym_q, out_dir="data") -> str:
    """Two-column I/Q scatter .dat (gnuplot: plot ... using 1:2 w points)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.dat")
    with open(path, "w") as f:
        f.write(f"# {name}: {len(sym_i)} RDS symbols (I Q)\n")
        for i, q in zip(sym_i, sym_q):
            f.write(f"{i:.6g}\t{q:.6g}\n")
    return path


def synth_station(n_blocks, cfg, detune_hz=0.0, seed=7):
    """The synthetic RDS station of ``--synth``: the stream
    ``tools/constellation.py --synth`` builds, from the port's own
    synthesizer."""
    import numpy as np

    from rtsdr_tpu_torch.utils.signals import (
        encode_rds_blocks, rds_baseband, synth_multiplex_iq)

    rng = np.random.default_rng(seed)
    bits = encode_rds_blocks(rng.integers(0, 2, (40 * n_blocks, 16)))
    wave = rds_baseband(bits)
    return synth_multiplex_iq(n_blocks * cfg.block_size // 2, rds_wave=wave,
                              pilot_hz=19e3 + detune_hz, rng=rng)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("capture", nargs="?", default=None,
                   help="interleaved uint8 IQ capture file")
    p.add_argument("--synth", type=int, default=None, metavar="BLOCKS",
                   help="use a synthetic RDS station instead of a capture")
    p.add_argument("--detune", type=float, default=0.0,
                   help="pilot detune in Hz for --synth")
    p.add_argument("--blocks", type=int, default=None)
    p.add_argument("--skip", type=int, default=2,
                   help="warm-up blocks to exclude (default 2)")
    p.add_argument("--phase-adjust", type=float, default=None,
                   help="override the RDS PLL phase_adjust (radians)")
    p.add_argument("--sweep", type=int, default=16,
                   help="phase-sweep table resolution (0 to disable)")
    p.add_argument("--out", default="data")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import numpy as np

    from rtsdr_tpu_torch.config import MODE0

    cfg = MODE0
    if args.synth is not None:
        n_blocks = args.synth
        iq = synth_station(n_blocks, cfg, args.detune)
    elif args.capture:
        iq = np.fromfile(args.capture, dtype=np.uint8)
        n_blocks = len(iq) // cfg.block_size
        if args.blocks:
            n_blocks = min(n_blocks, args.blocks)
    else:
        p.error("provide a capture file or --synth BLOCKS")

    sym_i, sym_q = collect_symbols(iq, cfg, n_blocks,
                                   phase_adjust=args.phase_adjust,
                                   skip=args.skip, device=args.device)
    conc = i_axis_concentration(sym_i, sym_q)
    delta = optimal_phase_delta(sym_i, sym_q)
    ti, tq = rotate(sym_i, sym_q, delta)
    base = args.phase_adjust if args.phase_adjust is not None \
        else cfg.rds.pll.phase_adjust

    log_scatter("constellation", sym_i, sym_q, args.out)
    log_scatter("constellation_tuned", ti, tq, args.out)

    if args.sweep:
        print("# delta_rad  i_axis_concentration")
        for d, c in phase_sweep(sym_i, sym_q, args.sweep):
            print(f"{d:+.4f}     {c:.4f}")
    print(json.dumps({
        "n_symbols": int(len(sym_i)),
        "i_axis_concentration": round(conc, 4),
        "optimal_delta_rad": round(delta, 4),
        "tuned_concentration": round(i_axis_concentration(ti, tq), 4),
        "recommended_phase_adjust": round(base + delta, 4),
        "scatter": os.path.join(args.out, "constellation.dat"),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
