"""Dump the standard debug probe set as gnuplot .dat files, from the
PyTorch port (counterpart of ``tools/dump_diagnostics.py``).

The reference's debug workflow: run the chain, logVector key probe points
into data/*.dat, and inspect them with src/example.gnuplot (PSDs are the
primary verification where no exact oracle exists).  End to end for the
port's receiver:

    python tools/torch_dump_diagnostics.py [capture.u8 | --synth N]
        [--out data] [--device cuda|cpu]
    gnuplot -p tools/example.gnuplot        # (run from the repo root)

Probe points dumped:
  demod_psd.dat      FM-demodulated multiplex PSD at the IF rate — pilot at
                     19 kHz, stereo DSB around 38 kHz, RDS around 57 kHz
  audio_psd.dat      decoded mono audio PSD at 48 kS/s
  rrc.dat/rrcQ.dat   RRC matched-filter output time traces (I and Q)
  constellation.dat  RDS I/Q symbol scatter (see tools/torch_constellation.py)
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("capture", nargs="?", default=None)
    p.add_argument("--synth", type=int, default=None, metavar="BLOCKS")
    p.add_argument("--blocks", type=int, default=None)
    p.add_argument("--out", default="data")
    p.add_argument("--nfft", type=int, default=512)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from rtsdr_tpu_torch.config import MODE0
    from rtsdr_tpu_torch.pipeline.frontend import frontend_init, make_frontend
    from rtsdr_tpu_torch.pipeline.receiver import make_receiver
    from rtsdr_tpu_torch.utils.logging import log_psd, log_vector
    from torch_constellation import collect_symbols, log_scatter, synth_station

    cfg = MODE0
    dev = args.device
    if args.synth is not None:
        n_blocks = args.synth
        iq = synth_station(n_blocks, cfg)
    elif args.capture:
        iq = np.fromfile(args.capture, dtype=np.uint8)
        n_blocks = len(iq) // cfg.block_size
        if args.blocks:
            n_blocks = min(n_blocks, args.blocks)
    else:
        p.error("provide a capture file or --synth BLOCKS")

    bs = cfg.block_size

    def block(b):
        return torch.as_tensor(
            np.ascontiguousarray(iq[b * bs:(b + 1) * bs])).to(dev)

    # demodulated multiplex (front end only)
    frontend = make_frontend(cfg, torch.float32, device=dev)
    fe_state = frontend_init(cfg, (), torch.float32, dev)
    fms = []
    for b in range(n_blocks):
        fm, fe_state = frontend(fe_state, block(b))
        fms.append(fm)
    fm_all = torch.cat(fms)[cfg.if_len:]   # skip the warm-up block
    log_psd("demod_psd", fm_all, args.nfft, cfg.rf.if_fs, args.out)

    # full receiver: audio + RRC streams
    init_fn, step = make_receiver(cfg, dtype=torch.float32,
                                  enable_frame=False, device=dev)
    state = init_fn()
    mono = []
    for b in range(n_blocks):
        state, out = step(state, block(b))
        mono.append(out.mono)
    log_psd("audio_psd", torch.cat(mono)[cfg.audio_len:], args.nfft,
            cfg.audio_fs, args.out)
    log_vector("rrc", out.rds[0][:512], out_dir=args.out)
    log_vector("rrcQ", out.rds[1][:512], out_dir=args.out)

    # constellation (the frame layer's symbol slicer)
    si, sq = collect_symbols(iq, cfg, n_blocks, skip=min(2, n_blocks - 1),
                             device=dev)
    log_scatter("constellation", si, sq, args.out)

    print(f"wrote demod_psd, audio_psd, rrc, rrcQ, constellation .dat "
          f"to {args.out}/ — view with: gnuplot -p tools/example.gnuplot")
    return 0


if __name__ == "__main__":
    sys.exit(main())
