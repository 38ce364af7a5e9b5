"""CLI entry point of the PyTorch/CUDA port — ``rtsdr_tpu/cli.py``'s
counterpart on a shell pipeline:

    rtl_sdr -f 107.9e6 -s 2.4e6 - | rtsdr-tpu-torch 0 --no-rds | \\
        aplay -f S16_LE -c 2 -r 48000

Interleaved uint8 IQ on stdin, interleaved int16 stereo at 48 kS/s on
stdout.  Runs on the GPU unless ``--device cpu`` is given.  Ported so far:
the mode-0 audio receiver; RDS decoding is not ported yet, so ``--no-rds``
is required for now.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", nargs="?", type=int, default=0, choices=(0,),
                   help="0: 2.4 MS/s (mode 1 is not ported yet)")
    p.add_argument("--blocks", type=int, default=None,
                   help="stop after N blocks (default: run to EOF)")
    p.add_argument("--no-rds", action="store_true",
                   help="audio only (required until RDS is ported)")
    p.add_argument("--no-stereo", action="store_true",
                   help="mono-only chain")
    p.add_argument("--deemphasis", type=float, nargs="?", const=75.0,
                   default=None, metavar="US",
                   help="apply FM de-emphasis (default 75 us; use 50 in "
                        "Europe)")
    p.add_argument("--wav", type=str, default=None,
                   help="also write decoded audio to a wav file")
    p.add_argument("--stereo-blend", action="store_true",
                   help="fade stereo toward mono as the 19 kHz pilot "
                        "weakens")
    p.add_argument("--pll-div", default="1",
                   choices=("1", "2", "4", "8", "auto"), metavar="N",
                   help="run the PLL loop filter every N-th sample with "
                        "bandwidth-preserving gains (NCO stays full-rate); "
                        "'auto' = 2; 1 = golden-model parity")
    p.add_argument("--stations", nargs="+", metavar="FILE", default=None,
                   help="batch mode: decode N capture files as one batched "
                        "receiver step; writes FILE.wav per station")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch versions)")
    args = p.parse_args(argv)

    if not args.no_rds:
        print("error: RDS decoding is not ported to rtsdr_tpu_torch yet "
              "(RDS DSP, frame layer and group decode are the next slice); "
              "run with --no-rds", file=sys.stderr)
        return 2

    from rtsdr_tpu_torch.config import MODES
    from rtsdr_tpu_torch.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    cfg = MODES[args.mode]
    kwargs = {"enable_rds": False, "device": device}
    if args.no_stereo:
        kwargs["enable_stereo"] = False
    if args.deemphasis is not None:
        kwargs["deemphasis"] = args.deemphasis * 1e-6
    pll_div = 2 if args.pll_div == "auto" else int(args.pll_div)
    if pll_div != 1:
        kwargs["pll_loop_div"] = pll_div
    if args.stereo_blend:
        kwargs["stereo_blend"] = True

    if args.stations:
        return _batch_decode(cfg, args.stations, args.blocks, kwargs)

    from rtsdr_tpu_torch.io.stream import StreamRunner

    runner = StreamRunner(cfg, **kwargs)
    out = sys.stdout.buffer

    # wav output streams incrementally (header patched on close) so memory
    # stays bounded on live/long captures
    wav_w = None
    if args.wav:
        from rtsdr_tpu_torch.io.wav import WavStreamWriter

        wav_w = WavStreamWriter(args.wav, fs=int(cfg.audio_fs))

    def emit(b: bytes):
        out.write(b)
        out.flush()
        if wav_w is not None:
            wav_w.write_int16_bytes(b)

    try:
        stats = runner.run(sys.stdin.fileno(), emit=emit,
                           max_blocks=args.blocks)
    finally:
        if wav_w is not None:
            wav_w.close()

    print(f"processed {stats['blocks']} blocks on {device}", file=sys.stderr)
    return 0


def _batch_decode(cfg, files, max_blocks, kwargs) -> int:
    """Decode N stations as one channel-batched receiver (the multi-station
    deployment shape, driven from capture files)."""
    from rtsdr_tpu_torch.io.batch import BatchRunner
    from rtsdr_tpu_torch.io.wav import WavStreamWriter

    missing = [f for f in files if not os.path.isfile(f)]
    if missing:
        print(f"error: capture file(s) not found: {', '.join(missing)}",
              file=sys.stderr)
        return 1

    n = len(files)
    handles = [open(f, "rb") for f in files]
    writers: list = [None] * n  # opened on first block; stream per block

    def emit(c, left, right):
        if writers[c] is None:
            writers[c] = WavStreamWriter(files[c] + ".wav",
                                         fs=int(cfg.audio_fs))
        writers[c].write_float(left, right)

    try:
        with BatchRunner(cfg, [h.fileno() for h in handles],
                         **kwargs) as runner:
            stats = runner.run(emit=emit, max_blocks=max_blocks)
    finally:
        for h in handles:
            h.close()
        for w in writers:
            if w is not None:
                w.close()

    print(f"processed {stats['blocks']} blocks x {n} stations",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
