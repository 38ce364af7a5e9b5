"""CLI entry point of the PyTorch/CUDA port — ``rtsdr_tpu/cli.py``'s
counterpart on a shell pipeline:

    rtl_sdr -f 107.9e6 -s 2.4e6 - | rtsdr-tpu-torch 0 | \\
        aplay -f S16_LE -c 2 -r 48000

Interleaved uint8 IQ on stdin, interleaved int16 stereo at 48 kS/s on
stdout, RDS frame-sync events (and, with ``--rds-groups``, decoded group
payloads) on stderr.  Runs on the GPU unless ``--device cpu`` is given.
Ported so far: mode 0.
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
    p.add_argument("--no-rds", action="store_true", help="audio only")
    p.add_argument("--no-stereo", action="store_true",
                   help="mono-only chain")
    p.add_argument("--deemphasis", type=float, nargs="?", const=75.0,
                   default=None, metavar="US",
                   help="apply FM de-emphasis (default 75 us; use 50 in "
                        "Europe)")
    p.add_argument("--wav", type=str, default=None,
                   help="also write decoded audio to a wav file")
    p.add_argument("--rds-groups", action="store_true",
                   help="decode RDS group payloads (PI/PTY/PS/RadioText) "
                        "to stderr")
    p.add_argument("--clock", choices=("hold", "track", "argmax", "gardner"),
                   default="hold",
                   help="RDS symbol-clock recovery: hold/track = reference "
                        "parity modes (track reproduces the golden model's "
                        "quirky k->24-k update: diagnostics only); argmax "
                        "= per-block re-estimation; gardner = decision-"
                        "directed timing loop (tracks receiver XO ppm error "
                        "the reference modes cannot)")
    p.add_argument("--stereo-blend", action="store_true",
                   help="fade stereo toward mono as the 19 kHz pilot "
                        "weakens")
    p.add_argument("--pll-div", default="1",
                   choices=("1", "2", "4", "8", "auto"), metavar="N",
                   help="run the PLL loop filter every N-th sample with "
                        "bandwidth-preserving gains (NCO stays full-rate); "
                        "'auto' = 2; 1 = golden-model parity")
    p.add_argument("--pty-table", choices=("rbds", "rds"), default="rbds",
                   help="program-type name table: 'rbds' (North America) "
                        "or 'rds' (Europe, IEC 62106 annex F).  The same "
                        "5-bit codes mean different things per region")
    p.add_argument("--derotate", action="store_true",
                   help="track and remove RDS constellation rotation per "
                        "block (BPSK squaring estimator): a detuned "
                        "carrier rotates symbol energy off the I axis "
                        "where the reference's decisions lose margin. "
                        "Off by default for golden-model parity")
    p.add_argument("--rds-ec", action="store_true",
                   help="burst error correction on RDS blocks: repair "
                        "<=5-bit bursts via the (26,16) code's syndrome "
                        "table (IEC 62106 annex B).  Off by default for "
                        "parity")
    p.add_argument("--resync", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="reset the sync anchor after >10 bad syndromes "
                        "(the reference C++ always does this; it also "
                        "recovers from a chance match poisoning the first "
                        "anchor); --no-resync gives golden-model parity")
    p.add_argument("--stations", nargs="+", metavar="FILE", default=None,
                   help="batch mode: decode N capture files as one batched "
                        "receiver step; writes FILE.wav per station, RDS "
                        "events tagged [station] on stderr")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch versions)")
    args = p.parse_args(argv)

    from rtsdr_tpu_torch.config import MODES
    from rtsdr_tpu_torch.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    cfg = MODES[args.mode]
    kwargs = {"device": device}
    if args.no_rds or cfg.rds is None:
        kwargs["enable_rds"] = False
    if args.no_stereo:
        kwargs["enable_stereo"] = False
    if args.deemphasis is not None:
        kwargs["deemphasis"] = args.deemphasis * 1e-6
    if args.clock != "hold":
        kwargs["offset_mode"] = args.clock
    if args.resync:
        kwargs["resync"] = True
    pll_div = 2 if args.pll_div == "auto" else int(args.pll_div)
    if pll_div != 1:
        kwargs["pll_loop_div"] = pll_div
    if args.rds_ec:
        kwargs["error_correct"] = True
    if args.derotate:
        kwargs["derotate"] = True
    if args.stereo_blend:
        kwargs["stereo_blend"] = True

    if args.stations:
        return _batch_decode(cfg, args.stations, args.blocks, kwargs,
                             rds_groups=args.rds_groups,
                             pty_table=args.pty_table)

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

    decoders = _station_decoders(1, cfg, kwargs, args.rds_groups,
                                 args.pty_table)
    decoder = decoders[0] if decoders else None
    frame_hook = (None if decoders is None
                  else lambda fo: _feed_groups(decoders, 0, fo, ""))

    try:
        stats = runner.run(
            sys.stdin.fileno(),
            emit=emit,
            rds_log=lambda line: print(line, file=sys.stderr),
            max_blocks=args.blocks,
            frame_hook=frame_hook,
        )
    finally:
        if wav_w is not None:
            wav_w.close()

    corr = (f", {stats['rds_corrected']} corrected"
            if stats.get("rds_corrected") else "")
    print(f"processed {stats['blocks']} blocks, "
          f"{stats['rds_events']} RDS syncs "
          f"({stats['rds_false_positives']} false positives{corr})",
          file=sys.stderr)
    if decoder is not None:
        _print_rds_summary(decoder)
    return 0


def _print_rds_summary(decoder, prefix: str = "") -> None:
    """Final decoded-payload summary lines (PI/PTY/PS/RT, AF list, CT)."""
    if decoder.pi is None:
        return
    from rtsdr_tpu_torch.pipeline.groups import ODA_NAMES, pty_name

    if decoder.alarm:
        print(f"{prefix}RDS: *** EMERGENCY ALARM (PTY 31) ***",
              file=sys.stderr)
    pty = pty_name(decoder.pty, decoder.pty_table)
    print(f"{prefix}RDS: PI=0x{decoder.pi:04X} PTY={pty} "
          f"PS='{decoder.ps_name}' RT='{decoder.radiotext_str}'",
          file=sys.stderr)
    if decoder.long_ps_str:
        print(f"{prefix}RDS: Long PS '{decoder.long_ps_str}'",
              file=sys.stderr)
    if decoder.ptyn_str:
        print(f"{prefix}RDS: PTYN='{decoder.ptyn_str}'", file=sys.stderr)
    if decoder.af_mhz:
        afs = " ".join(f"{f:.1f}" for f in sorted(decoder.af_mhz))
        print(f"{prefix}RDS: AF [MHz]: {afs}", file=sys.stderr)
    if decoder.af_lfmf_khz:
        afs = " ".join(str(f) for f in sorted(decoder.af_lfmf_khz))
        print(f"{prefix}RDS: AF LF/MF [kHz]: {afs}", file=sys.stderr)
    if decoder.clock is not None:
        print(f"{prefix}RDS: CT {decoder.clock}", file=sys.stderr)
    if decoder.ta is not None:
        flags = [f"TA={decoder.ta}", f"MS={'music' if decoder.ms else 'speech'}"]
        if decoder.di_stereo is not None:
            flags.append(f"DI={'stereo' if decoder.di_stereo else 'mono'}")
        print(f"{prefix}RDS: {' '.join(flags)}", file=sys.stderr)
    if decoder.pin is not None:
        print(f"{prefix}RDS: PIN {decoder.pin}", file=sys.stderr)
    for applied, aid in sorted(decoder.oda.items()):
        name = ODA_NAMES.get(aid, f"AID 0x{aid:04X}")
        print(f"{prefix}RDS: ODA {name} in group {applied}", file=sys.stderr)
    if decoder.ert_str:
        print(f"{prefix}RDS: eRT '{decoder.ert_str}'", file=sys.stderr)
    if decoder.rtplus:
        tags = " ".join(f"{k}='{v}'" for k, v in sorted(decoder.rtplus.items()))
        print(f"{prefix}RDS: RT+ {tags}", file=sys.stderr)
    for ev in decoder.tmc_events:
        print(f"{prefix}RDS: TMC {ev}", file=sys.stderr)
    for pi_on, on in sorted(decoder.eon.items()):
        extra = f" AF {sorted(on.af_mhz)}" if on.af_mhz else ""
        print(f"{prefix}RDS: EON PI=0x{pi_on:04X} PS='{on.ps_name}'{extra}",
              file=sys.stderr)
    for pi_on, ta in decoder.eon_ta_events:
        verb = "started" if ta else "ended"
        print(f"{prefix}RDS: EON TA {verb} on PI=0x{pi_on:04X} (14B)",
              file=sys.stderr)


def _batch_decode(cfg, files, max_blocks, kwargs, rds_groups=False,
                  pty_table="rbds") -> int:
    """Decode N stations as one channel-batched receiver (the multi-station
    deployment shape, driven from capture files)."""
    from rtsdr_tpu_torch.io.batch import BatchRunner
    from rtsdr_tpu_torch.io.stream import format_rds_events
    from rtsdr_tpu_torch.io.wav import WavStreamWriter

    missing = [f for f in files if not os.path.isfile(f)]
    if missing:
        print(f"error: capture file(s) not found: {', '.join(missing)}",
              file=sys.stderr)
        return 1

    n = len(files)
    decoders = _station_decoders(n, cfg, kwargs, rds_groups, pty_table)
    handles = [open(f, "rb") for f in files]
    writers: list = [None] * n  # opened on first block; stream per block
    events = 0

    def emit(c, left, right):
        if writers[c] is None:
            writers[c] = WavStreamWriter(files[c] + ".wav",
                                         fs=int(cfg.audio_fs))
        writers[c].write_float(left, right)

    def rds_hook(c, fo):
        nonlocal events
        for line in format_rds_events(fo):
            print(f"[{files[c]}] {line}", file=sys.stderr)
            events += 1
        if decoders is not None:
            _feed_groups(decoders, c, fo, f"[{files[c]}] ")

    want_rds = kwargs.get("enable_rds") is not False and cfg.rds is not None
    try:
        with BatchRunner(cfg, [h.fileno() for h in handles],
                         **kwargs) as runner:
            stats = runner.run(emit=emit,
                               rds_hook=rds_hook if want_rds else None,
                               max_blocks=max_blocks)
    finally:
        for h in handles:
            h.close()
        for w in writers:
            if w is not None:
                w.close()

    print(f"processed {stats['blocks']} blocks x {n} stations, "
          f"{events} RDS events", file=sys.stderr)
    if decoders is not None:
        for c in range(n):
            _print_rds_summary(decoders[c], prefix=f"[{files[c]}] ")
    return 0


def _station_decoders(n, cfg, kwargs, rds_groups, pty_table="rbds"):
    """Per-station GroupDecoders for the CLI paths (None when group
    decoding is off or the config has no RDS)."""
    if not rds_groups or cfg.rds is None \
            or kwargs.get("enable_rds") is False:
        return None
    from rtsdr_tpu_torch.pipeline.groups import GroupDecoder

    return [GroupDecoder(pty_table=pty_table) for _ in range(n)]


def _feed_groups(decoders, c, fo, label):
    """Feed one station's FrameOutputs to its decoder, printing completed
    groups tagged with ``label``."""
    from rtsdr_tpu_torch.pipeline.groups import format_group

    dec = decoders[c]
    for g in dec.feed(fo):
        print(f"{label}{format_group(g, dec.pty_table)}", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
