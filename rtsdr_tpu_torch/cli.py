"""CLI entry point of the PyTorch/CUDA port — ``rtsdr_tpu/cli.py``'s
counterpart on a shell pipeline:

    rtl_sdr -f 107.9e6 -s 2.4e6 - | rtsdr-tpu-torch 0 | \\
        aplay -f S16_LE -c 2 -r 48000

Interleaved uint8 IQ on stdin, interleaved int16 stereo at 48 kS/s on
stdout, RDS frame-sync events (and, with ``--rds-groups``, decoded group
payloads) on stderr.  Runs on the GPU unless ``--device cpu`` is given.
Mode 0 (2.4 MS/s, RDS) and mode 1 (2.5 MS/s, x24/125 audio; ``--rds`` adds
RDS); ``--stations`` decodes many capture files as one batch;
``--wideband K`` decodes K stations from one capture at K x the RF rate,
``--scan`` surveys it, ``--auto`` does both.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", nargs="?", type=int, default=0, choices=(0, 1),
                   help="0: 2.4 MS/s + RDS; 1: 2.5 MS/s, x24/125 audio")
    p.add_argument("--blocks", type=int, default=None,
                   help="stop after N blocks (default: run to EOF)")
    p.add_argument("--no-rds", action="store_true", help="audio only")
    p.add_argument("--rds", action="store_true",
                   help="enable RDS in mode 1 (the reference disables its "
                        "RDS thread off mode 0, but the 250 kS/s IF still "
                        "carries the 57 kHz subcarrier; resampled x57/250)")
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
    p.add_argument("--wideband", type=int, metavar="K", default=None,
                   help="treat stdin as ONE wideband capture at K x the "
                        "mode's RF rate; the channelizer splits it into K "
                        "stations decoded in one batched step, writing "
                        "channel<k>.wav per station")
    p.add_argument("--wideband-centers", type=str, default=None,
                   metavar="F0,F1,...",
                   help="with --wideband K: real station center frequencies "
                        "relative to the capture center (Hz; 'M'/'k' "
                        "suffixes ok, e.g. '+0.1M,-0.9M').  Each is "
                        "assigned to its nearest channel slot and the "
                        "residual offset is mixed out: OFF-GRID stations "
                        "on the 100/200 kHz raster decode at full quality")
    p.add_argument("--scan", action="store_true",
                   help="with --wideband K: don't decode, just survey the "
                        "band — per-channel RSSI, 19 kHz pilot SNR and "
                        "57 kHz RDS SNR with a station/stereo/rds verdict")
    p.add_argument("--auto", action="store_true",
                   help="with --wideband K: scan the first blocks, print "
                        "the survey table, then decode the rest of the "
                        "capture writing wavs / RDS output only for slots "
                        "classified as stations")
    p.add_argument("--stations", nargs="+", metavar="FILE", default=None,
                   help="batch mode: decode N capture files as one batched "
                        "receiver step; writes FILE.wav per station, RDS "
                        "events tagged [station] on stderr")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch versions)")
    args = p.parse_args(argv)

    from rtsdr_tpu_torch.config import MODE1_RDS, MODES
    from rtsdr_tpu_torch.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    cfg = MODES[args.mode]
    if args.rds and cfg.rds is None:
        cfg = MODE1_RDS
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

    if args.scan or args.auto:
        if not args.wideband:
            print(f"error: --{'scan' if args.scan else 'auto'} requires "
                  "--wideband K", file=sys.stderr)
            return 1
    if args.scan:
        return _band_scan(cfg, args.wideband, args.blocks, device)
    if args.stations:
        return _batch_decode(cfg, args.stations, args.blocks, kwargs,
                             rds_groups=args.rds_groups,
                             pty_table=args.pty_table)
    if args.wideband:
        if args.wideband_centers:
            offsets, err = _centers_to_offsets(cfg, args.wideband,
                                               args.wideband_centers)
            if err:
                print(f"error: {err}", file=sys.stderr)
                return 1
            kwargs["channel_offsets_hz"] = offsets
        active = None
        decode_blocks = args.blocks
        if args.auto:
            # 3 blocks = 1 warm-up + 2 averaged (192 ms of air time);
            # the rest of the capture goes to the decode pass
            scan = _scan_band(cfg, args.wideband, 3, device)
            if scan is None:
                print("error: capture too short to scan (--auto needs "
                      ">= 2 wideband blocks before decode)",
                      file=sys.stderr)
                return 1
            mean, verdicts, used = scan
            _print_scan_table(cfg, args.wideband, mean, verdicts)
            active = [v != "empty" for v in verdicts]
            n_act = sum(active)
            print(f"auto: {n_act}/{args.wideband} slots active after "
                  f"{used}-block scan; decoding those", file=sys.stderr)
            if not n_act:
                print("auto: no active stations found", file=sys.stderr)
                return 0
            if decode_blocks is not None:
                # the scan pass counts toward --blocks: N total blocks
                # are consumed, scan first, decode the remainder
                decode_blocks = max(0, decode_blocks - used)
        return _wideband_decode(cfg, args.wideband, decode_blocks, kwargs,
                                rds_groups=args.rds_groups, active=active,
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


def _parse_freq(s: str) -> float:
    """'98.1M' / '-200k' / '150000' -> Hz."""
    s = s.strip()
    mult = 1.0
    if s and s[-1] in "Mm":
        mult, s = 1e6, s[:-1]
    elif s and s[-1] in "Kk":
        mult, s = 1e3, s[:-1]
    return float(s) * mult


def _centers_to_offsets(cfg, k, spec):
    """Map real station centers (relative to the capture center) onto the
    K-slot grid: each listed frequency claims its NEAREST slot, and the
    residual becomes that slot's mix-out offset.  Returns (offsets, err)."""
    import numpy as np

    from rtsdr_tpu_torch.ops.channelizer import channel_center_freqs

    slots = channel_center_freqs(k, k * cfg.rf.fs)
    fs_w = k * cfg.rf.fs
    offsets = np.zeros(k)
    taken: dict = {}
    for tok in spec.split(","):
        if not tok.strip():
            continue
        try:
            f = _parse_freq(tok)
        except ValueError:
            return None, f"bad frequency {tok!r}"
        # wrapped distance on the fs_w circle (slot 0 covers both edges)
        d = np.abs(np.mod(f - slots + fs_w / 2, fs_w) - fs_w / 2)
        c = int(np.argmin(d))
        if c in taken:
            return None, (f"{tok.strip()} and {taken[c]} both map to "
                          f"channel {c} ({slots[c] / 1e6:+.1f}M)")
        taken[c] = tok.strip()
        off = np.mod(f - slots[c] + fs_w / 2, fs_w) - fs_w / 2
        # decodability bound: the station's ±100 kHz spectrum must stay
        # inside its slot's passband after the mix-out.  A violation
        # almost always means an ABSOLUTE RF frequency was typed instead
        # of a capture-relative one (it wraps mod fs_w onto an arbitrary
        # slot); without this check the result is silent noise wavs.
        limit = 0.5 * cfg.rf.fs - 100e3
        if abs(off) > limit:
            return None, (
                f"{tok.strip()} is {off / 1e3:+.0f} kHz from its nearest "
                f"slot center ({slots[c] / 1e6:+.1f}M) — beyond the "
                f"decodable ±{limit / 1e3:.0f} kHz.  Frequencies are "
                "relative to the capture center (e.g. '+0.1M'), not "
                "absolute RF")
        offsets[c] = off
    return offsets, None


def _read_exact_fd(fd: int, n: int) -> bytearray | None:
    """Read exactly n bytes from a RAW fd (os.read loop; short reads on
    pipes are not EOF).  Raw, not sys.stdin.buffer: a buffered reader
    over-fetches into its internal buffer, and any leftover there is
    invisible to a later raw-fd consumer — --auto hands the same stream
    from the scan pass to _wideband_decode's BlockReader, so a buffered
    scan would silently drop bytes at the handoff and misalign (even
    I/Q-swap) the entire decode."""
    parts = bytearray()
    while len(parts) < n:
        chunk = os.read(fd, min(n - len(parts), 1 << 20))
        if not chunk:
            return None
        parts.extend(chunk)
    return parts


def _scan_band(cfg, k, max_blocks, device):
    """Run the band scanner over the next stdin blocks, compiled without
    donation as the JAX CLI jits it (``utils/jit.py::jit_fn``): the first
    block captures the step, and each later block is written straight into
    the compiled step's static input buffer.

    Returns (mean ScanMetrics of host arrays, verdicts, blocks consumed) or
    None if the capture is too short (<2 blocks; block 0 carries warm-up
    transients).
    """
    import numpy as np
    import torch

    from rtsdr_tpu_torch.io.staging import Feeder
    from rtsdr_tpu_torch.pipeline.scan import (
        ScanMetrics,
        classify,
        make_band_scanner,
    )
    from rtsdr_tpu_torch.utils.jit import jit_fn

    init_fn, step_fn = make_band_scanner(cfg, k, device=device)
    step = jit_fn(step_fn, device, name="band scanner")
    state = init_fn()
    wbs = k * cfg.block_size
    fd = sys.stdin.fileno()
    feeder = None
    acc = []
    blocks = 0
    while max_blocks is None or blocks < max_blocks:
        raw = _read_exact_fd(fd, wbs)
        if raw is None:
            break
        if feeder is None:       # block 0: the call that captures
            blk = torch.frombuffer(raw, dtype=torch.uint8).to(device)
        else:
            feeder.staging()[:] = np.frombuffer(raw, np.uint8)
            blk = feeder.push()
        m, state = step(state, blk)
        if feeder is None:
            feeder = Feeder((wbs,), step.device, into=step.static_args()[1])
        if blocks > 0:   # block 0 carries filter warm-up transients
            acc.append([x.cpu().numpy() for x in m])
        blocks += 1
    if not acc:
        return None
    mean = ScanMetrics(*(np.mean(np.stack(xs), axis=0) for xs in zip(*acc)))
    return mean, classify(mean), blocks


def _print_scan_table(cfg, k, mean, verdicts):
    from rtsdr_tpu_torch.ops.channelizer import channel_center_freqs

    freqs = channel_center_freqs(k, k * cfg.rf.fs)
    print(f"{'ch':>3} {'center':>9} {'RSSI dB':>8} {'pilot dB':>9} "
          f"{'RDS dB':>7}  verdict")
    for c in range(k):
        print(f"{c:>3} {freqs[c] / 1e6:>+8.1f}M {mean.rssi_db[c]:>8.1f} "
              f"{mean.pilot_snr_db[c]:>9.1f} {mean.rds_snr_db[c]:>7.1f}  "
              f"{verdicts[c]}")


def _band_scan(cfg, k, max_blocks, device) -> int:
    """Survey a wideband stdin capture: per-channel activity metrics
    (pipeline/scan.py), block-averaged, as a table on stdout."""
    scan = _scan_band(cfg, k, max_blocks, device)
    if scan is None:
        print("error: need at least 2 wideband blocks to scan",
              file=sys.stderr)
        return 1
    mean, verdicts, blocks = scan
    _print_scan_table(cfg, k, mean, verdicts)
    print(f"scanned {blocks} wideband blocks x {k} channels",
          file=sys.stderr)
    return 0


def _wideband_decode(cfg, k, max_blocks, kwargs, rds_groups=False,
                     active=None, pty_table="rbds") -> int:
    """One wideband stdin capture -> K stations via the channelizer
    (pipeline/wideband.py), channel<k>.wav per station.

    ``active``: optional per-slot mask (from --auto's scan pass) — the
    batched step still decodes every slot (same device cost), but wavs,
    RDS events, and group summaries are emitted only for active ones."""
    import numpy as np

    from rtsdr_tpu_torch.io.staging import Feeder, Fetcher
    from rtsdr_tpu_torch.io.stream import (
        fetch_list,
        fetched_frame,
        format_rds_events,
    )
    from rtsdr_tpu_torch.io.wav import WavStreamWriter
    from rtsdr_tpu_torch.ops.channelizer import channel_center_freqs
    from rtsdr_tpu_torch.pipeline.wideband import make_wideband_receiver
    from rtsdr_tpu_torch.runtime import BlockReader
    from rtsdr_tpu_torch.utils.jit import borrowing, jit_step
    from rtsdr_tpu_torch.utils.trace import annotate

    # compiled with its state donated, as the JAX CLI's jax.jit(step_fn,
    # donate_argnums=0)
    device = kwargs["device"]
    init_fn, step = jit_step(*make_wideband_receiver(cfg, k, **kwargs),
                             device, name=f"wideband receiver K={k}")
    state = init_fn()
    freqs = channel_center_freqs(k, k * cfg.rf.fs)
    offs = kwargs.get("channel_offsets_hz")
    if offs is not None:
        freqs = freqs + np.asarray(offs)
    print("wideband channel centers (Hz):",
          " ".join(f"{f / 1e6:+.3g}M" for f in freqs), file=sys.stderr)

    wbs = k * cfg.block_size
    step, into = borrowing(step, (wbs,))
    feeder = Feeder((wbs,), device, into)
    fetcher = Fetcher(device)
    writers: list = [None] * k
    decoders = _station_decoders(k, cfg, kwargs, rds_groups, pty_table)
    blocks = 0
    events = 0

    def drain(ticket):
        """Emit one block's outputs: ONE device->host fetch per leaf,
        then row slices (an ``rtsdr.emit`` span; every block is held
        until the next one has been read)."""
        nonlocal events
        if ticket is None:
            return
        with annotate("rtsdr.emit", block=ticket.block, early=0):
            arrays = fetcher.wait(ticket)
            left, right = arrays[:2]
            rds = fetched_frame(arrays)
            for c in range(k):
                if active is not None and not active[c]:
                    continue
                if writers[c] is None:
                    writers[c] = WavStreamWriter(f"channel{c}.wav",
                                                 fs=int(cfg.audio_fs))
                writers[c].write_float(left[c], right[c])
                if rds is not None:
                    fo = type(rds)(*(leaf[c] for leaf in rds))
                    for line in format_rds_events(fo):
                        print(f"[ch{c}] {line}", file=sys.stderr)
                        events += 1
                    if decoders is not None:
                        _feed_groups(decoders, c, fo, f"[ch{c}] ")

    pending = None
    try:
        # prefetching C++ reader + one-block-lag drain: stdin reads and
        # host emission both overlap device compute
        with BlockReader(sys.stdin.fileno(), wbs) as reader:
            while max_blocks is None or blocks < max_blocks:
                with annotate("rtsdr.read", block=blocks,
                              bytes=wbs) as span:
                    if span:
                        span.add(ready=reader.ready())
                    got = reader.read_block_into(feeder.staging())
                    if not got:
                        span.add(bytes=0)
                if not got:
                    break
                state, out = step(state, feeder.push())
                ticket = fetcher.start(fetch_list(out))
                drain(pending)
                pending = ticket
                blocks += 1
        drain(pending)
    finally:
        for w in writers:
            if w is not None:
                w.close()

    print(f"processed {blocks} wideband blocks x {k} channels, "
          f"{events} RDS events", file=sys.stderr)
    if decoders is not None:
        for c in range(k):
            if active is None or active[c]:
                _print_rds_summary(decoders[c], prefix=f"[ch{c}] ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
