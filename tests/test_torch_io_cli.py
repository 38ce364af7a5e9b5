"""Host I/O and the command line of the port against the JAX package's:
the runtime copies bitwise, the CLI's int16 audio within 1 LSB of
``rtsdr_tpu.io.stream.StreamRunner`` on the same bytes (float32 audio
differing by 2e-5 can straddle a rounding step of 1/16384), and with RDS on
the same stderr lines (sync events, decoded groups, summary) as
``python -m rtsdr_tpu.cli``."""

import os
import pathlib
import re
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

from rtsdr_tpu import runtime as jrt
from rtsdr_tpu.config import MODE0 as JMODE0
from rtsdr_tpu.io.stream import StreamRunner as JStreamRunner
from rtsdr_tpu_torch import runtime as trt
from rtsdr_tpu_torch.config import MODE0
from rtsdr_tpu_torch.io.batch import BatchRunner
from rtsdr_tpu_torch.io.stream import StreamRunner, format_rds_events
from rtsdr_tpu_torch.pipeline.frame import FrameOutputs
from rtsdr_tpu_torch.pipeline.groups import GroupDecoder
from rtsdr_tpu_torch.utils import signals
from rtsdr_tpu_torch.utils.signals import fm_multiplex_iq

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_BLOCKS = 3
AUDIO_BYTES = N_BLOCKS * MODE0.audio_len * 2 * 2


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    path = tmp_path_factory.mktemp("iq") / "station.iq"
    # a partial trailing block, which every reader must drop
    raw = fm_multiplex_iq(N_BLOCKS * MODE0.iq_len + 500)
    raw.tofile(path)
    return path


N_RDS_BLOCKS = 6
PS_NAME, PI_CODE = "H100 FM ", 0x3A5C


@pytest.fixture(scope="module")
def rds_capture(tmp_path_factory):
    """A station that spells PS_NAME over 0A groups, N_RDS_BLOCKS blocks."""
    path = tmp_path_factory.mktemp("iq") / "rds_station.iq"
    words = signals.ps_station_words(30, PI_CODE, PS_NAME)
    wave = signals.rds_baseband(signals.encode_rds_blocks(words))
    fm_multiplex_iq(N_RDS_BLOCKS * MODE0.iq_len, rds_wave=wave).tofile(path)
    return path


def _ps_consistent(ps: str) -> bool:
    """Six blocks air about four groups: every PS segment that arrived
    must be right, and at least one must have arrived."""
    return (len(ps) == 8 and ps.strip() != ""
            and all(a in (" ", b) for a, b in zip(ps, PS_NAME)))


# a line of XLA's own logging ("E1016 18:11:44.842461   16123 file.cc:210] ..."),
# which the JAX runtime may write to stderr beside the CLI's lines
_XLA_LOG = re.compile(r"^[IWEF]\d{4} \d\d:\d\d:\d\d\.\d+\s+\d+ \S+:\d+\] ")


def _cli(args, stdin_path=None, timeout=600, module="rtsdr_tpu_torch.cli"):
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    stdin = open(stdin_path, "rb") if stdin_path else subprocess.DEVNULL
    try:
        return subprocess.run(
            [sys.executable, "-m", module, *args], stdin=stdin,
            capture_output=True, cwd=ROOT, env=env, timeout=timeout)
    finally:
        if stdin_path:
            stdin.close()


def test_emit_int16_interleave_bitwise(rng):
    left = (rng.standard_normal(4096) * 1.5).astype(np.float32)
    right = (rng.standard_normal(4096) * 1.5).astype(np.float32)
    left[7], right[9] = np.nan, np.nan
    left[11], right[13] = 5.0, -5.0          # clipping
    for scale in (16384.0, 32767.0):
        a = trt.emit_int16_interleave(left, right, scale)
        b = jrt.emit_int16_interleave(left, right, scale)
        assert a.dtype == b.dtype == np.int16
        assert np.array_equal(a, b)


def test_deinterleave_normalize_bitwise(rng):
    raw = rng.integers(0, 256, 2000, dtype=np.uint8)
    for a, b in zip(trt.deinterleave_normalize(raw),
                    jrt.deinterleave_normalize(raw)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("into", [False, True])
def test_block_reader_bitwise(rng, tmp_path, into):
    data = rng.integers(0, 256, 5 * 4096 + 100, dtype=np.uint8)
    path = tmp_path / "blocks.bin"
    data.tofile(path)
    got = []
    for mod in (trt, jrt):
        blocks = []
        with open(path, "rb") as f, mod.BlockReader(f.fileno(), 4096) as r:
            while True:
                if into:
                    dst = np.empty(4096, np.uint8)
                    if not r.read_block_into(dst):
                        break
                    blocks.append(dst)
                else:
                    blk = r.read_block()
                    if blk is None:
                        break
                    blocks.append(np.array(blk))
        got.append(np.concatenate(blocks))
    assert got[0].size == 5 * 4096          # the partial block is dropped
    assert np.array_equal(got[0], got[1])
    assert np.array_equal(got[0], data[:5 * 4096])


def test_cli_audio_within_one_lsb_of_jax_stream_runner(capture, tmp_path):
    wav_path = tmp_path / "out.wav"
    res = _cli(["0", "--no-rds", "--device", "cpu", "--blocks", str(N_BLOCKS),
                "--wav", str(wav_path)], capture)
    assert res.returncode == 0, res.stderr.decode()
    assert len(res.stdout) == AUDIO_BYTES
    ours = np.frombuffer(res.stdout, np.int16).astype(np.int32)

    chunks = []
    runner = JStreamRunner(JMODE0, enable_rds=False, jit=False)
    with open(capture, "rb") as f:
        stats = runner.run(f.fileno(), emit=chunks.append,
                           max_blocks=N_BLOCKS)
    assert stats["blocks"] == N_BLOCKS
    theirs = np.frombuffer(b"".join(chunks), np.int16).astype(np.int32)
    assert ours.shape == theirs.shape
    assert int(np.max(np.abs(ours - theirs))) <= 1
    assert np.mean(ours != theirs) < 0.05
    assert int(np.max(np.abs(theirs))) > 8000     # a real signal, not zeros

    with wave.open(str(wav_path), "rb") as w:
        assert (w.getnchannels(), w.getframerate(), w.getsampwidth()) == \
            (2, 48000, 2)
        assert w.readframes(w.getnframes()) == res.stdout


def test_cli_runs_to_eof_and_drops_partial_block(capture):
    res = _cli(["0", "--no-rds", "--device", "cpu", "--no-stereo",
                "--deemphasis", "50", "--pll-div", "auto",
                "--stereo-blend"], capture)
    assert res.returncode == 0, res.stderr.decode()
    assert len(res.stdout) == AUDIO_BYTES
    pcm = np.frombuffer(res.stdout, np.int16).reshape(-1, 2)
    assert np.array_equal(pcm[:, 0], pcm[:, 1])      # mono on both channels


def test_cli_without_no_rds_exits_2(rds_capture):
    """Without ``--no-rds`` the CLI decodes RDS: its stderr lines (sync
    events, decoded groups, block summary, station summary) are those of
    the JAX package's CLI on the same capture, its audio within 1 LSB."""
    args = ["0", "--rds-groups"]
    ours = _cli(args + ["--device", "cpu"], rds_capture)
    assert ours.returncode == 0, ours.stderr.decode()
    theirs = _cli(args, rds_capture, module="rtsdr_tpu.cli")
    assert theirs.returncode == 0, theirs.stderr.decode()
    our_lines = ours.stderr.decode().splitlines()
    their_lines = [ln for ln in theirs.stderr.decode().splitlines()
                   if not ln.startswith("compiling receiver")
                   and not _XLA_LOG.match(ln)]
    assert our_lines == their_lines
    assert sum(ln.startswith("Syndrome ") for ln in our_lines) >= 10
    assert any(ln.startswith("Group 0A PI=0x3A5C") for ln in our_lines)
    (summary,) = [ln for ln in our_lines if ln.startswith("RDS: PI=")]
    assert summary.startswith(f"RDS: PI=0x{PI_CODE:04X} PTY=Rock PS='")
    assert _ps_consistent(summary.split("PS='")[1][:8])
    assert any(ln.startswith(f"processed {N_RDS_BLOCKS} blocks, ")
               and "RDS syncs" in ln for ln in our_lines)
    a = np.frombuffer(ours.stdout, np.int16).astype(np.int32)
    b = np.frombuffer(theirs.stdout, np.int16).astype(np.int32)
    assert a.shape == b.shape == (N_RDS_BLOCKS * MODE0.audio_len * 2,)
    assert int(np.max(np.abs(a - b))) <= 1


def test_cli_rds_flags_parse_and_run(rds_capture):
    res = _cli(["0", "--device", "cpu", "--blocks", "2", "--clock", "gardner",
                "--rds-ec", "--derotate", "--no-resync", "--pty-table", "rds",
                "--rds-groups", "--pll-div", "4"], rds_capture)
    assert res.returncode == 0, res.stderr.decode()
    assert len(res.stdout) == 2 * MODE0.audio_len * 4
    assert b"processed 2 blocks, " in res.stderr
    assert b"Re-Sync" not in res.stderr
    bad = _cli(["0", "--device", "cpu", "--clock", "nearest"])
    assert bad.returncode == 2


def test_cli_no_rds_prints_no_events(rds_capture):
    res = _cli(["0", "--no-rds", "--rds-groups", "--device", "cpu",
                "--blocks", "2"], rds_capture)
    assert res.returncode == 0, res.stderr.decode()
    assert res.stderr.decode().splitlines() == [
        "processed 2 blocks, 0 RDS syncs (0 false positives)"]


def test_cli_default_device_without_gpu_names_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _cli(["0", "--no-rds"])
    assert res.returncode not in (0, 2)
    assert b"GPU" in res.stderr
    assert res.stdout == b""


PORTED_FLAGS = {"--rds-groups": [], "--clock": ["hold"], "--derotate": [],
                "--rds": []}


@pytest.mark.parametrize("flag", ["--rds-groups", "--wideband", "--clock",
                                  "--scan", "--derotate", "--rds",
                                  "--channels", "--time-shards"])
def test_cli_unported_flags_are_absent(flag):
    """Every flag of the reference's CLI is accepted (empty stdin: 0
    blocks); ``--wideband`` without its K and flags the reference does not
    have are a usage error; ``--scan`` without ``--wideband`` is refused
    with the reference's words."""
    res = _cli(["0", "--no-rds", "--device", "cpu", flag,
                *PORTED_FLAGS.get(flag, [])])
    if flag in PORTED_FLAGS:
        assert res.returncode == 0, res.stderr.decode()
        assert b"processed 0 blocks" in res.stderr
    elif flag == "--scan":
        assert res.returncode == 1
        assert res.stderr.decode().splitlines() == [
            "error: --scan requires --wideband K"]
    else:
        assert res.returncode == 2                   # argparse usage error
        assert (b"unrecognized arguments" in res.stderr
                or b"usage" in res.stderr)


def test_cli_mode_1_is_rejected():
    """Modes 0 and 1 exist (mode 1 on an empty stdin: 0 blocks); any other
    mode is a usage error."""
    res = _cli(["1", "--no-rds", "--device", "cpu"])
    assert res.returncode == 0, res.stderr.decode()
    assert b"processed 0 blocks" in res.stderr
    res = _cli(["2", "--no-rds", "--device", "cpu"])
    assert res.returncode == 2


def test_batch_runner_matches_stream_runner(capture):
    """Two copies of one capture through BatchRunner == StreamRunner's
    audio, row by row (same plain arithmetic, batched)."""
    chunks = []
    with open(capture, "rb") as f:
        StreamRunner(MODE0, device="cpu", enable_rds=False).run(
            f.fileno(), emit=chunks.append, audio_scale=16384.0)
    single = np.frombuffer(b"".join(chunks), np.int16).reshape(-1, 2)

    rows = {0: [], 1: []}
    with open(capture, "rb") as f0, open(capture, "rb") as f1:
        with BatchRunner(MODE0, [f0.fileno(), f1.fileno()], device="cpu",
                         enable_rds=False) as runner:
            stats = runner.run(
                emit=lambda c, l, r: rows[c].append(
                    trt.emit_int16_interleave(l, r, 16384.0)))
    assert stats == {"blocks": N_BLOCKS, "stations": 2}
    for c in (0, 1):
        got = np.concatenate(rows[c]).reshape(-1, 2)
        assert got.shape == single.shape
        assert int(np.max(np.abs(got.astype(np.int32) - single))) <= 1


def test_wav_and_binio_copies(tmp_path, rng):
    from rtsdr_tpu.io import binio as jbin
    from rtsdr_tpu_torch.io import binio as tbin
    from rtsdr_tpu_torch.io.wav import write_wav

    x = rng.standard_normal(1000).astype(np.float32)
    tbin.write_f32(str(tmp_path / "a.bin"), x)
    assert np.array_equal(jbin.read_f32(str(tmp_path / "a.bin")), x)
    raw = rng.integers(0, 256, 1000, dtype=np.uint8)
    raw.tofile(tmp_path / "b.iq")
    for norm in (False, True):
        assert np.array_equal(tbin.read_iq_u8(str(tmp_path / "b.iq"), norm),
                              jbin.read_iq_u8(str(tmp_path / "b.iq"), norm))
    write_wav(str(tmp_path / "c.wav"), x * 0.1, x * 0.2)
    with wave.open(str(tmp_path / "c.wav"), "rb") as w:
        assert w.getnchannels() == 2 and w.getnframes() == 1000


def test_stream_runner_rds_hooks_and_stats(rds_capture):
    """``rds_log`` gets the event lines, ``frame_hook`` host-array
    FrameOutputs that a GroupDecoder decodes, the stats count what was
    logged — and equal the JAX runner's on the same capture."""
    lines, frames = [], []
    dec = GroupDecoder()
    runner = StreamRunner(MODE0, device="cpu", resync=True)
    with open(rds_capture, "rb") as f:
        stats = runner.run(
            f.fileno(), rds_log=lines.append,
            frame_hook=lambda fo: (frames.append(fo), dec.feed(fo)))
    assert stats["blocks"] == N_RDS_BLOCKS == len(frames)
    assert all(isinstance(fo, FrameOutputs)
               and isinstance(fo.is_sync, np.ndarray) for fo in frames)
    assert stats["rds_events"] == sum(
        ln.startswith("Syndrome ") for ln in lines) >= 10
    assert stats["rds_false_positives"] == sum(
        ln.startswith("False positive") for ln in lines)
    assert stats["rds_corrected"] == 0
    assert dec.pi == PI_CODE and _ps_consistent(dec.ps_name)

    j_lines = []
    with open(rds_capture, "rb") as f:
        j_stats = JStreamRunner(JMODE0, jit=False, resync=True).run(
            f.fileno(), rds_log=j_lines.append)
    assert j_lines == lines
    assert j_stats == stats


def test_format_rds_events_equals_jax():
    from rtsdr_tpu.io.stream import format_rds_events as j_format

    rng = np.random.default_rng(5)
    w = 77
    sid = (rng.random(w) < 0.3) * rng.integers(1, 6, w)
    sync = (sid > 0) & (rng.random(w) < 0.5)
    fo = FrameOutputs(
        n_sym=np.int32(152), symbols_i=np.zeros(152), symbols_q=np.zeros(152),
        n_windows=np.int32(60), syndrome_id=sid.astype(np.int32),
        is_sync=sync, is_false_pos=(sid > 0) & ~sync,
        positions=(1000 + np.arange(w)).astype(np.int32),
        is_resync=rng.random(w) < 0.05, info_word=np.zeros(w, np.int32),
        corrected=sync & (rng.random(w) < 0.3))
    lines = format_rds_events(fo)
    assert lines == j_format(fo)
    assert any("(corrected)" in ln for ln in lines)
    assert any(ln.startswith("False positive") for ln in lines)
    assert "~~~~~Re-Sync~~~~~" in lines


def test_batch_runner_rds_hook_per_station(rds_capture, capture):
    """``rds_hook(channel, FrameOutputs)``: per-station host arrays, equal
    to what a single-station run of the same capture yields; a station
    without RDS yields no syncs.  The hooks keep copies: a block's host
    arrays are the runner's until the next-but-one block's fetch."""
    def kept(fo):
        return FrameOutputs(*(np.array(a) for a in fo))

    single = []
    with open(rds_capture, "rb") as f:
        StreamRunner(MODE0, device="cpu").run(
            f.fileno(), frame_hook=lambda fo: single.append(kept(fo)),
            max_blocks=3)
    got = {0: [], 1: []}
    with open(rds_capture, "rb") as f0, open(capture, "rb") as f1:
        with BatchRunner(MODE0, [f0.fileno(), f1.fileno()],
                         device="cpu") as runner:
            stats = runner.run(
                rds_hook=lambda c, fo: got[c].append(kept(fo)))
    assert stats == {"blocks": 3, "stations": 2}
    assert len(got[0]) == len(got[1]) == 3
    for fo_b, fo_1 in zip(got[0], single):
        for name in fo_1._fields:
            a, b = getattr(fo_b, name), getattr(fo_1, name)
            assert a.shape == b.shape, name
            if b.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
            else:
                assert np.array_equal(a, b), name
    assert sum(int(fo.is_sync.sum()) for fo in got[0]) >= 3
    dec = GroupDecoder()
    for fo in got[0]:
        dec.feed(fo)
    assert dec.pi == PI_CODE


def test_cli_stations_with_rds(rds_capture, tmp_path):
    a, b = tmp_path / "a.iq", tmp_path / "b.iq"
    data = pathlib.Path(rds_capture).read_bytes()[:4 * MODE0.block_size]
    a.write_bytes(data)
    b.write_bytes(data)
    res = _cli(["0", "--device", "cpu", "--rds-groups", "--stations",
                str(a), str(b)])
    assert res.returncode == 0, res.stderr.decode()
    err = res.stderr.decode().splitlines()
    assert any(ln.startswith(f"[{a}] Syndrome ") for ln in err)
    assert any(ln.startswith(f"[{b}] Syndrome ") for ln in err)
    assert any(ln.startswith("processed 4 blocks x 2 stations, ")
               and ln.endswith(" RDS events") for ln in err)
    assert f"[{a}] RDS: PI=0x{PI_CODE:04X} PTY=Rock" in "\n".join(err)
    with wave.open(str(a) + ".wav", "rb") as w:
        assert w.getnframes() == 4 * MODE0.audio_len


# --------------------------------------------------------------- wideband

WB_K, WB_BLOCKS = 2, 5


@pytest.fixture(scope="module")
def wideband_capture(tmp_path_factory):
    """K = 2: slot 0 empty, slot 1 an RDS station 150 kHz off its center."""
    path = tmp_path_factory.mktemp("iq") / "band.iq"
    words = signals.ps_station_words(30, PI_CODE, PS_NAME)
    wave = signals.rds_baseband(signals.encode_rds_blocks(words))
    signals.wideband_capture_iq(
        WB_BLOCKS * MODE0.iq_len, WB_K, {1: dict(rds_wave=wave)},
        MODE0.rf.fs, [0.0, 150e3]).tofile(path)
    return path


def _cli_in(cwd, args, stdin_path, module):
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    with open(stdin_path, "rb") as f:
        return subprocess.run(
            [sys.executable, "-m", module, *args], stdin=f,
            capture_output=True, cwd=cwd, env=env, timeout=900)


def _wav_pcm(path):
    with wave.open(str(path), "rb") as w:
        assert (w.getnchannels(), w.getframerate()) == (2, 48000)
        return np.frombuffer(w.readframes(w.getnframes()),
                             np.int16).astype(np.int32)


def test_cli_wideband_decode_equals_jax_cli(wideband_capture, tmp_path):
    """``--wideband 2 --wideband-centers ... --rds-groups``: one
    channel<k>.wav per slot within 1 LSB of the JAX CLI's, and the same
    stderr lines ([chN]-tagged events and groups, the block summary, the
    per-station summaries)."""
    args = ["0", "--wideband", str(WB_K), "--wideband-centers=-2.25M",
            "--rds-groups"]
    dirs = {}
    for name, module, extra in (("ours", "rtsdr_tpu_torch.cli",
                                 ["--device", "cpu"]),
                                ("theirs", "rtsdr_tpu.cli", [])):
        cwd = tmp_path / name
        cwd.mkdir()
        res = _cli_in(cwd, args + extra, wideband_capture, module)
        assert res.returncode == 0, res.stderr.decode()
        assert res.stdout == b""
        dirs[name] = (cwd, [ln for ln in res.stderr.decode().splitlines()
                            if not _XLA_LOG.match(ln)])
    (ours_dir, ours), (theirs_dir, theirs) = dirs["ours"], dirs["theirs"]
    # slot 1 sits at -2.4M (wrapped): -2.25M is 150 kHz above its center
    assert ours[0] == "wideband channel centers (Hz): +0M -2.25M"
    # the empty slot demodulates noise, where two float32 routes part and
    # chance syndromes differ: the station's slot and the untagged lines
    # are compared
    keep = lambda lines: [ln for ln in lines if not ln.startswith("[ch0]")
                          and not ln.startswith("processed ")]
    assert keep(ours) == keep(theirs)
    assert sum(ln.startswith("[ch1] Syndrome ") for ln in ours) >= 8
    assert any(ln.startswith(f"[ch1] Group 0A PI=0x{PI_CODE:04X}")
               for ln in ours)
    assert any(ln.startswith(f"processed {WB_BLOCKS} wideband blocks x "
                             f"{WB_K} channels, ") for ln in ours)
    assert any(ln.startswith(f"[ch1] RDS: PI=0x{PI_CODE:04X}")
               for ln in ours)
    for c in range(WB_K):
        a = _wav_pcm(ours_dir / f"channel{c}.wav")
        b = _wav_pcm(theirs_dir / f"channel{c}.wav")
        assert a.shape == b.shape == (WB_BLOCKS * MODE0.audio_len * 2,)
        if c == 1:      # the empty slot demodulates noise: not compared
            # (wavs are written at full scale 32767: 2e-4 is 7 LSB)
            assert int(np.max(np.abs(a - b))) <= 8
            assert int(np.max(np.abs(a))) > 8000


def test_cli_wideband_auto_scans_then_decodes_active_slots(wideband_capture,
                                                           tmp_path):
    res = _cli_in(tmp_path, ["0", "--wideband", str(WB_K), "--auto",
                             "--no-rds", "--device", "cpu"],
                  wideband_capture, "rtsdr_tpu_torch.cli")
    assert res.returncode == 0, res.stderr.decode()
    table = res.stdout.decode().splitlines()
    assert len(table) == 1 + WB_K
    assert table[1].split()[-1] == "empty"
    # 150 kHz off its center and not mixed out: the scanner still sees it
    assert table[2].split()[-1].startswith("station")
    err = res.stderr.decode().splitlines()
    assert err[0] == (f"auto: 1/{WB_K} slots active after 3-block scan; "
                      "decoding those")
    assert err[-1] == (f"processed {WB_BLOCKS - 3} wideband blocks x {WB_K} "
                       "channels, 0 RDS events")
    assert not (tmp_path / "channel0.wav").exists()
    assert _wav_pcm(tmp_path / "channel1.wav").size == \
        (WB_BLOCKS - 3) * MODE0.audio_len * 2


def test_cli_wideband_centers_errors_exit_1(tmp_path):
    """Two centres closer than a station's 200 kHz channel are refused
    (two in one slot, 200 kHz apart or more, are two stations)."""
    res = _cli(["0", "--wideband", "4", "--wideband-centers", "2.3M,2.4M",
                "--device", "cpu"])
    assert res.returncode == 1
    assert res.stderr.decode().startswith(
        "error: 2.4M and 2.3M are 100 kHz apart — under a station's "
        "200 kHz channel")
