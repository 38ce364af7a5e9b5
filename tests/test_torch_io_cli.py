"""Host I/O and the command line of the port against the JAX package's:
the runtime copies bitwise, the CLI's int16 audio within 1 LSB of
``rtsdr_tpu.io.stream.StreamRunner`` on the same bytes (float32 audio
differing by 2e-5 can straddle a rounding step of 1/16384)."""

import os
import pathlib
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
from rtsdr_tpu_torch.io.stream import StreamRunner
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


def _cli(args, stdin_path=None, timeout=600):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    stdin = open(stdin_path, "rb") if stdin_path else subprocess.DEVNULL
    try:
        return subprocess.run(
            [sys.executable, "-m", "rtsdr_tpu_torch.cli", *args], stdin=stdin,
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


def test_cli_without_no_rds_exits_2():
    res = _cli(["0", "--device", "cpu"])
    assert res.returncode == 2
    assert b"RDS" in res.stderr and b"--no-rds" in res.stderr
    assert res.stdout == b""


def test_cli_default_device_without_gpu_names_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _cli(["0", "--no-rds"])
    assert res.returncode not in (0, 2)
    assert b"GPU" in res.stderr
    assert res.stdout == b""


@pytest.mark.parametrize("flag", ["--rds-groups", "--wideband", "--clock",
                                  "--scan", "--derotate", "--rds"])
def test_cli_unported_flags_are_absent(flag):
    res = _cli(["0", "--no-rds", "--device", "cpu", flag])
    assert res.returncode == 2                       # argparse usage error
    assert b"unrecognized arguments" in res.stderr or b"usage" in res.stderr


def test_cli_mode_1_is_rejected():
    res = _cli(["1", "--no-rds", "--device", "cpu"])
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
