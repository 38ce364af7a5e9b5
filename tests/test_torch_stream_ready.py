"""The block reader's ready count (``runtime/__init__.py``:
``BlockReader.ready``, the native ``rtsdr_reader_ready``, its NumPy
fallback and the rebuild of a stale library) and ``StreamRunner``'s rule
built on it: a block is drained at once when the next one has not arrived,
and held for one block when it has, with the same output either way; and
the runner's input pipe made to hold a block.

Every test that waits on a pipe waits with a deadline of its own and
closes the pipe when it runs out, so a loop that never drains fails the
test instead of hanging it."""

import fcntl
import os
import shutil
import subprocess
import threading
import time

import numpy as np
import pytest
import torch

from rtsdr_tpu_torch import runtime as rt
from rtsdr_tpu_torch.config import MODE0
from rtsdr_tpu_torch.io.stream import StreamRunner, hold_a_block
from rtsdr_tpu_torch.utils import signals
from rtsdr_tpu_torch.utils.signals import fm_multiplex_iq

torch.set_num_threads(1)

BS = 4096          # reader tests: bytes a block
MONO = dict(device="cpu", enable_rds=False, enable_stereo=False)


def _poll(fn, want, seconds=1.0):
    """``fn()`` until it returns ``want`` or ``seconds`` pass; its last
    value."""
    deadline = time.monotonic() + seconds
    got = fn()
    while got != want and time.monotonic() < deadline:
        time.sleep(0.005)
        got = fn()
    return got


@pytest.fixture
def pipe():
    r_fd, w_fd = os.pipe()
    ends = {"r": r_fd, "w": w_fd}
    yield ends
    for fd in ends.values():
        if fd is not None:
            try:
                os.close(fd)
            except OSError:
                pass


def _close_writer(ends):
    os.close(ends["w"])
    ends["w"] = None


def test_native_ready_empty_pipe_does_not_wait(pipe):
    assert rt.have_native(), "C++ runtime failed to build"
    with rt.BlockReader(pipe["r"], BS) as reader:
        t0 = time.perf_counter()
        got = reader.ready()
        took = time.perf_counter() - t0
    assert got == 0
    assert took < 0.05


def test_native_ready_counts_whole_blocks(pipe):
    with rt.BlockReader(pipe["r"], BS, n_slots=4) as reader:
        for n in (1, 3):
            os.write(pipe["w"], bytes(BS) * (n - reader.ready()))
            assert _poll(reader.ready, n) == n
        dst = np.empty(BS, np.uint8)
        assert reader.read_block_into(dst)
        assert reader.ready() == 2


def test_native_ready_ignores_a_partial_block(pipe):
    with rt.BlockReader(pipe["r"], BS) as reader:
        os.write(pipe["w"], bytes(BS // 2))
        time.sleep(0.1)                      # the producer has the half
        assert reader.ready() == 0
        os.write(pipe["w"], bytes(BS // 2 + 10))
        assert _poll(reader.ready, 1) == 1   # the block, not the 10 bytes
        time.sleep(0.05)
        assert reader.ready() == 1


def test_native_ready_is_minus_one_after_the_end(pipe):
    with rt.BlockReader(pipe["r"], BS) as reader:
        os.write(pipe["w"], bytes(2 * BS + 7))
        _close_writer(pipe)
        # the end is seen only once every whole block is taken
        assert _poll(reader.ready, 2) == 2
        dst = np.empty(BS, np.uint8)
        assert reader.read_block_into(dst)
        assert reader.ready() == 1
        assert reader.read_block_into(dst)
        assert _poll(reader.ready, -1) == -1
        assert not reader.read_block_into(dst)
        assert reader.ready() == -1


def test_native_ready_over_a_regular_file(tmp_path):
    """A regular file's next block waits on no writer: at least 1 until
    the end, whether or not the producer has read it ahead yet."""
    path = tmp_path / "c.iq"
    path.write_bytes(bytes(3 * BS + 5))
    dst = np.empty(BS, np.uint8)
    with open(path, "rb") as f, rt.BlockReader(f.fileno(), BS) as reader:
        assert reader._h is not None
        for _ in range(3):
            assert reader.ready() >= 1
            assert reader.read_block_into(dst)
        assert _poll(reader.ready, -1) == -1
        assert not reader.read_block_into(dst)


def test_fallback_ready_file_and_pipe(tmp_path, pipe, monkeypatch):
    """Without the native library: a regular file has its next block
    there (1); a pipe is never assumed to (0)."""
    monkeypatch.setattr(rt, "_load", lambda: None)
    path = tmp_path / "c.iq"
    path.write_bytes(bytes(3 * BS))
    with open(path, "rb") as f, rt.BlockReader(f.fileno(), BS) as reader:
        assert reader._h is None
        assert reader.ready() == 1
    with rt.BlockReader(pipe["r"], BS) as reader:
        assert reader._h is None
        assert reader.ready() == 0
        os.write(pipe["w"], bytes(BS))
        assert reader.ready() == 0


@pytest.fixture
def runtime_copy(tmp_path, monkeypatch):
    """``_load`` pointed at a copy of the runtime's directory."""
    d = tmp_path / "runtime"
    d.mkdir()
    for name in ("Makefile", "ingest.cpp"):
        shutil.copy2(os.path.join(rt._DIR, name), d / name)
    monkeypatch.setattr(rt, "_DIR", str(d))
    monkeypatch.setattr(rt, "_SO", str(d / "librtsdr_runtime.so"))
    monkeypatch.setattr(rt, "_lib", None)
    monkeypatch.setattr(rt, "_build_failed", False)
    return d


def _so_with_ready(lib) -> bool:
    return lib is not None and hasattr(lib, "rtsdr_reader_ready")


def test_stale_library_older_than_its_source_is_rebuilt(runtime_copy):
    so = runtime_copy / "librtsdr_runtime.so"
    subprocess.run(["make", "-C", str(runtime_copy)], check=True,
                   capture_output=True)
    src_mtime = os.path.getmtime(runtime_copy / "ingest.cpp")
    os.utime(so, (src_mtime - 3600, src_mtime - 3600))
    lib = rt._load()
    assert _so_with_ready(lib)
    assert os.path.getmtime(so) >= src_mtime


# -- the loop ----------------------------------------------------------------

N_BLOCKS = 6


@pytest.fixture(scope="module")
def capture_bytes():
    return fm_multiplex_iq(N_BLOCKS * MODE0.iq_len).tobytes()


def test_gated_writer_gets_every_block_out(capture_bytes):
    """A writer that sends block b + 1 only once block b's audio is out:
    every block is emitted before the next is written.  A loop that holds
    each block for the next would wait forever; the writer gives up on an
    emit after a deadline and closes the pipe, so that the test fails."""
    bs = MODE0.block_size
    runner = StreamRunner(MODE0, **MONO)
    emitted = []
    cond = threading.Condition()
    order = []          # ("write", b) and ("emit", b), as they happened

    def emit(pcm):
        with cond:
            order.append(("emit", len(emitted)))
            emitted.append(pcm)
            cond.notify_all()

    r_fd, w_fd = os.pipe()

    def writer():
        with os.fdopen(w_fd, "wb", buffering=0) as f:
            for b in range(N_BLOCKS):
                with cond:
                    order.append(("write", b))
                f.write(capture_bytes[b * bs:(b + 1) * bs])
                with cond:
                    if not cond.wait_for(lambda: len(emitted) > b,
                                         timeout=60):
                        return
    th = threading.Thread(target=writer)
    th.start()
    try:
        stats = runner.run(r_fd, emit=emit)
    finally:
        th.join(timeout=120)
        os.close(r_fd)
    assert not th.is_alive()
    assert stats["blocks"] == N_BLOCKS
    assert order == [(kind, b) for b in range(N_BLOCKS)
                     for kind in ("write", "emit")]
    assert all(len(pcm) == MODE0.audio_len * 2 * 2 for pcm in emitted)


def test_the_runner_pipe_holds_a_block(capture_bytes, pipe):
    """The runner's input pipe is grown to hold a whole block (past the
    default 64 KiB), so that the writer's block is one write and one
    read; it is never shrunk, and a regular file is left alone."""
    bs = MODE0.block_size
    assert fcntl.fcntl(pipe["r"], fcntl.F_GETPIPE_SZ) < bs
    os.write(pipe["w"], capture_bytes[:1000])     # a part of a block
    _close_writer(pipe)
    stats = StreamRunner(MODE0, **MONO).run(pipe["r"], emit=None)
    assert stats["blocks"] == 0
    size = fcntl.fcntl(pipe["r"], fcntl.F_GETPIPE_SZ)
    assert size >= bs
    hold_a_block(pipe["r"], bs // 2)
    assert fcntl.fcntl(pipe["r"], fcntl.F_GETPIPE_SZ) == size


def test_hold_a_block_leaves_a_file_alone(tmp_path):
    path = tmp_path / "c.iq"
    path.write_bytes(bytes(16))
    with open(path, "rb") as f:
        hold_a_block(f.fileno(), 1 << 20)    # no error, nothing to grow
        assert f.read() == bytes(16)


@pytest.fixture(scope="module")
def rds_bytes():
    words = signals.ps_station_words(30, 0x3A5C, "H100 FM ")
    wave = signals.rds_baseband(signals.encode_rds_blocks(words))
    return fm_multiplex_iq(N_BLOCKS * MODE0.iq_len, rds_wave=wave).tobytes()


def _run_route(runner, data, ready, monkeypatch):
    """One run over a pipe fed all at once, with the reader's ready count
    pinned to ``ready``: what came out, block by block."""
    monkeypatch.setattr(rt.BlockReader, "ready", lambda self: ready)
    pcm, lines, frames = [], [], []

    def emit(b):
        pcm.append(b)
        lines.append([])

    def frame_hook(fo):
        frames.append({k: np.asarray(v).copy()
                       for k, v in fo._asdict().items()})

    r_fd, w_fd = os.pipe()

    def fill():
        with os.fdopen(w_fd, "wb") as f:
            f.write(data)
    th = threading.Thread(target=fill)
    th.start()
    try:
        stats = runner.run(r_fd, emit=emit,
                           rds_log=lambda s: lines[-1].append(s),
                           frame_hook=frame_hook)
    finally:
        th.join(timeout=120)
        os.close(r_fd)
    return stats, pcm, lines, frames


def test_a_file_keeps_the_overlap(capture_bytes, tmp_path):
    """Over a regular file every block is held for the next one
    (``rtsdr.emit``'s ``early`` 0): its input is always ahead."""
    from rtsdr_tpu_torch.utils import trace as tr

    path = tmp_path / "c.iq"
    path.write_bytes(capture_bytes)
    runner = StreamRunner(MODE0, **MONO)
    tr.clear()
    try:
        with open(path, "rb") as f, tr.profile():
            stats = runner.run(f.fileno(), emit=lambda pcm: None)
        early = [r["attrs"]["early"] for r in tr.recorded()
                 if r["name"] == "rtsdr.emit"]
    finally:
        tr.clear()
    assert stats["blocks"] == N_BLOCKS
    assert early == [0] * N_BLOCKS


def test_early_and_held_routes_give_the_same_output(rds_bytes, monkeypatch):
    """Every block drained early (ready 0) and every block held (ready 1):
    the same int16 bytes, ``rds_log`` lines and frame outputs block for
    block, and the same stats."""
    runner = StreamRunner(MODE0, device="cpu", resync=True)
    early = _run_route(runner, rds_bytes, 0, monkeypatch)
    held = _run_route(runner, rds_bytes, 1, monkeypatch)
    stats, pcm, lines, frames = early
    assert stats["blocks"] == N_BLOCKS and stats["rds_events"] > 0
    assert stats == held[0]
    assert len(pcm) == len(frames) == N_BLOCKS
    assert pcm == held[1]
    assert lines == held[2] and sum(map(len, lines)) > 0
    for a, b in zip(frames, held[3]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
