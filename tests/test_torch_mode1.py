"""Mode 1 (2.5 MS/s, 320,000-byte blocks, IF 250 kS/s, x24/125 audio
resampler) and MODE1_RDS (RDS resampled x57/250 through the 9,003-tap
composed filter) of the port against the JAX receiver with the same
arguments on the same bytes, at full width, batch (2,).

Tolerances as for mode 0 (tests/test_torch_receiver.py): audio 2e-5, state
leaves 1e-5 of their scale, the PLL's 1e-3; with RDS on, from a mid-stream
state (the JAX receiver's after block 0, converted), rrc within 1e-4 of its
peak, the bit layer's integers equal and its symbols within 1e-4 of their
peak.  The CLI's int16 audio within 1 LSB of the JAX ``StreamRunner``, its
stderr lines equal to that runner's event lines.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsdr_tpu.config import MODE1 as JMODE1
from rtsdr_tpu.config import MODE1_RDS as JMODE1_RDS
from rtsdr_tpu.io.stream import StreamRunner as JStreamRunner
from rtsdr_tpu.pipeline import receiver as jrx
from rtsdr_tpu_torch.config import MODE1, MODE1_RDS
from rtsdr_tpu_torch.io.stream import StreamRunner
from rtsdr_tpu_torch.pipeline import receiver as trx
from rtsdr_tpu_torch.pipeline.groups import GroupDecoder
from rtsdr_tpu_torch.utils import signals
from rtsdr_tpu_torch.utils.convert import state_from_numpy

from test_torch_receiver import (
    _assert_audio_close,
    _assert_frame_outputs_equal,
    _assert_states_close,
)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_BLOCKS = 3
PI_CODE, PS_NAME = 0x3A5C, "MODE ONE"


def _stations(n_blocks, rds: bool):
    """(n_blocks, 2, 320000) u8: two stations at 2.5 MS/s."""
    rows = []
    for k, ps in enumerate((PS_NAME, "STATION2")):
        wave = None
        if rds:
            wave = signals.rds_baseband(signals.encode_rds_blocks(
                signals.ps_station_words(8 * n_blocks, PI_CODE + k, ps)))
        rows.append(signals.fm_multiplex_iq(
            n_blocks * MODE1.iq_len, MODE1.rf.fs, rds_wave=wave,
            mono_hz=1.1e3 - 400.0 * k, pilot_phase=0.9 * k))
    return np.stack(rows).reshape(2, n_blocks, MODE1.block_size
                                  ).transpose(1, 0, 2).copy()


@pytest.fixture(scope="module")
def rds_blocks():
    return _stations(N_BLOCKS, rds=True)


def test_mode1_shapes():
    assert (MODE1.block_size, MODE1.if_len, MODE1.audio_len) == (
        320000, 16000, 3072)
    assert (MODE1_RDS.rds_len, MODE1_RDS.max_symbols) == (3648, 152)
    assert MODE1_RDS.rds.pll.phase_adjust == JMODE1_RDS.rds.pll.phase_adjust


@pytest.mark.parametrize("enable_stereo", [True, False])
def test_mode1_audio_matches_jax(enable_stereo):
    blocks = _stations(2, rds=False)
    t_init, t_step = trx.make_receiver(MODE1, (2,), device="cpu",
                                       enable_stereo=enable_stereo)
    j_init, j_step = jrx.make_receiver(JMODE1, (2,),
                                       enable_stereo=enable_stereo)
    t_state, j_state = t_init(), j_init()
    assert t_state.rds is None and t_state.frame is None
    _assert_states_close(t_state, j_state)
    for b in range(2):
        t_state, t_out = t_step(t_state, torch.as_tensor(blocks[b]))
        j_state, j_out = j_step(j_state, jnp.asarray(blocks[b]))
        assert t_out.rds is None
        assert tuple(t_out.left.shape) == (2, MODE1.audio_len)
        _assert_audio_close(t_out, j_out)
        _assert_states_close(t_state, j_state)


def test_mode1_route_is_the_fm_ingest_kernel_and_the_stock_resampler(
        monkeypatch):
    """``mono.up`` = 24: no audio stage in the ingest kernel; the front end
    is ``ingest_fir_demod`` and both audio branches go through one stacked
    ``fir_resample`` call."""
    from rtsdr_tpu_torch.pipeline import audio as taudio
    from rtsdr_tpu_torch.pipeline import frontend as tfrontend

    seen = []
    for mod, name in ((tfrontend, "ingest_fir_demod"),
                      (trx, "ingest_fir_demod_audio"),
                      (taudio, "fir_resample")):
        inner = getattr(mod, name)
        monkeypatch.setattr(
            mod, name, lambda *a, _n=name, _f=inner, **k: (
                seen.append((_n, tuple(a[0].shape))), _f(*a, **k))[1])
    init, step = trx.make_receiver(MODE1, (), device="cpu", pll_loop_div=8)
    step(init(), torch.as_tensor(_stations(1, rds=False)[0, 0]))
    assert seen == [("ingest_fir_demod", (MODE1.block_size,)),
                    ("fir_resample", (2, MODE1.if_len))]


def test_mode1_rds_rrc_matches_jax_from_midstream_state(rds_blocks):
    kw = dict(enable_frame=False)
    t_init, t_step = trx.make_receiver(MODE1_RDS, (2,), device="cpu", **kw)
    j_init, j_step = jrx.make_receiver(JMODE1_RDS, (2,), **kw)
    j_state, _ = j_step(j_init(), jnp.asarray(rds_blocks[0]))
    t_state = state_from_numpy(jax.tree.map(np.asarray, j_state),
                               device="cpu")
    assert tuple(t_state.rds.resamp_zi.shape) == (2, 2, 9002)
    for b in (1, 2):
        t_state, t_out = t_step(t_state, torch.as_tensor(rds_blocks[b]))
        j_state, j_out = j_step(j_state, jnp.asarray(rds_blocks[b]))
        _assert_audio_close(t_out, j_out)
        for t, j in zip(t_out.rds, j_out.rds):
            j = np.asarray(j)
            assert tuple(t.shape) == j.shape == (2, MODE1_RDS.rds_len)
            np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                       atol=1e-4 * float(np.abs(j).max()))
        _assert_states_close(t_state, j_state)


def test_mode1_rds_frame_matches_jax_from_midstream_state(rds_blocks):
    """Symbols, syndromes and sync decisions of MODE1_RDS, the CLI's
    settings (``resync``)."""
    kw = dict(resync=True)
    t_init, t_step = trx.make_receiver(MODE1_RDS, (2,), device="cpu", **kw)
    j_init, j_step = jrx.make_receiver(JMODE1_RDS, (2,), **kw)
    j_state, _ = j_step(j_init(), jnp.asarray(rds_blocks[0]))
    j_state = j_state._replace(frame=j_init().frame)
    t_state = state_from_numpy(jax.tree.map(np.asarray, j_state),
                               device="cpu")
    syncs = 0
    for b in (1, 2):
        t_state, t_out = t_step(t_state, torch.as_tensor(rds_blocks[b]))
        j_state, j_out = j_step(j_state, jnp.asarray(rds_blocks[b]))
        _assert_frame_outputs_equal(t_out.rds, j_out.rds, f"block {b}")
        _assert_states_close(t_state, j_state)
        syncs += int(t_out.rds.is_sync.sum())
    assert syncs >= 4


def _cli(args, stdin_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    with open(stdin_path, "rb") as f:
        return subprocess.run(
            [sys.executable, "-m", "rtsdr_tpu_torch.cli", *args], stdin=f,
            capture_output=True, cwd=ROOT, env=env, timeout=600)


def test_cli_mode1_audio_within_one_lsb_of_jax_stream_runner(tmp_path):
    path = tmp_path / "m1.iq"
    # a partial trailing block, which the reader must drop
    signals.fm_multiplex_iq(2 * MODE1.iq_len + 300, MODE1.rf.fs).tofile(path)
    res = _cli(["1", "--device", "cpu"], path)
    assert res.returncode == 0, res.stderr.decode()
    assert res.stderr.decode().splitlines() == [
        "processed 2 blocks, 0 RDS syncs (0 false positives)"]
    ours = np.frombuffer(res.stdout, np.int16).astype(np.int32)
    assert ours.size == 2 * MODE1.audio_len * 2
    chunks = []
    with open(path, "rb") as f:
        JStreamRunner(JMODE1, enable_rds=False, jit=False).run(
            f.fileno(), emit=chunks.append)
    theirs = np.frombuffer(b"".join(chunks), np.int16).astype(np.int32)
    assert ours.shape == theirs.shape
    assert int(np.max(np.abs(ours - theirs))) <= 1
    assert int(np.max(np.abs(theirs))) > 8000


def test_cli_mode1_rds_lines_equal_jax_stream_runner(tmp_path):
    """``rtsdr-tpu-torch 1 --rds --rds-groups``: the sync-event lines and
    counts of the JAX ``StreamRunner(MODE1_RDS)`` on the same capture, and
    the station's PI decoded."""
    n_blocks = 6
    path = tmp_path / "m1rds.iq"
    wave = signals.rds_baseband(signals.encode_rds_blocks(
        signals.ps_station_words(30, PI_CODE, PS_NAME)))
    signals.fm_multiplex_iq(n_blocks * MODE1.iq_len, MODE1.rf.fs,
                            rds_wave=wave).tofile(path)
    res = _cli(["1", "--rds", "--rds-groups", "--device", "cpu"], path)
    assert res.returncode == 0, res.stderr.decode()
    lines = res.stderr.decode().splitlines()
    j_lines = []
    with open(path, "rb") as f:
        j_stats = JStreamRunner(JMODE1_RDS, jit=False, resync=True).run(
            f.fileno(), rds_log=j_lines.append)
    events = [ln for ln in lines if ln.startswith(
        ("Syndrome ", "False positive", "~~~~~"))]
    assert events == j_lines
    assert sum(ln.startswith("Syndrome ") for ln in events) >= 10
    assert (f"processed {n_blocks} blocks, {j_stats['rds_events']} RDS syncs "
            f"({j_stats['rds_false_positives']} false positives)") in lines
    assert any(ln.startswith(f"Group 0A PI=0x{PI_CODE:04X}") for ln in lines)
    (summary,) = [ln for ln in lines if ln.startswith("RDS: PI=")]
    assert summary.startswith(f"RDS: PI=0x{PI_CODE:04X} PTY=Rock PS='")
    # without --rds mode 1 has no RDS path, with or without --rds-groups
    res = _cli(["1", "--rds-groups", "--device", "cpu", "--blocks", "1"],
               path)
    assert res.stderr.decode().splitlines() == [
        "processed 1 blocks, 0 RDS syncs (0 false positives)"]


def test_stream_runner_mode1_rds_decodes_groups(tmp_path):
    path = tmp_path / "m1rds.iq"
    wave = signals.rds_baseband(signals.encode_rds_blocks(
        signals.ps_station_words(30, PI_CODE, PS_NAME)))
    signals.fm_multiplex_iq(6 * MODE1.iq_len, MODE1.rf.fs,
                            rds_wave=wave).tofile(path)
    dec = GroupDecoder()
    chunks = []
    with open(path, "rb") as f:
        stats = StreamRunner(MODE1_RDS, device="cpu", resync=True).run(
            f.fileno(), emit=chunks.append, frame_hook=dec.feed)
    assert stats["blocks"] == 6 and stats["rds_events"] >= 10
    assert len(b"".join(chunks)) == 6 * MODE1.audio_len * 4
    assert dec.pi == PI_CODE
    assert all(a in (" ", b) for a, b in zip(dec.ps_name, PS_NAME))
