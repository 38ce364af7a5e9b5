"""The port's time-sharded receiver (CPU, float32, plain versions) against
the port's own serial receiver on the same blocks.

With the ``exact`` handoff every stage of a chunk sees exactly the inputs
the serial receiver's stage sees there (halo = the left neighbour's tail,
the PLL state handed chunk to chunk), and the plain versions sum each
output in the same order whatever the chunk: audio, the frame layer's
integer outputs and state and the front-end / audio state are EQUAL.  The
RDS resampler's plain version is a matrix product whose blocking follows
the chunk, so the RDS symbols agree to 1e-4 of their peak (the
fused-vs-unfused tolerance of chip_smoke.py) and the RDS and frame float
state to 1e-5 relative.  The
stereo blend reduces the pilot power in another grouping (per-chunk sums,
then summed), and mode 1's audio resampler is a matrix product like the
RDS one: audio within 2e-6 there (tests/test_timeshard.py's tolerance).

``stale`` / ``iterate`` approximate the serial loop: left-channel SNR
against the serial receiver from block 1 on, over the floors of
tests/test_timeshard.py (38 dB, 60 dB), and RDS syncs in the last blocks.
tests/test_torch_timeshard_jax.py holds them against the JAX package's own
time-sharded receiver.
"""

import numpy as np
import pytest
import torch

from rtsdr_tpu_torch.config import MODE0, MODE1, MODE1_RDS
from rtsdr_tpu_torch.parallel.mesh import make_mesh
from rtsdr_tpu_torch.parallel.timeshard import make_time_sharded_receiver
from rtsdr_tpu_torch.pipeline.receiver import make_receiver
from rtsdr_tpu_torch.utils.shards import concat_rows
from rtsdr_tpu_torch.utils.signals import (
    encode_rds_blocks,
    fm_multiplex_iq,
    ps_station_words,
    rds_baseband,
)

torch.set_num_threads(1)

N_BLOCKS = 2


def _blocks(cfg, n_blocks, **station):
    return fm_multiplex_iq(n_blocks * cfg.iq_len, cfg.rf.fs, **station
                           ).reshape(n_blocks, cfg.block_size)


def _rds_station(cfg, n_blocks, **kw):
    wave = rds_baseband(encode_rds_blocks(ps_station_words(
        n_blocks + 4, 0x3A5C, "H100 FM ")))
    return _blocks(cfg, n_blocks, rds_wave=wave, **kw)


@pytest.fixture(scope="module")
def serial_runs():
    """Serial receiver runs by (mode, n_channels, kwargs), made once."""
    cache = {}

    def run(cfg, raw, n_channels, **kw):
        key = (cfg.mode, cfg.rds is not None, raw.shape, n_channels,
               tuple(sorted(kw.items())))
        if key not in cache:
            init, step = make_receiver(cfg, (n_channels,), device="cpu",
                                       **kw)
            st, outs = init(), []
            for blk in raw:
                st, out = step(st, torch.as_tensor(
                    np.stack([blk] * n_channels)))
                outs.append(out)
            cache[key] = (st, outs)
        return cache[key]
    return run


def _run_sharded(cfg, raw, t_shards, ch_shards, n_channels, **kw):
    mesh = make_mesh(ch_shards, t_shards, devices=["cpu"] * ch_shards)
    init, step = make_time_sharded_receiver(cfg, mesh, n_channels, **kw)
    st, outs = init(), []
    assert len(st) == ch_shards
    for blk in raw:
        st, out = step(st, np.stack([blk] * n_channels))
        outs.append(out)
    return concat_rows(list(st), torch.device("cpu")), outs


def _leaves(tree, prefix=""):
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    for name, v in zip(tree._fields, tree):
        yield from _leaves(v, f"{prefix}.{name}" if prefix else name)


def _assert_frame_equal(got, ref):
    for name, a, b in zip(ref._fields, got, ref):
        if a.dtype.is_floating_point:
            peak = float(b.abs().max())
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-4 * peak, err_msg=name)
        else:
            assert torch.equal(a, b), name


def _assert_same(out, ref, audio_atol=0.0):
    for name in ("left", "right", "mono"):
        a, b = getattr(out, name), getattr(ref, name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if audio_atol:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=audio_atol, err_msg=name)
        else:
            assert torch.equal(a, b), name
    if ref.rds is not None:
        _assert_frame_equal(out.rds, ref.rds)


def _assert_states(got, ref):
    for (path, a), (_, b) in zip(_leaves(got), _leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if (path.startswith(("frontend", "audio"))
                or not a.dtype.is_floating_point):
            assert torch.equal(a, b), path
        else:
            scale = max(1.0, float(b.abs().max()))
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-5 * scale, err_msg=path)
    assert [p for p, _ in _leaves(got)] == [p for p, _ in _leaves(ref)]


@pytest.fixture(scope="module")
def station():
    return _blocks(MODE0, N_BLOCKS)


@pytest.mark.parametrize("t_shards,ch_shards,deemph,ingest", [
    (2, 1, None, "auto"), (4, 2, None, "auto"), (8, 1, None, "auto"),
    (1, 2, None, "auto"),
    # de-emphasis runs once over the gathered 48 kS/s block
    (4, 2, 75e-6, "auto"), (8, 1, 50e-6, "auto"),
    # the ingest kernel's halo form (the CUDA default) on the CPU
    (4, 1, None, "fused"),
])
def test_time_sharded_equals_serial(station, serial_runs, t_shards,
                                    ch_shards, deemph, ingest):
    n_channels = 2 * ch_shards
    ser_st, ser_outs = serial_runs(MODE0, station, n_channels,
                                   deemphasis=deemph)
    st, outs = _run_sharded(MODE0, station, t_shards, ch_shards, n_channels,
                            deemphasis=deemph, ingest_impl=ingest)
    for out, ref in zip(outs, ser_outs):
        _assert_same(out, ref)
    _assert_states(st, ser_st)


@pytest.mark.parametrize("cfg", [MODE1, MODE1_RDS], ids=["MODE1",
                                                         "MODE1_RDS"])
def test_time_sharded_mode1(serial_runs, cfg):
    raw = _blocks(cfg, N_BLOCKS)
    ser_st, ser_outs = serial_runs(cfg, raw, 2)
    st, outs = _run_sharded(cfg, raw, 4, 2, 2)
    for out, ref in zip(outs, ser_outs):
        _assert_same(out, ref, audio_atol=2e-6)
    _assert_states(st, ser_st)


def test_time_sharded_blend_and_ec_match_serial(serial_runs):
    """The pilot amplitude sits inside the blend ramp, so the psum-reduced
    pilot power really scales the stereo difference signal."""
    raw = _blocks(MODE0, 3, pilot_amp=0.04)
    kw = dict(stereo_blend=True, error_correct=True)
    _, ser_outs = serial_runs(MODE0, raw, 2, **kw)
    _, outs = _run_sharded(MODE0, raw, 4, 1, 2, **kw)
    for out, ref in zip(outs, ser_outs):
        _assert_same(out, ref, audio_atol=2e-6)
        assert not torch.equal(out.left, out.right)


def _snr_db(got, ref):
    err = np.sqrt(np.mean((got - ref) ** 2))
    return 20 * np.log10(np.sqrt(np.mean(ref ** 2)) / max(err, 1e-30))


@pytest.mark.parametrize("handoff,floor_db", [("stale", 38.0),
                                              ("iterate", 60.0)])
def test_concurrent_handoffs_approach_serial(serial_runs, handoff, floor_db):
    raw = _rds_station(MODE0, 5)
    _, ser_outs = serial_runs(MODE0, raw, 1)
    _, outs = _run_sharded(MODE0, raw, 4, 1, 1, pll_handoff=handoff)
    for b in range(1, len(raw)):                 # block 0: acquisition
        snr = _snr_db(outs[b].left[0].numpy(), ser_outs[b].left[0].numpy())
        assert snr > floor_db, f"block {b}: {handoff} SNR {snr:.1f} dB"
    n_sync = sum(int(o.rds.is_sync[0, :int(o.rds.n_windows[0])].sum())
                 for o in outs[-2:])
    assert n_sync > 0


def test_iterate_with_loop_div_on_a_detuned_pilot(serial_runs):
    """The seeds' integrator slope is 1/loop_div per sample: iterate with
    pll_loop_div=4 on a pilot 60 Hz off stays float32-close to the serial
    receiver built with the same loop_div."""
    raw = _rds_station(MODE0, 4, pilot_hz=19e3 + 60.0)
    _, ser_outs = serial_runs(MODE0, raw, 1, pll_loop_div=4)
    _, outs = _run_sharded(MODE0, raw, 4, 1, 1, pll_handoff="iterate",
                           pll_loop_div=4)
    for b in range(1, len(raw)):
        snr = _snr_db(outs[b].left[0].numpy(), ser_outs[b].left[0].numpy())
        assert snr > 60.0, f"block {b}: SNR {snr:.1f} dB"


def test_rds_without_frame_gives_the_gathered_stream(station, serial_runs):
    ser_st, ser_outs = serial_runs(MODE0, station, 2, enable_frame=False)
    _, outs = _run_sharded(MODE0, station, 4, 1, 2, enable_frame=False)
    for out, ref in zip(outs, ser_outs):
        for a, b in zip(out.rds, ref.rds):
            assert a.shape == b.shape == (2, MODE0.rds_len)
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-4 * float(b.abs().max()))


@pytest.mark.parametrize("kw,match", [
    (dict(pll_handoff="pipeline"), "pll_handoff"),
    (dict(resamp_impl="xla"), "resamp_impl"),
    (dict(ingest_impl="s8"), "ingest_impl"),
    (dict(pll_loop_div=7), "pll_loop_div"),
])
def test_bad_arguments_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        make_time_sharded_receiver(MODE0, make_mesh(1, 4, devices=["cpu"]),
                                   2, **kw)


def test_shapes_that_do_not_split_raise():
    with pytest.raises(ValueError, match="not divisible"):
        make_time_sharded_receiver(
            MODE0, make_mesh(2, 2, devices=["cpu", "cpu"]), 3)
    with pytest.raises(ValueError, match="resampler grid|decimation"):
        make_time_sharded_receiver(MODE0, make_mesh(1, 7, devices=["cpu"]),
                                   1)
    with pytest.raises(ValueError, match="fused ingest"):
        make_time_sharded_receiver(MODE0, make_mesh(1, 2, devices=["cpu"]),
                                   1, torch.float64, ingest_impl="fused")


def test_float64_split_route_runs(station):
    """float64 is the CPU oracle route (split ingest only)."""
    _, outs = _run_sharded(MODE0, station[:1], 2, 1, 1, dtype=torch.float64)
    assert outs[0].left.dtype == torch.float64
    assert torch.isfinite(outs[0].left).all()
