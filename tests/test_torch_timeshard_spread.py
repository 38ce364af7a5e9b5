"""The spread route of the port's time-sharded receiver (CPU, plain
versions): each time shard steps at its own place, over a mesh of
``n_ch x n_t`` devices, where the stacked route stacks the T chunks on one.

On the CPU a spread mesh repeats the ``cpu`` device.  The stages are the
stacked route's own code run once per shard, so the spread route is EQUAL
to the stacked route, outputs and state, bit for bit, but where the plain
versions' batched products (the RDS resampler's matrix product, the RRC's
convolution, mode 1's audio resampler) see C rows per shard instead of
T x C stacked ones and the CPU's BLAS blocks their sums otherwise: the RDS
symbols within 1e-6 of their peak (seen: 3e-9 at C = 2, T = 4), mode 1's
audio within 1e-6 (seen: 3.6e-7), and every float of the float64 route
within 1e-15.  Against the serial receiver it is held to the limits of
tests/test_torch_timeshard.py (``exact``; audio equal, the frame's floats
within 1e-4 of their peak, MODE1's audio within 2e-6), and its ``stale`` /
``iterate`` handoffs to the JAX package's time-sharded receiver over a
(1, 4) mesh of distinct virtual CPU devices: left-channel SNR over the
floors of tests/test_timeshard.py (38 / 60 dB) and audio within the 2e-5
of tests/test_torch_timeshard_jax.py.  The JAX receivers are jitted: each
build compiles in seconds, where an un-jitted ``shard_map`` step takes
about half a minute per block on the CPU.

That each shard steps with its device current and its own stream, and
that a value crosses from one shard's stream to another only behind an
event, is held here with stand-ins for ``torch.cuda``'s guards, streams
and events; on a GPU, ``chip_smoke.py``'s ``timeshard_spread`` phase runs
the route with one stream per shard on one card.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsdr_tpu.config import MODE0 as JMODE0
from rtsdr_tpu.parallel.mesh import make_mesh as j_make_mesh
from rtsdr_tpu.parallel.timeshard import (
    make_time_sharded_receiver as j_make_ts,
)
from rtsdr_tpu_torch.config import MODE0, MODE1, MODE1_RDS
from rtsdr_tpu_torch.parallel import timeshard
from rtsdr_tpu_torch.parallel.mesh import CHANNEL_AXIS, TIME_AXIS, make_mesh
from rtsdr_tpu_torch.parallel.timeshard import make_time_sharded_receiver
from rtsdr_tpu_torch.pipeline.receiver import make_receiver
from rtsdr_tpu_torch.utils import load_state, save_state, shards
from rtsdr_tpu_torch.utils.convert import state_from_numpy
from rtsdr_tpu_torch.utils.shards import Place, concat_rows
from rtsdr_tpu_torch.utils.signals import (
    encode_rds_blocks,
    fm_multiplex_iq,
    ps_station_words,
    rds_baseband,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
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


def _run(cfg, raw, mesh, n_channels, state=None, **kw):
    init, step = make_time_sharded_receiver(cfg, mesh, n_channels, **kw)
    st, outs = (init() if state is None else state), []
    for blk in raw:
        st, out = step(st, np.stack([blk] * n_channels))
        outs.append(out)
    return st, outs


def _spread_and_stacked(cfg, raw, t_shards, ch_shards, n_channels, **kw):
    """(spread run, stacked run), each (serial-layout state, outputs)."""
    runs = []
    for n_dev in (ch_shards * t_shards, ch_shards):
        mesh = make_mesh(ch_shards, t_shards, devices=["cpu"] * n_dev)
        assert mesh.spread == (n_dev > ch_shards)
        st, outs = _run(cfg, raw, mesh, n_channels, **kw)
        assert len(st) == ch_shards
        runs.append((concat_rows(list(st), CPU), outs))
    return runs


def _leaves(tree, prefix=""):
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    names = getattr(tree, "_fields", range(len(tree)))
    for name, v in zip(names, tree):
        yield from _leaves(v, f"{prefix}.{name}" if prefix else str(name))


SYMBOLS_REL = 1e-6      # spread vs stacked RDS symbols, x peak (CPU BLAS)


def _assert_equal_trees(got, ref, atol=0.0, audio_atol=0.0):
    """Equal, but the RDS symbols within SYMBOLS_REL of their peak, the
    audio outputs within ``audio_atol`` and every float within ``atol``."""
    got, ref = list(_leaves(got)), list(_leaves(ref))
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        tol = atol if a.dtype.is_floating_point else 0.0
        if path.endswith((".left", ".right", ".mono")):
            tol = max(tol, audio_atol)
        if path.endswith(("symbols_i", "symbols_q")):
            tol = max(tol, SYMBOLS_REL * float(b.abs().max()))
        if tol:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=tol, err_msg=path)
        else:
            assert torch.equal(a, b), path


def _assert_frame_close(got, ref):
    for name, a, b in zip(ref._fields, got, ref):
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-4 * float(b.abs().max()),
                                       err_msg=name)
        else:
            assert torch.equal(a, b), name


def _assert_like_serial(outs, ser_outs, audio_atol=0.0):
    """tests/test_torch_timeshard.py's limits against the serial receiver."""
    for out, ref in zip(outs, ser_outs):
        for name in ("left", "right", "mono"):
            a, b = getattr(out, name), getattr(ref, name)
            assert a.shape == b.shape and a.dtype == b.dtype, name
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=audio_atol, err_msg=name)
        if ref.rds is not None:
            _assert_frame_close(out.rds, ref.rds)


def _assert_state_like_serial(got, ref):
    for (path, a), (_, b) in zip(_leaves(got), _leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if (path.startswith(("frontend", "audio"))
                or not a.dtype.is_floating_point):
            assert torch.equal(a, b), path
        else:
            np.testing.assert_allclose(
                a.numpy(), b.numpy(), rtol=0,
                atol=1e-5 * max(1.0, float(b.abs().max())), err_msg=path)


@pytest.fixture(scope="module")
def station():
    return _blocks(MODE0, N_BLOCKS)


@pytest.mark.parametrize("t_shards,ch_shards,ingest", [
    (2, 1, "auto"), (4, 1, "auto"), (2, 2, "auto"),
    # the ingest kernel per shard behind its neighbour's raw tail (the
    # CUDA default) on the CPU
    (4, 1, "fused"),
])
def test_spread_equals_serial_and_stacked(station, serial_runs, t_shards,
                                          ch_shards, ingest):
    n_channels = 2 * ch_shards
    ser_st, ser_outs = serial_runs(MODE0, station, n_channels)
    (st, outs), stacked = _spread_and_stacked(
        MODE0, station, t_shards, ch_shards, n_channels, ingest_impl=ingest)
    _assert_like_serial(outs, ser_outs)
    _assert_state_like_serial(st, ser_st)
    _assert_equal_trees((st, outs), stacked)


@pytest.mark.parametrize("cfg", [MODE1, MODE1_RDS],
                         ids=["MODE1", "MODE1_RDS"])
def test_spread_mode1(serial_runs, cfg):
    raw = _blocks(cfg, N_BLOCKS)
    ser_st, ser_outs = serial_runs(cfg, raw, 2)
    (st, outs), stacked = _spread_and_stacked(cfg, raw, 4, 1, 2)
    _assert_like_serial(outs, ser_outs, audio_atol=2e-6)
    _assert_state_like_serial(st, ser_st)
    _assert_equal_trees((st, outs), stacked, audio_atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(stereo_blend=True, error_correct=True, derotate=True),
    dict(deemphasis=75e-6),
    dict(enable_frame=False),
    dict(enable_rds=False),
    dict(resync=True, use_abs_clock=True),
], ids=["blend_ec_derotate", "deemphasis", "no_frame", "no_rds", "resync"])
def test_spread_options_equal_stacked(kw):
    """Every option of the stacked route, on a pilot inside the blend ramp
    (so the psum-reduced pilot power really scales the stereo signal)."""
    raw = _rds_station(MODE0, N_BLOCKS, pilot_amp=0.04)
    (st, outs), stacked = _spread_and_stacked(MODE0, raw, 4, 1, 1, **kw)
    _assert_equal_trees((st, outs), stacked)
    assert not torch.equal(outs[-1].left, outs[-1].right)


def test_spread_float64_split_route():
    """float64 is the CPU oracle route: the plain resampler's products run
    per chunk here and over the stacked chunks there, so the two routes
    part by BLAS blocking alone."""
    raw = _blocks(MODE0, 1)
    (st, outs), stacked = _spread_and_stacked(MODE0, raw, 2, 1, 1,
                                              dtype=torch.float64)
    assert outs[0].left.dtype == torch.float64
    _assert_equal_trees((st, outs), stacked, atol=1e-15)


def _snr_db(got, ref):
    err = np.sqrt(np.mean((got - ref) ** 2))
    return 20 * np.log10(np.sqrt(np.mean(ref ** 2)) / max(err, 1e-30))


@pytest.mark.parametrize("handoff,floor_db", [("stale", 38.0),
                                              ("iterate", 60.0)])
def test_spread_handoff_matches_jax_time_sharded(handoff, floor_db):
    """The JAX time-sharded receiver on (1, 4) distinct virtual CPU devices
    and the port's spread route on four CPU places run the same blocks
    from the JAX receiver's state after block 0 (the bit layer restarted
    on the locked signal)."""
    n_blocks = 3
    raw = _rds_station(MODE0, n_blocks)
    blocks = np.stack([raw, raw], axis=1)                  # (blocks, 2, B)
    j_mesh = j_make_mesh(1, 4)
    assert len(set(j_mesh.devices.flat)) == 4
    init, step = j_make_ts(JMODE0, j_mesh, 2, jnp.float32,
                           pll_handoff=handoff)
    j_state, _ = step(init(), jnp.asarray(blocks[0]))
    j_state = j_state._replace(frame=init().frame)
    state0 = jax.tree.map(np.asarray, j_state)
    j_outs = []
    for b in range(1, n_blocks):
        j_state, out = step(j_state, jnp.asarray(blocks[b]))
        j_outs.append(jax.tree.map(np.asarray, out))
    t_init, t_step = make_time_sharded_receiver(
        MODE0, make_mesh(1, 4, devices=["cpu"] * 4), 2, pll_handoff=handoff)
    st = (state_from_numpy(state0, device="cpu"),)
    for b, j in zip(range(1, n_blocks), j_outs):
        st, out = t_step(st, blocks[b])
        for name in ("left", "right", "mono"):
            np.testing.assert_allclose(getattr(out, name).numpy(),
                                       getattr(j, name), rtol=0, atol=2e-5,
                                       err_msg=f"block {b} {name}")
        snr = _snr_db(out.left.numpy(), j.left)
        assert snr > floor_db, f"block {b}: {handoff} SNR {snr:.1f} dB"
        for name, a, r in zip(out.rds._fields, out.rds, j.rds):
            if r.dtype.kind in "biu":
                assert np.array_equal(a.numpy(), r), (b, name)


def test_make_mesh_grid_rule(monkeypatch):
    """Exactly n_ch devices: stacked, each row repeating its device; at
    least n_ch x n_t: the grid in row-major order, as JAX's reshape; other
    counts raise."""
    devs = [torch.device("cpu")] * 8
    stacked = make_mesh(2, 4, devices=devs[:2])
    assert not stacked.spread
    assert stacked.time_devices == ((CPU,) * 4,) * 2
    grid = make_mesh(2, 4, devices=devs)
    assert grid.spread and grid.shape == {CHANNEL_AXIS: 2, TIME_AXIS: 4}
    assert grid.time_devices == ((CPU,) * 4,) * 2
    assert grid.devices == (CPU, CPU)
    # row-major over distinct device names (no receiver is built)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    named = make_mesh(2, 3, devices=[f"cuda:{k}" for k in range(7)])
    assert [[d.index for d in row] for row in named.time_devices] == [
        [0, 1, 2], [3, 4, 5]]
    assert [d.index for d in named.devices] == [0, 3] and named.spread
    with pytest.raises(ValueError, match="not both"):
        make_mesh(1, 2, devices=["cuda:0", "cpu"])
    monkeypatch.undo()
    for n_dev in (3, 5, 7):
        with pytest.raises(ValueError, match="give 2 .* or at least 8"):
            make_mesh(2, 4, devices=devs[:n_dev])
    # the default channel count is len // n_t where that is at least 1
    assert make_mesh(n_time_shards=2, devices=devs[:4]).time_devices == (
        (CPU, CPU),) * 2
    assert not make_mesh(n_time_shards=4, devices=devs[:1]).spread
    # n_t = 1: the first n_ch devices, no time shards to spread
    one = make_mesh(2, 1, devices=devs[:5])
    assert one.devices == (CPU, CPU) and not one.spread


def test_make_mesh_existing_call_shapes_keep_their_meaning():
    """Every call in the repo before the spread route: stacked meshes."""
    for n_ch, n_t in ((3, 4), (2, 4), (2, 2), (1, 4), (1, 7), (2, 1),
                      (1, 1)):
        mesh = make_mesh(n_ch, n_t, devices=["cpu"] * n_ch)
        assert not mesh.spread and mesh.devices == (CPU,) * n_ch
        assert mesh.time_devices == ((CPU,) * n_t,) * n_ch
    assert make_mesh(devices=["cpu", "cpu"]).shape == {CHANNEL_AXIS: 2,
                                                       TIME_AXIS: 1}


@pytest.mark.parametrize("n_gpus", [1, 2, 4, 8])
def test_make_mesh_routes_whatever_the_gpu_count(monkeypatch, n_gpus):
    """One named device stacks on any host; the default (every visible
    GPU) takes the grid where there are enough GPUs, else stacks on the
    first.  No receiver is built: only the device names are read."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_gpus)
    gpu = [torch.device("cuda", k) for k in range(n_gpus)]
    named = make_mesh(1, 4, devices=["cuda:0"])
    assert not named.spread and named.time_devices == ((gpu[0],) * 4,)
    every = make_mesh(1, 4)
    if n_gpus >= 4:
        assert every.spread and every.time_devices == (tuple(gpu[:4]),)
    else:
        assert not every.spread and every.time_devices == ((gpu[0],) * 4,)
    # the default channel count, JAX's len // n_t where that is at least 1
    rows = make_mesh(n_time_shards=4)
    assert rows.shape == {CHANNEL_AXIS: max(1, n_gpus // 4), TIME_AXIS: 4}
    assert rows.devices == tuple(gpu[:4 * max(1, n_gpus // 4):4])
    # channel shards alone: one GPU each, as before the spread route
    assert make_mesh(min(n_gpus, 2), 1).devices == tuple(gpu[:2])


@pytest.mark.parametrize("first,then", [("stacked", "spread"),
                                        ("spread", "stacked")])
def test_checkpoint_resumes_across_routes(tmp_path, first, then):
    """A state saved by one route resumes in the other, bit for bit the
    continuous run (utils/checkpoint.py; serial layout on each row's first
    device)."""
    raw = _blocks(MODE0, 3)
    meshes = {"stacked": make_mesh(2, 2, devices=["cpu"] * 2),
              "spread": make_mesh(2, 2, devices=["cpu"] * 4)}
    st_a, outs_a = _run(MODE0, raw, meshes[first], 2)
    st_1, _ = _run(MODE0, raw[:1], meshes[first], 2)
    path = str(tmp_path / "ts.npz")
    save_state(path, st_1)
    init, _ = make_time_sharded_receiver(MODE0, meshes[then], 2)
    resumed = load_state(path, init())
    st_b, outs_b = _run(MODE0, raw[1:], meshes[then], 2, state=resumed)
    _assert_equal_trees((concat_rows(list(st_b), CPU), outs_b[-1]),
                        (concat_rows(list(st_a), CPU), outs_a[-1]))


def test_each_time_shard_steps_at_its_own_place(monkeypatch):
    """Every kernel wrapper of a spread step runs inside one shard's
    ``on_place``, shard after shard for each stage, with that shard's
    inputs; no stage runs outside a shard's place."""
    current, calls = [None], []

    @contextlib.contextmanager
    def on_place(place):
        prev, current[0] = current[0], place
        try:
            yield
        finally:
            current[0] = prev

    monkeypatch.setattr(timeshard, "on_place", on_place)
    for name in ("ingest_fir_decimate", "fir_decimate", "fir_block_bank",
                 "fir_block_pre", "fir_bank_carried", "fir_block", "pll",
                 "resample_mul2", "resample_mul2_tail", "fm_discriminator"):
        def wrapped(*a, _f=getattr(timeshard, name), _n=name, **k):
            calls.append((_n, current[0]))
            return _f(*a, **k)
        monkeypatch.setattr(timeshard, name, wrapped)
    places = tuple(Place(CPU) for _ in range(4))      # told apart by id
    monkeypatch.setattr(timeshard, "time_shard_places", lambda devs: places)
    raw = _blocks(MODE0, 1)
    for ingest in ("split", "fused"):
        calls.clear()
        _run(MODE0, raw, make_mesh(1, 4, devices=["cpu"] * 4), 1,
             ingest_impl=ingest)
        assert calls and all(p is not None for _, p in calls), calls
        by_stage = {}
        for name, place in calls:
            by_stage.setdefault(name, []).append(place)
        for name, seen in by_stage.items():
            assert len(seen) % 4 == 0, name
            assert all(p is places[k % 4] for k, p in enumerate(seen)), name
        # the exact handoff: T PLL launches, one at each shard
        assert len(by_stage["pll"]) == 4


class _Stream:
    """A stand-in for a CUDA stream: records what is queued on it."""

    def __init__(self, name, log):
        self.name, self.log = name, log

    def wait_event(self, event):
        self.log.append(("wait", self.name, event))


def test_move_orders_reader_after_maker(monkeypatch):
    """``move``: the reader's stream waits on an event recorded on the
    maker's; on one device the value is held for the reader's stream, on
    another it is copied with the maker's stream current inside the
    reader's."""
    log, current = [], []
    monkeypatch.setattr(shards, "record",
                        lambda place: ("event", place.stream.name))

    @contextlib.contextmanager
    def on_place(place):
        current.append(place.stream.name)
        try:
            yield
        finally:
            current.pop()

    monkeypatch.setattr(shards, "on_place", on_place)

    class Value:
        def record_stream(self, stream):
            log.append(("hold", stream.name))

        def to(self, device, non_blocking=False):
            log.append(("copy", str(device), tuple(current), non_blocking))
            return "copied"

    a = Place(torch.device("cuda", 0), _Stream("a", log))
    b = Place(torch.device("cuda", 0), _Stream("b", log))
    c = Place(torch.device("cuda", 1), _Stream("c", log))
    x = Value()
    assert shards.move(x, a, b) is x
    assert log == [("wait", "b", ("event", "a")), ("hold", "b")]
    log.clear()
    assert shards.move(x, a, c) == "copied"
    assert log == [("wait", "c", ("event", "a")),
                   ("copy", "cuda:1", ("c", "a"), True)]
    cpu = torch.zeros(3)
    assert shards.move(cpu, Place(CPU), Place(CPU)) is cpu


def test_time_shard_places_and_on_place_make_device_and_stream_current(
        monkeypatch):
    """One new stream per cell (a repeated device gets one per shard), and
    ``on_place`` enters that device's guard and that stream's."""
    entered = []
    made = iter(range(100))

    class Guard:
        def __init__(self, x):
            self.x = x

        def __enter__(self):
            entered.append(self.x)

        def __exit__(self, *exc):
            entered.append(("exit", self.x))

    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda device: ("stream", str(device), next(made)))
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "stream", Guard)
    devs = [torch.device("cuda", 0)] * 2 + [torch.device("cuda", 1)]
    places = shards.time_shard_places(devs)
    assert [p.stream for p in places] == [("stream", "cuda:0", 0),
                                          ("stream", "cuda:0", 1),
                                          ("stream", "cuda:1", 2)]
    with shards.on_place(places[1]):
        assert entered == [devs[1], places[1].stream]
    assert entered[2:] == [("exit", places[1].stream), ("exit", devs[1])]
    assert shards.time_shard_places(["cpu", "cpu"]) == (Place(CPU),) * 2
    entered.clear()
    with shards.on_place(Place(CPU)):
        pass
    assert entered == []
