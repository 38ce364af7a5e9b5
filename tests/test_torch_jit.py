"""The compiled, donated step (``rtsdr_tpu_torch/utils/jit.py``), the
counterpart of ``jax.jit(step, donate_argnums=0)``, on the CPU.

On the CPU the wrapper runs the eager step each call into its static state
and output buffers, so what a CUDA graph changes for a caller runs here:
the state updated in place, a consumed tree raising, a foreign tree copied
in, outputs owned by the caller, replayed launch counts.  Compiled and
eager steps run the same arithmetic, so they must agree bit for bit; the
compiled receiver against the JAX package's un-jitted ``make_receiver`` at
``tests/test_torch_receiver.py``'s tolerances (audio 2e-5, state leaves
1e-5 of their scale, PLL angles 1e-3 mod 4 pi).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsdr_tpu.config import MODE0 as JMODE0
from rtsdr_tpu.pipeline import receiver as jrx
from rtsdr_tpu_torch.config import MODE0
from rtsdr_tpu_torch.io.stream import StreamRunner
from rtsdr_tpu_torch.ops import _cuda
from rtsdr_tpu_torch.ops.fir import DeviceCache
from rtsdr_tpu_torch.parallel.channels import make_channel_sharded_receiver
from rtsdr_tpu_torch.parallel import timeshard
from rtsdr_tpu_torch.parallel.mesh import Mesh, make_mesh
from rtsdr_tpu_torch.parallel.timeshard import make_time_sharded_receiver
from rtsdr_tpu_torch.pipeline.receiver import Receiver, make_receiver
from rtsdr_tpu_torch.pipeline.wideband import make_wideband_receiver
from rtsdr_tpu_torch.utils import jit as jit_mod
from rtsdr_tpu_torch.utils.checkpoint import load_state, save_state
from rtsdr_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
from rtsdr_tpu_torch.utils.jit import CompiledStep, flatten, jit_step
from rtsdr_tpu_torch.utils.signals import (
    encode_rds_blocks,
    fm_multiplex_iq,
    ps_station_words,
    rds_baseband,
    wideband_capture_iq,
)

torch.set_num_threads(1)

_FOUR_PI = 4 * np.pi
CPU = "cpu"


def _stations(n_blocks, n_ch=2, rds=False):
    """(n_blocks, n_ch, block_size) uint8 of n_ch distinct stations."""
    rows = []
    for k in range(n_ch):
        kw = dict(mono_hz=1.1e3 - 400.0 * k, pilot_phase=0.9 * k)
        if rds:
            kw["rds_wave"] = rds_baseband(encode_rds_blocks(
                ps_station_words(8 * n_blocks, 0x3A5C + k, "H100 FM ")))
        rows.append(fm_multiplex_iq(n_blocks * MODE0.iq_len, **kw))
    return np.stack(rows).reshape(n_ch, n_blocks, MODE0.block_size
                                  ).transpose(1, 0, 2).copy()


@pytest.fixture(scope="module")
def rds_blocks():
    return _stations(4, rds=True)


def _snapshot(tree):
    """Clones of a tree's tensors (a compiled step's state is overwritten
    by its next call)."""
    return [t.clone() for t in flatten(tree)[0]]


def _run(init, step, blocks, state=None):
    """Step ``blocks`` from ``state`` (default ``init()``); each block's
    (state snapshot, output snapshot)."""
    state = init() if state is None else state
    got = []
    for raw in blocks:
        state, out = step(state, torch.as_tensor(raw))
        got.append((_snapshot(state), _snapshot(out)))
    return got


def _assert_runs_equal(a, b):
    assert len(a) == len(b)
    for k, ((sa, oa), (sb, ob)) in enumerate(zip(a, b)):
        assert len(sa) == len(sb) and len(oa) == len(ob), k
        for i, (x, y) in enumerate(zip(sa, sb)):
            assert x.dtype == y.dtype and torch.equal(x, y), (k, "state", i)
        for i, (x, y) in enumerate(zip(oa, ob)):
            assert x.dtype == y.dtype and torch.equal(x, y), (k, "out", i)


def _receiver_pair(**kw):
    return [(rx.init, rx.step) for rx in (
        Receiver(MODE0, (2,), device=CPU, jit=j, **kw) for j in (True, False))]


def _timeshard_pair():
    mesh = make_mesh(1, 2, devices=[CPU])
    return [make_time_sharded_receiver(MODE0, mesh, 2, jit=j)
            for j in (True, False)]


def _channels_pair():
    mesh = make_mesh(2, 1, devices=[CPU, CPU])
    return [make_channel_sharded_receiver(MODE0, mesh, 2, jit=j)[:2]
            for j in (True, False)]


def _wideband_pair():
    init, step = make_wideband_receiver(MODE0, 4, device=CPU, pll_loop_div=8)
    return [jit_step(init, step, CPU), (init, step)]


def _wideband_blocks(n):
    return wideband_capture_iq(n * MODE0.iq_len, 4, {1: {}}).reshape(
        n, 4 * MODE0.block_size)


@pytest.mark.parametrize("case", [
    "mode0-full", "audio-only", "timeshard-T2", "wideband", "channel-sharded"])
def test_compiled_equals_eager_bit_for_bit(case, rds_blocks):
    """``jit=True`` against ``jit=False``: outputs and state, block by
    block, bit for bit (MODE0 with RDS and the resync walk at C = 2, the
    audio-only receiver, the stacked time-sharded receiver at T = 2, a
    K = 4 wideband receiver, the channel-sharded receiver on a CPU mesh of
    one device)."""
    blocks = rds_blocks[:3]
    if case == "mode0-full":
        pair = _receiver_pair(resync=True)
    elif case == "audio-only":
        pair = _receiver_pair(enable_rds=False)
    elif case == "timeshard-T2":
        pair = _timeshard_pair()
    elif case == "wideband":
        pair, blocks = _wideband_pair(), _wideband_blocks(2)
    else:
        pair, blocks = _channels_pair(), rds_blocks[:2]
    (c_init, c_step), (e_init, e_step) = pair
    assert isinstance(c_step, CompiledStep)
    assert not isinstance(e_step, CompiledStep)
    _assert_runs_equal(_run(c_init, c_step, blocks),
                       _run(e_init, e_step, blocks))


def _leaves(tree, prefix=""):
    if tree is None:
        return
    if hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{prefix}.{name}" if prefix else name)
    else:
        yield prefix, tree


def _assert_states_close(t_state, j_state):
    t_leaves = dict(_leaves(state_to_numpy(t_state)))
    j_leaves = dict(_leaves(jax.tree.map(np.asarray, j_state)))
    assert t_leaves.keys() == j_leaves.keys()
    for path, j in j_leaves.items():
        t = t_leaves[path]
        assert t.shape == j.shape, path
        if j.dtype.kind in "biu":
            assert np.array_equal(t, j), path
        elif ".pll." in path:
            d = np.abs(t - j)
            if path.endswith(("phase_est", "theta")):
                d = np.minimum(d % _FOUR_PI, _FOUR_PI - d % _FOUR_PI)
            np.testing.assert_allclose(d, 0.0, atol=1e-3, err_msg=path)
        else:
            scale = max(1.0, float(np.max(np.abs(j)))) if j.size else 1.0
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * scale,
                                       err_msg=path)


def test_compiled_receiver_matches_jax():
    """The compiled MODE0 receiver (audio path, C = 2) against the JAX
    package's ``make_receiver`` on the same seeded bytes, three blocks."""
    rx = Receiver(MODE0, (2,), device=CPU, enable_rds=False)
    assert isinstance(rx.step, CompiledStep)
    j_init, j_step = jrx.make_receiver(JMODE0, (2,), enable_rds=False)
    rng = np.random.default_rng(7)
    blocks = _stations(3)
    # seeded noise on the stations' bytes
    blocks = np.clip(blocks.astype(np.int16)
                     + rng.integers(-2, 3, blocks.shape), 0, 255
                     ).astype(np.uint8)
    t_state, j_state = rx.init(), j_init()
    for raw in blocks:
        t_state, t_out = rx.step(t_state, torch.as_tensor(raw))
        j_state, j_out = j_step(j_state, jnp.asarray(raw))
        for name in ("left", "right", "mono"):
            np.testing.assert_allclose(
                getattr(t_out, name).numpy(),
                np.asarray(getattr(j_out, name)), rtol=0, atol=2e-5,
                err_msg=name)
        _assert_states_close(t_state, j_state)


def test_warmup_does_not_advance_the_state(monkeypatch, rds_blocks):
    """The warm-up before a capture steps a scratch clone: with two warm-up
    steps (the GPU's count) the first compiled step still equals the first
    eager step, and the step ran three times in that call."""
    monkeypatch.setitem(jit_mod.WARMUP_STEPS, "cpu", 2)
    init, step = make_receiver(MODE0, (2,), device=CPU, enable_rds=False)
    calls = []

    def counted(state, raw):
        calls.append(1)
        return step(state, raw)

    _, c_step = jit_step(init, counted, CPU)
    got = _run(init, c_step, rds_blocks[:2])
    assert len(calls) == 2 + 1 + 1
    _assert_runs_equal(got, _run(init, step, rds_blocks[:2]))


def test_consumed_tree_raises(rds_blocks):
    """A state passed to a call, or returned before the latest call, was
    donated: passing it again raises, as a deleted JAX array does."""
    rx = Receiver(MODE0, (2,), device=CPU, enable_rds=False)
    raw = torch.as_tensor(rds_blocks[0])
    s0 = rx.init()
    s1, _ = rx.step(s0, raw)
    s2, _ = rx.step(s1, raw)
    with pytest.raises(RuntimeError, match="donated"):
        rx.step(s1, raw)
    # reading it fails too: its tensors were emptied, the live tree's not
    s1_leaves, s2_leaves = flatten(s1)[0], flatten(s2)[0]
    assert all(t.numel() == 0 for t in s1_leaves)
    with pytest.raises(IndexError):
        s1.frontend.prev_i[0]
    assert [t.shape for t in s2_leaves] == [t.shape for t in flatten(s0)[0]]
    # a foreign tree consumes the live one too: its buffers take the copy
    s3, _ = rx.step(rx.init(), raw)
    with pytest.raises(RuntimeError, match="donated"):
        rx.step(s2, raw)
    rx.step(s3, raw)
    # the initial (foreign) tree was copied, never donated: it steps again
    rx.step(s0, raw)


@pytest.mark.parametrize("source", ["init", "checkpoint", "jax"])
def test_foreign_tree_is_copied_in(source, rds_blocks, tmp_path):
    """Mid-stream, a tree the compiled step did not return (``init_fn()``,
    a ``load_state`` result, a JAX state through ``utils/convert.py``)
    is copied into the static state: the outputs from it are the eager
    step's from the same tree."""
    rx = Receiver(MODE0, (2,), device=CPU)
    init, eager = make_receiver(MODE0, (2,), device=CPU)
    state = rx.init()
    for raw in rds_blocks[:2]:
        state, _ = rx.step(state, torch.as_tensor(raw))
    if source == "init":
        foreign = rx.init()
    elif source == "checkpoint":
        e_state = init()
        for raw in rds_blocks[:2]:
            e_state, _ = eager(e_state, torch.as_tensor(raw))
        path = str(tmp_path / "state.npz")
        save_state(path, e_state)
        foreign = load_state(path, rx.init())
    else:
        j_init, j_step = jrx.make_receiver(JMODE0, (2,))
        j_state, _ = j_step(j_init(), jnp.asarray(rds_blocks[0]))
        j_state = j_state._replace(frame=j_init().frame)
        foreign = state_from_numpy(jax.tree.map(np.asarray, j_state),
                                   device=CPU)
    ref = _run(init, eager, rds_blocks[2:], state=foreign)
    _assert_runs_equal(_run(rx.init, rx.step, rds_blocks[2:], state=foreign),
                       ref)


def test_outputs_belong_to_the_caller(rds_blocks):
    """Step b's outputs are unchanged by steps b+1 and b+2; ``borrowed``
    hands out the step's own buffers, which the next call overwrites."""
    rx = Receiver(MODE0, (2,), device=CPU, enable_rds=False)
    state = rx.init()
    state, out = rx.step(state, torch.as_tensor(rds_blocks[0]))
    kept = _snapshot(out)
    for raw in rds_blocks[1:3]:
        state, later = rx.step(state, torch.as_tensor(raw))
    assert all(torch.equal(a, b) for a, b in zip(flatten(out)[0], kept))
    assert not torch.equal(later.left, out.left)
    state, b1 = rx.step.borrowed(state, torch.as_tensor(rds_blocks[0]))
    first = b1.left.clone()
    state, b2 = rx.step.borrowed(state, torch.as_tensor(rds_blocks[1]))
    assert b2.left is b1.left and not torch.equal(b1.left, first)


def test_stream_runner_takes_jit(tmp_path, rds_blocks):
    """``StreamRunner(MODE0, jit=False)`` and ``jit=True`` are both
    accepted, as in JAX, and write the same bytes."""
    path = tmp_path / "station.iq"
    rds_blocks[:3, 0].tofile(path)
    outs = []
    for jit in (False, True):
        chunks = []
        with open(path, "rb") as f:
            stats = StreamRunner(MODE0, device=CPU, enable_rds=False,
                                 jit=jit).run(f.fileno(), emit=chunks.append)
        assert stats["blocks"] == 3
        outs.append(b"".join(chunks))
    assert outs[0] == outs[1] and len(outs[0]) == 3 * MODE0.audio_len * 4


def test_make_room_raises_under_capture(monkeypatch):
    """Emptying a full cache needs a device synchronisation, which no CUDA
    graph capture admits: under a capture ``make_room`` raises instead (the
    warm-up before a capture makes that unreachable in a normal step).  A
    compiled step pins what the caches hold."""
    cache = DeviceCache(limit=1)
    a, b = object(), object()
    cache[1], cache[2] = a, b
    held = DeviceCache.held_values()
    assert any(v is a for v in held) and any(v is b for v in held)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        cache.make_room()
    assert len(cache) == 2
    DeviceCache.instances.remove(cache)


def test_replay_adds_the_recorded_launches():
    """A replay adds the launches its capture recorded to ``LAUNCHES`` (a
    graph does not run the Python that counts); the capture's own and the
    warm-up's are taken back out.  The fake step counts 3 launches of
    ``fake`` in its first call only."""
    def init():
        return (torch.zeros(3),)

    def step(state, raw):
        if not calls:
            _cuda.LAUNCHES["fake"] = _cuda.LAUNCHES.get("fake", 0) + 3
        calls.append(1)
        return (state[0] + raw.float().sum(),), state[0] * 2

    calls = []
    saved = _cuda.launch_counts()
    _cuda.reset_launch_counts()
    try:
        _cuda.LAUNCHES["other"] = 5
        _, c_step = jit_step(init, step, CPU)
        state = init()
        for k in range(4):
            state, out = c_step(state, torch.ones(2, dtype=torch.uint8))
            assert _cuda.launch_counts() == {"other": 5, "fake": 3 * (k + 1)}
        assert c_step.per_step == {"fake": 3}
        assert float(state[0][0]) == 8.0 and float(out[0]) == 12.0
    finally:
        _cuda.reset_launch_counts()
        _cuda.LAUNCHES.update(saved)


def test_jit_on_a_spread_mesh_steps_eagerly(monkeypatch):
    """A mesh row spread over distinct GPUs steps eagerly whatever ``jit``
    says (the docstring: its hand-overs are peer copies, which no one
    device's graph holds); a spread row on one device compiles, as the
    stacked route does."""
    spread = make_mesh(1, 2, devices=[CPU, CPU])
    assert spread.spread
    _, step = make_time_sharded_receiver(MODE0, spread, 1)
    assert isinstance(step, CompiledStep)
    _, step = make_time_sharded_receiver(MODE0, make_mesh(1, 2, devices=[CPU]),
                                         1)
    assert isinstance(step, CompiledStep)
    # rows naming GPUs (no card here: the receiver's parts are stand-ins;
    # only the rule that decides ``jit`` runs)
    seen = []
    monkeypatch.setattr(timeshard, "require_kernel_dtype", lambda *a: None)
    monkeypatch.setattr(timeshard, "make_receiver",
                        lambda *a, **k: (None, None))
    monkeypatch.setattr(timeshard, "time_shard_places", lambda devs: ())
    monkeypatch.setattr(timeshard, "shard_rows",
                        lambda *a: seen.append(a[4]) or (None, None))
    gpus = (torch.device("cuda", 0), torch.device("cuda", 1))
    for row in (gpus, (gpus[0],) * 2):
        make_time_sharded_receiver(MODE0, Mesh((row,), True), 1)
    make_time_sharded_receiver(MODE0, Mesh((row,), True), 1, jit=False)
    assert seen == [False, True, False]
