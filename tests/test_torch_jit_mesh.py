"""Every sharded receiver compiled (``utils/jit.py``), as the JAX package
jits them (``rtsdr_tpu/parallel/timeshard.py``, ``channels.py``), on the
CPU.

* The spread route of the time-sharded receiver on a mesh of one device
  (``devices=["cpu"] * T``) is one ``CompiledStep``: bit for bit the eager
  spread route over three blocks (the CPU wrapper runs the same step into
  its static buffers; on a GPU the graph holds the T forked branches,
  ``chip_smoke.py``'s ``jit`` phase), with the same launches per step, and
  within ``tests/test_torch_timeshard_spread.py``'s tolerances of the JAX
  package's jitted time-sharded receiver (audio 2e-5, integer RDS outputs
  equal).
* A mesh over two or more devices is a ``ComposedStep`` of one
  ``CompiledStep`` per device.  Here its parts are built explicitly, two
  on ``"cpu"`` (the code a two-GPU mesh runs, but for the peer copies):
  bit for bit the eager sharded step and the serial receiver, and its
  state, the tuple of shard states, donated across its parts.
"""

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
from rtsdr_tpu_torch.config import MODE0, MODE1_RDS
from rtsdr_tpu_torch.ops import _cuda
from rtsdr_tpu_torch.parallel import channels, timeshard
from rtsdr_tpu_torch.parallel.channels import (
    compose_wideband,
    make_channel_sharded_receiver,
    make_wideband_sharded_receiver,
    shard_rows,
)
from rtsdr_tpu_torch.parallel.mesh import make_mesh, row_split
from rtsdr_tpu_torch.parallel.timeshard import make_time_sharded_receiver
from rtsdr_tpu_torch.pipeline.receiver import make_receiver
from rtsdr_tpu_torch.pipeline.wideband import make_wideband_receiver
from rtsdr_tpu_torch.utils.convert import state_from_numpy
from rtsdr_tpu_torch.utils.jit import CompiledStep, ComposedStep, flatten
from rtsdr_tpu_torch.utils.shards import concat_rows
from rtsdr_tpu_torch.utils.signals import (
    encode_rds_blocks,
    fm_multiplex_iq,
    ps_station_words,
    rds_baseband,
    wideband_capture_iq,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
N_BLOCKS = 3


def _stations(cfg, n_blocks, n_ch):
    """(n_blocks, n_ch, block_size) uint8: n_ch distinct RDS stations."""
    rows = []
    for k in range(n_ch):
        wave = rds_baseband(encode_rds_blocks(ps_station_words(
            n_blocks + 4, 0x3A5C + k, "H100 FM ")))
        rows.append(fm_multiplex_iq(
            n_blocks * cfg.iq_len, cfg.rf.fs, mono_hz=1.1e3 - 400.0 * k,
            pilot_phase=0.9 * k, rds_wave=wave))
    return np.stack(rows).reshape(n_ch, n_blocks, cfg.block_size
                                  ).transpose(1, 0, 2).copy()


def _run(init, step, blocks, state=None):
    """Each block's (state, outputs) snapshot, stepping from ``state``
    (default ``init()``)."""
    state = init() if state is None else state
    got = []
    for raw in blocks:
        state, out = step(state, raw)
        got.append([t.clone() for t in flatten((state, out))[0]])
    return got


def _assert_runs_equal(a, b):
    assert len(a) == len(b)
    for k, (xs, ys) in enumerate(zip(a, b)):
        assert len(xs) == len(ys), k
        for i, (x, y) in enumerate(zip(xs, ys)):
            assert x.dtype == y.dtype and torch.equal(x, y), (k, i)


# the spread route's stage calls, counted as launches (the CPU runs the
# kernels' plain versions, which count none)
_STAGES = ("ingest_fir_decimate", "fir_decimate", "fir_block_bank",
           "fir_block_pre", "fir_bank_carried", "fir_block", "pll",
           "resample_mul2", "fm_discriminator")


@pytest.fixture
def counted(monkeypatch):
    for name in _STAGES:
        def stage(*a, _f=getattr(timeshard, name), _n=name, **k):
            _cuda.LAUNCHES[_n] = _cuda.LAUNCHES.get(_n, 0) + 1
            return _f(*a, **k)
        monkeypatch.setattr(timeshard, name, stage)
    saved = _cuda.launch_counts()
    yield
    _cuda.reset_launch_counts()
    _cuda.LAUNCHES.update(saved)


SPREAD_CASES = {
    "exact-resync": (MODE0, 1, 4, 1, dict(resync=True)),
    "stale": (MODE0, 2, 4, 1, dict(pll_handoff="stale")),
    "iterate": (MODE0, 2, 2, 1, dict(pll_handoff="iterate")),
    "MODE1_RDS-resync": (MODE1_RDS, 1, 4, 1, dict(resync=True)),
    # two rows of the (ch, t) grid, the ingest kernel's per-shard form
    "2x2-fused": (MODE0, 2, 2, 2, dict(ingest_impl="fused")),
}


@pytest.mark.parametrize("case", list(SPREAD_CASES))
def test_spread_compiled_equals_eager(case, counted):
    """The spread route compiled (one ``CompiledStep``) against
    ``jit=False``: state and outputs bit for bit over three blocks, and
    the same stage launches per step."""
    cfg, n_ch, t_shards, ch_shards, kw = SPREAD_CASES[case]
    mesh = make_mesh(ch_shards, t_shards,
                     devices=["cpu"] * (ch_shards * t_shards))
    assert mesh.spread
    blocks = _stations(cfg, N_BLOCKS, n_ch)
    runs, counts = [], []
    for jit in (True, False):
        init, step = make_time_sharded_receiver(cfg, mesh, n_ch, jit=jit,
                                                **kw)
        assert isinstance(step, CompiledStep) == jit
        _cuda.reset_launch_counts()
        runs.append(_run(init, step, blocks))
        counts.append(_cuda.launch_counts())
        if jit:
            c_step = step
    _assert_runs_equal(*runs)
    assert counts[0] == counts[1] and counts[0]["pll"] > 0
    assert c_step.per_step == {k: v // N_BLOCKS for k, v in counts[1].items()}


def test_spread_compiled_consumes_its_state():
    """A state passed to the compiled spread step, or returned before its
    latest call, was donated: passing it again raises and its tensors read
    empty; a foreign tree (``init_fn()``) is copied in."""
    init, step = make_time_sharded_receiver(
        MODE0, make_mesh(1, 2, devices=["cpu"] * 2), 1, enable_rds=False)
    raw = _stations(MODE0, 1, 1)[0]
    s1, _ = step(init(), raw)
    s2, _ = step(s1, raw)
    with pytest.raises(RuntimeError, match="donated"):
        step(s1, raw)
    assert all(t.numel() == 0 for t in flatten(s1)[0])
    assert all(t.numel() for t in flatten(s2)[0])
    step(init(), raw)
    with pytest.raises(RuntimeError, match="donated"):
        step(s2, raw)


def test_spread_compiled_matches_jax_time_sharded():
    """The compiled spread route on four CPU places against the JAX
    package's jitted time-sharded receiver on (1, 4) distinct virtual CPU
    devices, ``'exact'``, from the JAX receiver's state after block 0 (the
    bit layer restarted): audio within 2e-5, integer RDS outputs equal."""
    blocks = _stations(MODE0, N_BLOCKS, 1)
    blocks = np.concatenate([blocks, blocks], axis=1)       # (blocks, 2, B)
    j_mesh = j_make_mesh(1, 4)
    assert len(set(j_mesh.devices.flat)) == 4
    j_init, j_step = j_make_ts(JMODE0, j_mesh, 2, jnp.float32)
    j_state, _ = j_step(j_init(), jnp.asarray(blocks[0]))
    j_state = j_state._replace(frame=j_init().frame)
    state0 = jax.tree.map(np.asarray, j_state)
    t_init, t_step = make_time_sharded_receiver(
        MODE0, make_mesh(1, 4, devices=["cpu"] * 4), 2)
    assert isinstance(t_step, CompiledStep)
    st = (state_from_numpy(state0, device="cpu"),)
    for b in range(1, N_BLOCKS):
        j_state, j = j_step(j_state, jnp.asarray(blocks[b]))
        st, out = t_step(st, blocks[b])
        for name in ("left", "right", "mono"):
            np.testing.assert_allclose(getattr(out, name).numpy(),
                                       np.asarray(getattr(j, name)), rtol=0,
                                       atol=2e-5, err_msg=f"block {b} {name}")
        for name, a, r in zip(out.rds._fields, out.rds, j.rds):
            r = np.asarray(r)
            if r.dtype.kind in "biu":
                assert np.array_equal(a.numpy(), r), (b, name)


def _two_parts(groups, n_ch=2, **kw):
    """The channel-sharded receiver over two shards of ``n_ch // 2`` rows
    as a composition with ``groups``, every shard step counted."""
    rows = row_split(n_ch, 2)
    shards = [make_receiver(MODE0, (n_ch // 2,), device=CPU, **kw)
              for _ in rows]

    def counted_step(step):
        def f(st, x):
            _cuda.LAUNCHES["shard"] = _cuda.LAUNCHES.get("shard", 0) + 1
            return step(st, x)
        return f

    return shard_rows([s[0] for s in shards],
                      [counted_step(s[1]) for s in shards], rows, [CPU, CPU],
                      True, "two parts", groups=groups)


@pytest.mark.parametrize("order,kw", [
    ((0, 1), {}),
    # the parts in the other order: the state and the gather still follow
    # the shards' order
    ((1, 0), dict(enable_rds=False)),
], ids=["in-order", "reversed-audio"])
def test_composition_equals_eager_and_serial(order, kw):
    """Two parts on ``"cpu"``, one shard each: bit for bit the eager
    channel-sharded step and the serial receiver over the same rows; one
    count per shard per step, replayed."""
    blocks = _stations(MODE0, N_BLOCKS, 2)
    c_init, c_step = _two_parts([(CPU, [k]) for k in order], **kw)
    assert isinstance(c_step, ComposedStep) and len(c_step.parts) == 2
    e_init, e_step, _ = make_channel_sharded_receiver(
        MODE0, make_mesh(2, 1, devices=[CPU, CPU]), 2, jit=False, **kw)
    saved = _cuda.launch_counts()
    _cuda.reset_launch_counts()
    try:
        got = _run(c_init, c_step, blocks)
        assert _cuda.launch_counts() == {"shard": 2 * N_BLOCKS}
        assert c_step.per_step == {"shard": 2}
    finally:
        _cuda.reset_launch_counts()
        _cuda.LAUNCHES.update(saved)
    _assert_runs_equal(got, _run(e_init, e_step, blocks))
    s_init, s_step = make_receiver(MODE0, (2,), device=CPU, **kw)
    st, s_st = c_init(), s_init()
    for raw in blocks:
        st, out = c_step(st, raw)
        s_st, ref = s_step(s_st, torch.as_tensor(raw))
        _assert_runs_equal([flatten(out)[0]], [flatten(ref)[0]])
    _assert_runs_equal([flatten(concat_rows(list(st), CPU))[0]],
                       [flatten(s_st)[0]])


def test_composition_donation_holds_across_its_parts():
    """The composition's state is the tuple of shard states: a consumed
    tuple raises before any part steps, every part's tensors read empty,
    the outputs are the caller's, and a foreign tuple is copied in."""
    blocks = _stations(MODE0, 2, 2)
    init, step = _two_parts([(CPU, [0]), (CPU, [1])], enable_rds=False)
    s1, o1 = step(init(), blocks[0])
    kept = [t.clone() for t in flatten(o1)[0]]
    s2, _ = step(s1, blocks[1])
    assert all(torch.equal(a, b) for a, b in zip(flatten(o1)[0], kept))
    ran = []
    for part in step.parts:
        part.step_fn = (lambda f: lambda *a: ran.append(1) or f(*a))(
            part.step_fn)
    with pytest.raises(RuntimeError, match="donated"):
        step(s1, blocks[0])
    assert not ran
    assert all(t.numel() == 0 for t in flatten(s1)[0])
    assert all(t.numel() for t in flatten(s2)[0])
    # a mixed tuple (shard 0 consumed, shard 1 live) raises too
    with pytest.raises(RuntimeError, match="donated"):
        step((s1[0], s2[1]), blocks[0])
    s3, _ = step(init(), blocks[0])
    with pytest.raises(RuntimeError, match="donated"):
        step(s2, blocks[0])
    step(s3, blocks[1])


def test_receivers_compose_on_meshes_over_two_devices(monkeypatch):
    """With two device groups (the rule ``device_groups`` applies to a
    mesh over two GPUs, here given two on ``"cpu"``), the channel-sharded
    receiver and the time-sharded receiver, stacked and spread, return a
    ``ComposedStep`` equal to their eager step bit for bit."""
    monkeypatch.setattr(channels, "device_groups",
                        lambda devs: [(CPU, [0]), (CPU, [1])])
    blocks = _stations(MODE0, 2, 2)
    makers = {
        "channel-sharded": lambda j: make_channel_sharded_receiver(
            MODE0, make_mesh(2, 1, devices=[CPU] * 2), 2, jit=j,
            enable_rds=False)[:2],
        "time-sharded stacked": lambda j: make_time_sharded_receiver(
            MODE0, make_mesh(2, 2, devices=[CPU] * 2), 2, jit=j,
            enable_rds=False),
        "time-sharded spread": lambda j: make_time_sharded_receiver(
            MODE0, make_mesh(2, 2, devices=[CPU] * 4), 2, jit=j),
    }
    for label, make in makers.items():
        (c_init, c_step), (e_init, e_step) = make(True), make(False)
        assert isinstance(c_step, ComposedStep), label
        _assert_runs_equal(_run(c_init, c_step, blocks),
                           _run(e_init, e_step, blocks))


@pytest.fixture(scope="module")
def capture():
    """Two blocks of a 4-slot capture, stations in slots 1 and 2."""
    return wideband_capture_iq(
        2 * MODE0.iq_len, 4, {1: {}, 2: dict(mono_hz=700.0, stereo_hz=1.7e3)}
    ).reshape(2, 4 * MODE0.block_size)


@pytest.mark.parametrize("order", [(0, 1), (1, 0)])
def test_wideband_composition_equals_unsharded(capture, order, monkeypatch):
    """The wideband-sharded step over two parts (the first holds the
    channelizer and its shard's stations, the second decodes its slice of
    the channelized I/Q from its own input buffer) equals the unsharded
    receiver bit for bit; so does ``make_wideband_sharded_receiver`` given
    two device groups."""
    kw = dict(pll_loop_div=8)
    init, step = make_wideband_receiver(MODE0, 4, device=CPU,
                                        channel_sharding=[CPU, CPU], **kw)
    c_step = compose_wideband(init, step, [(CPU, [k]) for k in order],
                              "wideband, two parts")
    u_init, u_step = make_wideband_receiver(MODE0, 4, device=CPU, **kw)
    st, ust = init(), u_init()
    for raw in capture:
        raw = torch.as_tensor(raw)
        st, out = c_step(st, raw)
        ust, ref = u_step(ust, raw)
        _assert_runs_equal([flatten(out)[0]], [flatten(ref)[0]])
    _assert_runs_equal(
        [flatten((concat_rows(list(st.rx), CPU), st.chan_zi))[0]],
        [flatten((ust.rx, ust.chan_zi))[0]])
    monkeypatch.setattr(channels, "device_groups",
                        lambda devs: [(CPU, [k]) for k in order])
    _, sharded = make_wideband_sharded_receiver(
        MODE0, make_mesh(2, 1, devices=[CPU] * 2), 4, **kw)
    assert isinstance(sharded, ComposedStep)
