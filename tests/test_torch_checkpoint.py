"""Checkpoint / resume of the port's receivers, and checkpoints crossing
between the two packages (CPU).

Port counterparts of ``tests/test_utils.py::test_checkpoint_resume_bit_exact``
and ``::test_checkpoint_resume_sharded_bit_exact`` (resume is invisible in
the outputs, bit for bit), plus what only two packages can show: a state
saved by ``rtsdr_tpu.utils.checkpoint.save_state`` resumes in the port and
the reverse, the next blocks of both receivers then agreeing within the
tolerances ``tests/test_torch_receiver.py`` uses for the two packages'
float32 routes (audio 2e-5, the frame layer's integers equal, symbols
within 1e-4 of their peak).  The JAX receivers are built un-jitted.

The sharded cross-load writes the JAX time-sharded checkpoint with the JAX
package's own ``save_state`` from a state placed on its 2 x 4 mesh by its
own ``load_state``; the JAX time-sharded step itself is not run (its build
costs a minute or more on the CPU).
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
from rtsdr_tpu.pipeline import receiver as jrx
from rtsdr_tpu.utils import checkpoint as jck
from rtsdr_tpu_torch.config import MODE0
from rtsdr_tpu_torch.parallel.channels import make_wideband_sharded_receiver
from rtsdr_tpu_torch.parallel.mesh import make_mesh
from rtsdr_tpu_torch.parallel.timeshard import make_time_sharded_receiver
from rtsdr_tpu_torch.pipeline import receiver as trx
from rtsdr_tpu_torch.pipeline.scan import make_band_scanner
from rtsdr_tpu_torch.pipeline.wideband import make_wideband_receiver
from rtsdr_tpu_torch.utils import load_state, save_state
from rtsdr_tpu_torch.utils.checkpoint import state_keys
from rtsdr_tpu_torch.utils.shards import concat_rows
from rtsdr_tpu_torch.utils.signals import fm_multiplex_iq, wideband_capture_iq
from test_torch_receiver import (
    _assert_audio_close,
    _assert_frame_outputs_equal,
    _assert_states_close,
    _rds_station_blocks,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")

# the keys of a MODE0 receiver state with RDS and the frame layer, as
# rtsdr_tpu.utils.checkpoint._flatten_paths names them
MODE0_KEYS = [
    "frontend/zi_i", "frontend/zi_q", "frontend/prev_i", "frontend/prev_q",
    "audio/mono_zi", "audio/pilot_zi", "audio/chan_zi", "audio/stereo_zi",
    *(f"audio/pll/{f}" for f in ("integrator", "phase_est", "fb_i", "fb_q",
                                 "nco_i", "nco_q", "theta")),
    "rds/extract_zi", "rds/squared_zi",
    *(f"rds/pll/{f}" for f in ("integrator", "phase_est", "fb_i", "fb_q",
                               "nco_i", "nco_q", "theta")),
    "rds/resamp_zi", "rds/rrc_zi",
    *(f"frame/{f}" for f in ("offset", "start_pos", "lonely_bit", "prebit",
                             "first_block", "carry", "carry_len", "base_pos",
                             "last_position", "bad_count", "offset_frac",
                             "derot_phase")),
]


@pytest.fixture(scope="module")
def rds_blocks():
    return _rds_station_blocks()


def _trees_equal(a, b, path="state"):
    if a is None or b is None:
        assert a is None and b is None, path
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.device == b.device, path
        assert torch.equal(a, b), path
    else:
        assert type(a) is type(b) and len(a) == len(b), path
        for k, (x, y) in enumerate(zip(a, b)):
            _trees_equal(x, y, f"{path}.{getattr(a, '_fields', range(9))[k]}")


# ----------------------------------------------------------- port only

def test_state_keys_are_the_jax_keys():
    """The port's keys are exactly the JAX package's for the same state,
    the 38 of a MODE0 receiver with RDS and the frame layer; a None field
    writes nothing."""
    t_state = trx.make_receiver(MODE0, (2,), device="cpu")[0]()
    j_state = jrx.make_receiver(JMODE0, (2,))[0]()
    assert state_keys(t_state) == MODE0_KEYS
    assert list(jck._flatten_paths(j_state)[0]) == MODE0_KEYS
    no_rds = trx.make_receiver(MODE0, (2,), enable_rds=False,
                               device="cpu")[0]()
    assert state_keys(no_rds) == [k for k in MODE0_KEYS
                                  if k.split("/")[0] in ("frontend", "audio")]


def test_checkpoint_resume_bit_exact(tmp_path):
    """Stopping, checkpointing and resuming is invisible in the outputs:
    three blocks in one run against one block, save, load into a fresh
    ``init_fn()``, two more."""
    iq = fm_multiplex_iq(3 * MODE0.iq_len)
    init_fn, step = trx.make_receiver(MODE0, device="cpu")
    bs = MODE0.block_size
    blocks = [torch.as_tensor(iq[b * bs:(b + 1) * bs]) for b in range(3)]
    state, outs = init_fn(), []
    for raw in blocks:
        state, out = step(state, raw)
        outs.append(out)
    state, out0 = step(init_fn(), blocks[0])
    ckpt = str(tmp_path / "state.npz")
    save_state(ckpt, state)
    resumed = load_state(ckpt, init_fn())
    _trees_equal(resumed, state)
    outs2 = [out0]
    for raw in blocks[1:]:
        resumed, out = step(resumed, raw)
        outs2.append(out)
    for a, b in zip(outs, outs2):
        _trees_equal(a, b, "outputs")


def test_checkpoint_resume_sharded_bit_exact(tmp_path):
    """The time-sharded receiver on a CPU mesh (2 channel shards x 4 time
    shards): its state (a tuple of per-shard serial states) saves in serial
    layout and resumes bit for bit, each shard's rows on its device."""
    n_ch, n_blocks = 2, 3
    iq = fm_multiplex_iq(n_blocks * MODE0.iq_len)
    mesh = make_mesh(2, 4, devices=["cpu", "cpu"])
    init_fn, step = make_time_sharded_receiver(MODE0, mesh, n_ch)
    bs = MODE0.block_size

    def blk(b):
        return np.stack([iq[b * bs:(b + 1) * bs]] * n_ch)

    state, outs = init_fn(), []
    for b in range(n_blocks):
        state, out = step(state, blk(b))
        outs.append(out.left)
    state, out0 = step(init_fn(), blk(0))
    ckpt = str(tmp_path / "sharded.npz")
    save_state(ckpt, state)
    with np.load(ckpt) as f:
        assert f["frontend/zi_i"].shape[0] == n_ch       # serial layout
        assert list(f.files) == state_keys(state)
    resumed = load_state(ckpt, init_fn())
    assert isinstance(resumed, tuple) and len(resumed) == 2
    _trees_equal(resumed, state)
    outs2 = [out0.left]
    for b in range(1, n_blocks):
        resumed, out = step(resumed, blk(b))
        outs2.append(out.left)
    assert torch.equal(torch.cat(outs), torch.cat(outs2))


def test_wideband_and_scan_states_round_trip(tmp_path):
    """``WidebandState`` (unsharded, and channel-sharded with its ``rx`` a
    tuple of shard states) and ``ScanState`` through the same functions: the
    sharded state saves in the unsharded layout and loads into either."""
    capture = wideband_capture_iq(MODE0.iq_len, 4, {1: {}}
                                  ).reshape(1, 4 * MODE0.block_size)
    u_init, u_step = make_wideband_receiver(MODE0, 4, device="cpu",
                                            pll_loop_div=8)
    s_init, s_step = make_wideband_sharded_receiver(
        MODE0, make_mesh(2, 1, devices=["cpu", "cpu"]), 4, pll_loop_div=8)
    raw = torch.as_tensor(capture[0])
    ust, _ = u_step(u_init(), raw)
    sst, _ = s_step(s_init(), raw)
    a, b = str(tmp_path / "wb.npz"), str(tmp_path / "wb_sharded.npz")
    save_state(a, ust)
    save_state(b, sst)
    assert state_keys(ust) == state_keys(sst)
    with np.load(a) as fa, np.load(b) as fb:
        for k in fa.files:
            assert np.array_equal(fa[k], fb[k]), k
    _trees_equal(load_state(b, u_init()), ust)
    back = load_state(a, s_init())
    assert isinstance(back.rx, tuple) and len(back.rx) == 2
    _trees_equal(back.rx, sst.rx)
    _trees_equal(concat_rows(list(back.rx), CPU), ust.rx)

    sc_init, sc_step = make_band_scanner(MODE0, 4, device="cpu")
    _, sc_state = sc_step(sc_init(), raw)
    c = str(tmp_path / "scan.npz")
    save_state(c, sc_state)
    assert state_keys(sc_state)[0] == "chan_zi"
    _trees_equal(load_state(c, sc_init()), sc_state)


def test_batched_wideband_shards_save_along_the_station_axis(tmp_path):
    """Two captures a step (batch shape (2,)): a channel-sharded ``rx``
    holds its stations on axis 1 (``WidebandState.shard_axis``), so its
    checkpoint equals the unsharded receiver's and loads back into
    either layout."""
    capture = wideband_capture_iq(MODE0.iq_len, 4, {1: {}, 2: {}}
                                  ).reshape(1, 4 * MODE0.block_size)
    raw = torch.as_tensor(np.concatenate([capture, capture[:, ::-1]]))
    kw = dict(batch_shape=(2,), device="cpu", pll_loop_div=8)
    u_init, u_step = make_wideband_receiver(MODE0, 4, **kw)
    s_init, s_step = make_wideband_receiver(
        MODE0, 4, channel_sharding=["cpu", "cpu"], **kw)
    ust, _ = u_step(u_init(), raw)
    sst, _ = s_step(s_init(), raw)
    assert sst.shard_axis("rx") == 1
    a, b = str(tmp_path / "wb.npz"), str(tmp_path / "wb_sharded.npz")
    save_state(a, ust)
    save_state(b, sst)
    with np.load(a) as fa, np.load(b) as fb:
        assert fa.files == fb.files
        for k in fa.files:
            assert np.array_equal(fa[k], fb[k]), k
    _trees_equal(load_state(b, u_init()), ust)
    back = load_state(a, s_init())
    _trees_equal(back.rx, sst.rx)
    assert back.rx[0].frontend.zi_i.shape[:2] == (2, 2)


def test_load_refuses_missing_leaf_and_wrong_shape(tmp_path):
    """A missing leaf raises KeyError and a wrong shape ValueError, in the
    port as in the JAX package, for files of either."""
    t_init = trx.make_receiver(MODE0, (2,), device="cpu")[0]
    j_init = jrx.make_receiver(JMODE0, (2,))[0]
    full = str(tmp_path / "full.npz")
    save_state(full, t_init())
    with np.load(full) as f:
        data = {k: f[k] for k in f.files}
    missing = str(tmp_path / "missing.npz")
    np.savez(missing, **{k: v for k, v in data.items()
                         if k != "rds/pll/theta"})
    wrong = str(tmp_path / "wrong.npz")
    three = trx.make_receiver(MODE0, (3,), device="cpu")[0]()
    save_state(wrong, three)
    for load, like in ((load_state, t_init()), (jck.load_state, j_init())):
        with pytest.raises(KeyError, match="rds/pll/theta"):
            load(missing, like)
        with pytest.raises(ValueError, match="checkpoint shape"):
            load(wrong, like)
    sharded_like = make_time_sharded_receiver(
        MODE0, make_mesh(2, 1, devices=["cpu", "cpu"]), 2)[0]()
    with pytest.raises(ValueError, match="checkpoint shape"):
        load_state(wrong, sharded_like)      # 3 rows over 2 shards


# ---------------------------------------------------- across packages

def _continue_both(t_state, t_step, j_state, j_step, blocks,
                   serial=lambda st: st):
    """Blocks 1 and 2 through both receivers from their loaded states
    (``serial`` maps the port's state to the serial layout)."""
    syncs = 0
    for b in (1, 2):
        t_state, t_out = t_step(t_state, torch.as_tensor(blocks[b]))
        j_state, j_out = j_step(j_state, jnp.asarray(blocks[b]))
        _assert_audio_close(t_out, j_out)
        _assert_frame_outputs_equal(t_out.rds, j_out.rds, f"block {b}")
        _assert_states_close(serial(t_state), j_state)
        syncs += int(t_out.rds.is_sync.sum())
    assert syncs >= 4          # both stations are being decoded


def _values_equal(t_state, j_state):
    """Every leaf of the port's state equals the JAX state's by value
    (integer widths may differ: the JAX tests run in 64-bit mode)."""
    t_leaves = dict((k, v.numpy()) for k, v in
                    _leaf_items(t_state))
    j_leaves = {k: np.asarray(v)
                for k, v in jck._flatten_paths(j_state)[0].items()}
    assert t_leaves.keys() == j_leaves.keys()
    for k, v in j_leaves.items():
        assert np.array_equal(t_leaves[k], v), k


def _leaf_items(state):
    from rtsdr_tpu_torch.utils.checkpoint import _leaves

    return list(_leaves(state))


def test_jax_checkpoint_resumes_in_the_port(tmp_path, rds_blocks):
    """JAX receiver: block 0, JAX ``save_state``; the port's ``load_state``
    into its own ``init_fn()``; both continue with blocks 1 and 2."""
    t_init, t_step = trx.make_receiver(MODE0, (2,), device="cpu")
    j_init, j_step = jrx.make_receiver(JMODE0, (2,))
    j_state, _ = j_step(j_init(), jnp.asarray(rds_blocks[0]))
    ckpt = str(tmp_path / "jax.npz")
    jck.save_state(ckpt, j_state)
    t_state = load_state(ckpt, t_init())
    _values_equal(t_state, j_state)
    assert t_state.frame.carry.dtype == torch.int32      # like's width
    _continue_both(t_state, t_step, j_state, j_step, rds_blocks)


def test_port_checkpoint_resumes_in_jax(tmp_path, rds_blocks):
    """The reverse: the port's block 0 and ``save_state``; JAX's
    ``load_state``; both continue with blocks 1 and 2."""
    t_init, t_step = trx.make_receiver(MODE0, (2,), device="cpu")
    j_init, j_step = jrx.make_receiver(JMODE0, (2,))
    t_state, _ = t_step(t_init(), torch.as_tensor(rds_blocks[0]))
    ckpt = str(tmp_path / "port.npz")
    save_state(ckpt, t_state)
    j_state = jck.load_state(ckpt, j_init())
    _values_equal(t_state, j_state)
    _continue_both(t_state, t_step, j_state, j_step, rds_blocks)


def test_jax_time_sharded_checkpoint_resumes_in_the_port(tmp_path,
                                                         rds_blocks):
    """A JAX checkpoint of a state on its 2 x 4 (channel, time) mesh loads
    into the port's time-sharded receiver on a 2 x 4 CPU mesh, which then
    continues as the JAX serial receiver does from that state; the port's
    time-sharded state saved again loads back onto the JAX mesh."""
    j_init, j_step = jrx.make_receiver(JMODE0, (2,))
    j_state, _ = j_step(j_init(), jnp.asarray(rds_blocks[0]))
    serial = str(tmp_path / "serial.npz")
    jck.save_state(serial, j_state)
    j_ts_like = j_make_ts(JMODE0, j_make_mesh(2, 4), 2, jnp.float32)[0]()
    placed = jck.load_state(serial, j_ts_like)
    assert all(leaf.sharding.mesh.shape == {"ch": 2, "t": 4}
               for leaf in jax.tree.leaves(placed))
    sharded = str(tmp_path / "jax_sharded.npz")
    jck.save_state(sharded, placed)

    init, step = make_time_sharded_receiver(
        MODE0, make_mesh(2, 4, devices=["cpu", "cpu"]), 2)
    t_state = load_state(sharded, init())
    assert isinstance(t_state, tuple) and len(t_state) == 2
    assert t_state[0].frontend.zi_i.shape[0] == 1
    _values_equal(concat_rows(list(t_state), CPU), j_state)
    _continue_both(t_state, lambda s, x: step(s, x.numpy()), j_state, j_step,
                   rds_blocks, lambda st: concat_rows(list(st), CPU))

    back = str(tmp_path / "port_sharded.npz")
    save_state(back, t_state)
    again = jck.load_state(back, j_ts_like)
    assert all(leaf.sharding.mesh.shape == {"ch": 2, "t": 4}
               for leaf in jax.tree.leaves(again))
    _values_equal(concat_rows(list(t_state), CPU), again)


def test_chip_smoke_holds_the_same_key_list():
    """``chip_smoke.py``'s checkpoint phase checks the card's keys against
    its own copy of the list: the same list as here."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_keys", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.CHECKPOINT_KEYS == MODE0_KEYS
