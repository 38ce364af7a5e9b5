"""The port's concurrent PLL handoffs against the JAX package's own
time-sharded receiver (``rtsdr_tpu.parallel.timeshard``, T = 4 on the
virtual CPU mesh).

``stale`` and ``iterate`` are approximations of the serial loop, so being
close to the serial receiver would not show that the port computes what
the JAX package computes: here both packages' time-sharded receivers run
the same blocks from the same mid-stream state (the JAX receiver's after
block 0, through numpy; the bit layer restarted on the locked signal), and
the port must match the JAX receiver's approximation — audio within 2e-5,
the frame layer's integer outputs equal and its symbols within 1e-4 of
their peak (tests/test_torch_receiver.py's tolerances for the two
packages' float32 routes) — while for ``stale`` the serial receiver run
from the same state lies far outside that tolerance.

Two jitted JAX time-sharded builds in this file (one per handoff), each
made once for the module: a build costs a minute or more on the CPU.
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
from rtsdr_tpu_torch.config import MODE0
from rtsdr_tpu_torch.parallel.mesh import make_mesh
from rtsdr_tpu_torch.parallel.timeshard import make_time_sharded_receiver
from rtsdr_tpu_torch.pipeline.receiver import make_receiver
from rtsdr_tpu_torch.utils.convert import state_from_numpy
from rtsdr_tpu_torch.utils.signals import (
    encode_rds_blocks,
    fm_multiplex_iq,
    ps_station_words,
    rds_baseband,
)

torch.set_num_threads(1)

N_BLOCKS = 4
T_SHARDS = 4
AUDIO_ATOL = 2e-5


def _blocks():
    """(N_BLOCKS, 2, block_size): two RDS-bearing stations."""
    rows = []
    for k, (mono_hz, stereo_hz) in enumerate(((1.1e3, 2.3e3),
                                              (700.0, 3.1e3))):
        wave = rds_baseband(encode_rds_blocks(ps_station_words(
            N_BLOCKS + 4, 0x3A5C + k, "H100 FM ")))
        rows.append(fm_multiplex_iq(
            N_BLOCKS * MODE0.iq_len, mono_hz=mono_hz, stereo_hz=stereo_hz,
            pilot_phase=0.9 * k, rds_wave=wave))
    return np.stack(rows).reshape(2, N_BLOCKS, MODE0.block_size
                                  ).transpose(1, 0, 2).copy()


def _jax_run(handoff):
    """Block 0 from the zero state, then the blocks after it, through the
    JAX time-sharded receiver: (state after block 0 as numpy with the
    frame layer reset, outputs of blocks 1..)."""
    blocks = _blocks()
    init, step = j_make_ts(JMODE0, j_make_mesh(1, T_SHARDS), 2, jnp.float32,
                           pll_handoff=handoff)
    state, _ = step(init(), jnp.asarray(blocks[0]))
    state = state._replace(frame=init().frame)
    state0 = jax.tree.map(np.asarray, state)
    outs = []
    for b in range(1, N_BLOCKS):
        state, out = step(state, jnp.asarray(blocks[b]))
        outs.append(jax.tree.map(np.asarray, out))
    return blocks, state0, outs


@pytest.fixture(scope="module")
def jax_stale():
    return _jax_run("stale")


@pytest.fixture(scope="module")
def jax_iterate():
    return _jax_run("iterate")


def _port_run(blocks, state0, **kw):
    init, step = make_time_sharded_receiver(
        MODE0, make_mesh(1, T_SHARDS, devices=["cpu"]), 2, **kw)
    st = (state_from_numpy(state0, device="cpu"),)
    outs = []
    for b in range(1, N_BLOCKS):
        st, out = step(st, blocks[b])
        outs.append(out)
    return outs


def _compare(t_outs, j_outs):
    for b, (t, j) in enumerate(zip(t_outs, j_outs), start=1):
        for name in ("left", "right", "mono"):
            a, r = getattr(t, name).numpy(), getattr(j, name)
            assert a.shape == r.shape and a.dtype == r.dtype
            np.testing.assert_allclose(a, r, rtol=0, atol=AUDIO_ATOL,
                                       err_msg=f"block {b} {name}")
        for name, a, r in zip(t.rds._fields, t.rds, j.rds):
            a = a.numpy()
            assert a.shape == r.shape, name
            if r.dtype.kind in "biu":
                assert np.array_equal(a, r), (b, name)
            else:
                np.testing.assert_allclose(
                    a, r, rtol=0, atol=1e-4 * float(np.abs(r).max()),
                    err_msg=f"block {b} {name}")


@pytest.mark.parametrize("handoff", ["stale", "iterate"])
def test_handoff_matches_jax_time_sharded_receiver(request, handoff):
    blocks, state0, j_outs = request.getfixturevalue(f"jax_{handoff}")
    t_outs = _port_run(blocks, state0, pll_handoff=handoff)
    _compare(t_outs, j_outs)
    syncs = sum(int(o.rds.is_sync.sum()) for o in t_outs)
    assert syncs >= 8                 # both stations are being decoded


def test_stale_is_jax_approximation_not_serial(jax_stale):
    """The serial receiver from the same state parts from JAX's stale
    receiver by far more than the tolerance the port is held to."""
    blocks, state0, j_outs = jax_stale
    init, step = make_receiver(MODE0, (2,), device="cpu")
    st = state_from_numpy(state0, device="cpu")
    gap = 0.0
    for b in range(1, N_BLOCKS):
        st, out = step(st, torch.as_tensor(blocks[b]))
        gap = max(gap, float(np.abs(out.left.numpy()
                                    - j_outs[b - 1].left).max()))
    assert gap > 10 * AUDIO_ATOL
