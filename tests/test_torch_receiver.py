"""The slice as a whole: ``rtsdr_tpu_torch``'s receiver (CPU, plain
versions) against ``rtsdr_tpu.pipeline.receiver.make_receiver`` with the
same arguments, MODE0 at full width (307,200-byte blocks, 151 taps), batch
(2,), three blocks.

Tolerances: left/right/mono 2e-5 (float32 chains of three 151-tap FIRs, a
discriminator and a locked PLL, summed in different orders); state leaves
1e-5, the PLL's 1e-3 (its angles mod 4 pi: sequential float32 rounding,
cf. tests/test_pallas_pll.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsdr_tpu.config import MODE0 as JMODE0
from rtsdr_tpu.pipeline import receiver as jrx
from rtsdr_tpu_torch.config import MODE0
from rtsdr_tpu_torch.pipeline import receiver as trx
from rtsdr_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
from rtsdr_tpu_torch.utils.signals import fm_multiplex_iq

torch.set_num_threads(1)

_FOUR_PI = 4 * np.pi
N_BLOCKS = 3


def _station_blocks():
    """(N_BLOCKS, 2, block_size): two stations with different tones."""
    n = N_BLOCKS * MODE0.iq_len
    a = fm_multiplex_iq(n)
    b = fm_multiplex_iq(n, mono_hz=700.0, stereo_hz=3.1e3, pilot_phase=0.9)
    return np.stack([a, b]).reshape(2, N_BLOCKS, MODE0.block_size
                                    ).transpose(1, 0, 2).copy()


def _leaves(tree, prefix=""):
    """(path, leaf) pairs of a nested NamedTuple / None tree."""
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
        assert t.shape == j.shape and t.dtype == j.dtype, path
        if ".pll." in path:
            d = np.abs(t - j)
            if path.endswith(("phase_est", "theta")):
                d = np.minimum(d % _FOUR_PI, _FOUR_PI - d % _FOUR_PI)
            np.testing.assert_allclose(d, 0.0, atol=1e-3, err_msg=path)
        else:
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-5, err_msg=path)


def _assert_outputs_close(t_out, j_out, atol=2e-5):
    assert t_out.rds is None and j_out.rds is None
    for name in ("left", "right", "mono"):
        t, j = getattr(t_out, name).numpy(), np.asarray(getattr(j_out, name))
        assert t.shape == j.shape == (2, MODE0.audio_len), name
        assert t.dtype == j.dtype
        np.testing.assert_allclose(t, j, rtol=0, atol=atol, err_msg=name)


def _make_both(**kw):
    t_init, t_step = trx.make_receiver(MODE0, (2,), enable_rds=False,
                                       device="cpu", **kw)
    j_init, j_step = jrx.make_receiver(JMODE0, (2,), enable_rds=False, **kw)
    return (t_init, t_step), (j_init, j_step)


@pytest.mark.parametrize("frontend_impl", ["split", "fused"])
@pytest.mark.parametrize("enable_stereo", [True, False])
def test_receiver_matches_jax_three_blocks(frontend_impl, enable_stereo):
    (t_init, t_step), (j_init, j_step) = _make_both(
        frontend_impl=frontend_impl, enable_stereo=enable_stereo)
    blocks = _station_blocks()
    t_state, j_state = t_init(), j_init()
    _assert_states_close(t_state, j_state)
    for b in range(N_BLOCKS):
        t_state, t_out = t_step(t_state, torch.as_tensor(blocks[b]))
        j_state, j_out = j_step(j_state, jnp.asarray(blocks[b]))
        _assert_outputs_close(t_out, j_out)
        _assert_states_close(t_state, j_state)
    if not enable_stereo:
        assert torch.equal(t_out.left, t_out.mono)
        assert torch.equal(t_out.right, t_out.mono)


def test_receiver_options_match_jax():
    """De-emphasis, stereo blend and a divided PLL loop in one run."""
    kw = dict(deemphasis=75e-6, stereo_blend=True, pll_loop_div=2)
    (t_init, t_step), (j_init, j_step) = _make_both(**kw)
    blocks = _station_blocks()
    t_state, j_state = t_init(), j_init()
    for b in range(2):
        t_state, t_out = t_step(t_state, torch.as_tensor(blocks[b]))
        j_state, j_out = j_step(j_state, jnp.asarray(blocks[b]))
        _assert_outputs_close(t_out, j_out)
        _assert_states_close(t_state, j_state)


def test_receiver_random_bytes_mono(rng):
    """Uniform random bytes: after the RF low-pass the I/Q is noise-like and
    passes near zero, where the discriminator's angle is ill-conditioned —
    isolated fm samples of the two float32 routes part by ~1e-3, which the
    audio low-pass averages down.  Mono chain (a PLL fed noise never locks
    and is chaotic by design), audio at 2e-4, front-end state exact."""
    (t_init, t_step), (j_init, j_step) = _make_both(enable_stereo=False)
    t_state, j_state = t_init(), j_init()
    for b in range(2):
        raw = rng.integers(0, 256, (2, MODE0.block_size), dtype=np.uint8)
        t_state, t_out = t_step(t_state, torch.as_tensor(raw))
        j_state, j_out = j_step(j_state, jnp.asarray(raw))
        _assert_outputs_close(t_out, j_out, atol=2e-4)
        for name in ("zi_i", "zi_q", "prev_i", "prev_q"):
            np.testing.assert_allclose(
                getattr(t_state.frontend, name).numpy(),
                np.asarray(getattr(j_state.frontend, name)), rtol=0,
                atol=1e-5, err_msg=name)


def test_receiver_continues_from_converted_midstream_state():
    """State carried across: the JAX receiver runs block 0, its state goes
    through numpy into the port, and both continue with blocks 1 and 2."""
    (t_init, t_step), (j_init, j_step) = _make_both()
    blocks = _station_blocks()
    j_state, _ = j_step(j_init(), jnp.asarray(blocks[0]))
    j_numpy = jax.tree.map(np.asarray, j_state)
    t_state = state_from_numpy(j_numpy, device="cpu")
    assert isinstance(t_state, trx.ReceiverState)
    _assert_states_close(t_state, j_state)          # field by field, exact
    back = dict(_leaves(state_to_numpy(t_state)))
    for path, leaf in _leaves(j_numpy):
        assert back[path].dtype == leaf.dtype
        assert np.array_equal(back[path], leaf), path
    for b in (1, 2):
        t_state, t_out = t_step(t_state, torch.as_tensor(blocks[b]))
        j_state, j_out = j_step(j_state, jnp.asarray(blocks[b]))
        _assert_outputs_close(t_out, j_out)
        _assert_states_close(t_state, j_state)


def test_enable_rds_raises_until_the_rds_slice():
    with pytest.raises(NotImplementedError, match="RDS slice"):
        trx.make_receiver(MODE0, (), enable_rds=True, device="cpu")
    with pytest.raises(NotImplementedError, match="RDS slice"):
        trx.make_receiver(MODE0, (), device="cpu")     # default: RDS on
    with pytest.raises(NotImplementedError, match="RDS slice"):
        trx.Receiver(MODE0, device="cpu")


def test_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        trx.Receiver(MODE0, enable_rds=False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        trx.make_receiver(MODE0, enable_rds=False)


def test_unported_frontends_name_their_slice():
    with pytest.raises(NotImplementedError, match="wideband"):
        trx.make_receiver(MODE0, enable_rds=False, frontend_impl="iq",
                          device="cpu")
