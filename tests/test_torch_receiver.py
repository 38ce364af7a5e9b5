"""The slice as a whole: ``rtsdr_tpu_torch``'s receiver (CPU, plain
versions) against ``rtsdr_tpu.pipeline.receiver.make_receiver`` with the
same arguments, MODE0 at full width (307,200-byte blocks, 151 taps), batch
(2,), three blocks.

Tolerances: left/right/mono 2e-5 (float32 chains of three 151-tap FIRs, a
discriminator and a locked PLL, summed in different orders); state leaves
1e-5 (relative to the leaf's scale), the PLL's 1e-3 (its angles mod 4 pi:
sequential float32 rounding, cf. tests/test_pallas_pll.py).  With RDS on,
the bit layer's integer and bool outputs and state must be EQUAL and its
symbols agree within 1e-4 of their peak (tests/test_torch_rds.py has the
reason).

The RDS comparisons start from a mid-stream state (the JAX receiver's after
one block, converted): from the all-zero state the carrier loop is fed a
few samples of exactly 0, where the reference's scan-form detector and its
kernels part by design (ROADMAP Queue C; the port follows the kernels).
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
from rtsdr_tpu_torch.utils import signals
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
        assert t.shape == j.shape, path
        if j.dtype.kind in "biu":
            # (the reference's integer sums widen under its 64-bit test
            # mode: the values must be equal, the width may differ)
            assert t.dtype.kind == j.dtype.kind, path
            assert np.array_equal(t, j), path
            continue
        assert t.dtype == j.dtype, path
        if ".pll." in path:
            d = np.abs(t - j)
            if path.endswith(("phase_est", "theta")):
                d = np.minimum(d % _FOUR_PI, _FOUR_PI - d % _FOUR_PI)
            np.testing.assert_allclose(d, 0.0, atol=1e-3, err_msg=path)
        else:
            scale = max(1.0, float(np.max(np.abs(j)))) if j.size else 1.0
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * scale,
                                       err_msg=path)


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
    """RDS is on by default in mode 0 and builds; what raises is asking for
    it in a mode that has none, or for a route the port does not have."""
    from rtsdr_tpu_torch.config import MODE1

    _, step = trx.make_receiver(MODE0, (), device="cpu")
    rx = trx.Receiver(MODE0, device="cpu")
    state = rx.init()
    assert isinstance(state.rds, trx.RDSState)
    assert isinstance(state.frame, trx.FrameState)
    assert trx.make_receiver(MODE0, (), enable_rds=False,
                             device="cpu")[0]().rds is None
    with pytest.raises(ValueError, match="no RDS path"):
        trx.make_receiver(MODE1, (), enable_rds=True, device="cpu")
    with pytest.raises(ValueError, match="resamp_impl"):
        trx.make_receiver(MODE0, (), resamp_impl="xla", device="cpu")
    with pytest.raises(ValueError, match="fuse_if_bank"):
        trx.make_receiver(MODE0, (), fuse_if_bank="yes", device="cpu")


# ------------------------------------------------------------- RDS on

N_RDS_BLOCKS = 4


def _rds_station_blocks():
    """(N_RDS_BLOCKS, 2, block_size): two stations carrying RDS groups."""
    rows = []
    for k, ps in enumerate(("H100 FM ", "STATION2")):
        words = signals.ps_station_words(24, 0x3A5C + k, ps)
        wave = signals.rds_baseband(signals.encode_rds_blocks(words))
        rows.append(fm_multiplex_iq(
            N_RDS_BLOCKS * MODE0.iq_len, rds_wave=wave,
            mono_hz=1.1e3 - 400.0 * k, pilot_phase=0.9 * k))
    return np.stack(rows).reshape(2, N_RDS_BLOCKS, MODE0.block_size
                                  ).transpose(1, 0, 2).copy()


@pytest.fixture(scope="module")
def rds_blocks():
    return _rds_station_blocks()


def _assert_frame_outputs_equal(t_fo, j_fo, what):
    for name in t_fo._fields:
        t = getattr(t_fo, name).numpy()
        j = np.asarray(getattr(j_fo, name))
        assert t.shape == j.shape, (what, name)
        if j.dtype.kind in "biu":
            assert np.array_equal(t, j), (what, name, t, j)
        else:
            np.testing.assert_allclose(
                t, j, rtol=0, atol=1e-4 * float(np.max(np.abs(j))),
                err_msg=f"{what} {name}")


def _assert_audio_close(t_out, j_out, atol=2e-5):
    for name in ("left", "right", "mono"):
        t, j = getattr(t_out, name).numpy(), np.asarray(getattr(j_out, name))
        assert t.shape == j.shape and t.dtype == j.dtype
        np.testing.assert_allclose(t, j, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(enable_stereo=False),
    dict(use_abs_clock=True, resync=True, error_correct=True,
         offset_mode="gardner", derotate=True),
], ids=["default", "no-stereo", "all-frame-options"])
def test_rds_receiver_matches_jax_from_midstream_state(rds_blocks, kw):
    """The slice as a whole: u8 blocks of RDS-bearing stations through both
    receivers.  Block 0 runs in the JAX receiver; its state, through numpy,
    becomes the port's (field for field, RDSState and FrameState included);
    the bit layer restarts on the locked signal; blocks 1-3 run in both."""
    t_init, t_step = trx.make_receiver(MODE0, (2,), device="cpu", **kw)
    j_init, j_step = jrx.make_receiver(JMODE0, (2,), **kw)
    j_state, _ = j_step(j_init(), jnp.asarray(rds_blocks[0]))
    j_state = j_state._replace(frame=j_init().frame)
    t_state = state_from_numpy(jax.tree.map(np.asarray, j_state),
                               device="cpu")
    assert isinstance(t_state.rds, trx.RDSState)
    assert isinstance(t_state.frame, trx.FrameState)
    _assert_states_close(t_state, j_state)
    syncs = 0
    for b in range(1, N_RDS_BLOCKS):
        t_state, t_out = t_step(t_state, torch.as_tensor(rds_blocks[b]))
        j_state, j_out = j_step(j_state, jnp.asarray(rds_blocks[b]))
        _assert_audio_close(t_out, j_out)
        _assert_frame_outputs_equal(t_out.rds, j_out.rds, f"block {b}")
        _assert_states_close(t_state, j_state)
        syncs += int(t_out.rds.is_sync.sum())
    assert syncs >= 8        # both stations are being decoded


def test_rds_receiver_from_init_audio_matches_jax(rds_blocks):
    """From the zero state, RDS on: audio as without RDS; the frame layer's
    counts equal (the carrier loops of the two packages differ in block 0
    by design, see the module docstring, so its symbols are not compared)."""
    t_init, t_step = trx.make_receiver(MODE0, (2,), device="cpu")
    j_init, j_step = jrx.make_receiver(JMODE0, (2,))
    t_state, j_state = t_init(), j_init()
    _assert_states_close(t_state, j_state)
    for b in range(2):
        t_state, t_out = t_step(t_state, torch.as_tensor(rds_blocks[b]))
        j_state, j_out = j_step(j_state, jnp.asarray(rds_blocks[b]))
        _assert_audio_close(t_out, j_out)
        for name in ("n_sym", "n_windows", "positions"):
            assert np.array_equal(getattr(t_out.rds, name).numpy(),
                                  np.asarray(getattr(j_out.rds, name))), name
        _assert_states_close(t_state.frontend, j_state.frontend)
        _assert_states_close(t_state.audio, j_state.audio)


def _tree_equal(a, b, path=""):
    if a is None or b is None:
        assert a is None and b is None, path
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert type(a) is type(b) and len(a) == len(b), path
        for k, (x, y) in enumerate(zip(a, b)):
            _tree_equal(x, y, f"{path}.{getattr(a, '_fields', range(len(a)))[k]}")


def test_fuse_if_bank_equals_unfused(rds_blocks):
    """``fuse_if_bank=True`` (the band-passes inside the ingest stage, fm
    never returned) gives what ``False`` gives: on the CPU both are the same
    plain arithmetic, so equal bit for bit, states included."""
    seen = []
    for fuse in (False, True, "auto"):
        init, step = trx.make_receiver(MODE0, (2,), device="cpu",
                                       fuse_if_bank=fuse, pll_loop_div=4)
        state, outs = init(), []
        for b in range(2):
            state, out = step(state, torch.as_tensor(rds_blocks[b]))
            outs.append(out)
        seen.append((state, outs))
    for other in seen[1:]:
        _tree_equal(seen[0][0], other[0], "state")
        _tree_equal(tuple(seen[0][1]), tuple(other[1]), "outputs")


def test_fuse_if_bank_skips_the_separate_bank_launch(rds_blocks, monkeypatch):
    calls = []
    inner = trx.ingest_fir_demod_audio
    monkeypatch.setattr(
        trx, "ingest_fir_demod_audio",
        lambda *a, **k: calls.append(("ingest", k.get("bank_h") is not None,
                                      k["emit_fm"])) or inner(*a, **k))
    bank = trx.fir_block_bank
    monkeypatch.setattr(
        trx, "fir_block_bank",
        lambda *a, **k: calls.append(("bank",)) or bank(*a, **k))
    for fuse, want in ((True, [("ingest", True, False)]),
                       (False, [("ingest", False, True), ("bank",)])):
        calls.clear()
        init, step = trx.make_receiver(MODE0, (), device="cpu",
                                       fuse_if_bank=fuse, pll_loop_div=8)
        step(init(), torch.as_tensor(rds_blocks[0, 0]))
        assert calls == want


def test_rds_unbatched_equals_batch_row(rds_blocks):
    init_b, step_b = trx.make_receiver(MODE0, (2,), device="cpu",
                                       resync=True, pll_loop_div=4)
    init_1, step_1 = trx.make_receiver(MODE0, (), device="cpu",
                                       resync=True, pll_loop_div=4)
    st_b, st_1 = init_b(), init_1()
    for b in range(2):
        st_b, out_b = step_b(st_b, torch.as_tensor(rds_blocks[b]))
        st_1, out_1 = step_1(st_1, torch.as_tensor(rds_blocks[b, 1]))
        for name in out_1.rds._fields:
            assert torch.equal(getattr(out_b.rds, name)[1],
                               getattr(out_1.rds, name)), name
        assert torch.equal(out_b.left[1], out_1.left)


def test_enable_frame_false_returns_rrc(rds_blocks):
    init, step = trx.make_receiver(MODE0, (2,), device="cpu",
                                   enable_frame=False, pll_loop_div=8)
    state, out = step(init(), torch.as_tensor(rds_blocks[0]))
    assert state.frame is None and isinstance(out.rds, tuple)
    assert all(x.shape == (2, MODE0.rds_len) for x in out.rds)


def test_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        trx.Receiver(MODE0, enable_rds=False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        trx.make_receiver(MODE0, enable_rds=False)


def test_unported_frontends_name_their_slice():
    """Every front end of the reference is ported: 'iq' and 'if' (float
    I/Q from the channelizer) build and take the unfused audio route; a
    name that is none of them raises."""
    for impl, n in (("iq", MODE0.iq_len), ("if", MODE0.if_len)):
        init, step = trx.make_receiver(MODE0, enable_rds=False,
                                       frontend_impl=impl, pll_loop_div=8,
                                       device="cpu")
        _, out = step(init(), torch.zeros((2, n)))
        assert tuple(out.left.shape) == (MODE0.audio_len,)
    with pytest.raises(ValueError, match="unknown frontend impl"):
        trx.make_receiver(MODE0, enable_rds=False, frontend_impl="wide",
                          device="cpu")
