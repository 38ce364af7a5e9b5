"""The ops the time-sharded receiver adds to the port (plain versions, CPU)
against the JAX functions on the same numpy inputs:

* ``pll_extrapolate_by`` / ``pll_extrapolate`` at random locked states,
  with offsets broadcast over the batch: atol 1e-6 (angles compared mod
  4 pi; the extrapolation is a handful of float32 operations);
* ``resample_mul2_ref`` (the plain version of the mixer + resampler kernel
  K6), and its segmented form ``resample_mul2_segments_ref`` (T stacked
  chunks, each behind its left neighbour's inputs), against
  ``resample_mul2(impl='xla')`` given the halo zi at 1e-6 * max|ref| (float32
  sums of ~158 taps and of the dense zi terms in two orders, as
  tests/test_torch_resample.py), and against ``impl='pallas'`` in
  interpret mode at tests/test_pallas_fir.py's shape and bf16 tolerance
  (its operands are truncated to bf16: the TPU's arithmetic, not the
  function's); the carried ``new_zi`` bit for bit;
* ``ingest_fir_decimate(segments=S)`` against JAX's halo form
  (``halo=True``) over the same chunks: I/Q at the float32 route's 3e-6
  (two float32 sums of 151 terms in two orders; the JAX route is a matrix
  product, so bit equality is not a property of the function), the new
  zis bit for bit, and each segment bit for bit equal to the port's own
  serial form fed the chained zi, or its left neighbour's tail as zi.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsdr_tpu.config import MODE0 as JMODE0
from rtsdr_tpu.config import MODE1_RDS as JMODE1_RDS
from rtsdr_tpu.ops import coeffs
from rtsdr_tpu.ops import ingestfir as jing
from rtsdr_tpu.ops import pallas_fir as jpf
from rtsdr_tpu.pipeline.rds import composed_resampler_taps as j_comb
from rtsdr_tpu_torch.ops import cuda_resample as tres
from rtsdr_tpu_torch.ops import ingestfir as ting
from rtsdr_tpu_torch.ops import pll as tpll

jpll = importlib.import_module("rtsdr_tpu.ops.pll")

torch.set_num_threads(1)

FOUR_PI = 4 * np.pi
RF_H = np.asarray(coeffs.lowpass_taps(2.4e6, 100e3, 151), np.float64)


def _t(a):
    return torch.as_tensor(np.array(a, copy=True))


def _locked_state(rng, shape):
    f32 = lambda a: np.asarray(a, np.float32)
    theta = rng.uniform(0, FOUR_PI, shape)
    phase = rng.uniform(0, FOUR_PI, shape)
    integ = rng.normal(0, 2e-3, shape)
    arg = theta + phase
    return dict(integrator=f32(integ), phase_est=f32(phase),
                fb_i=f32(np.cos(arg)), fb_q=f32(np.sin(arg)),
                nco_i=f32(np.cos(2 * arg)), nco_q=f32(np.sin(2 * arg)),
                theta=f32(theta))


def _assert_pll_states_close(t_state, j_state):
    for name in tpll.PLLState._fields:
        t = getattr(t_state, name).numpy()
        j = np.broadcast_to(np.asarray(getattr(j_state, name)), t.shape)
        assert t.dtype == j.dtype == np.float32, name
        d = np.abs(t.astype(np.float64) - j)
        if name in ("phase_est", "theta"):
            d = np.minimum(d % FOUR_PI, FOUR_PI - d % FOUR_PI)
        np.testing.assert_allclose(d, 0.0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("loops", [1, 2])
def test_pll_extrapolate_by_matches_jax(rng, loops):
    """Per-shard offsets (T, 1) broadcast against a (C,) state, and two
    loops' constants (L, 1, 1) against (L, 1, C) as the time-sharded
    receiver's seeds use them."""
    t_shards, c, n_c = 4, 5, 3840
    freq = np.array([19e3, 114e3][:loops])
    scale = np.array([2.0, 0.5][:loops])
    adjust = np.array([0.0, -0.3][:loops])
    st = _locked_state(rng, (loops, 1, c))
    adv = np.mod(2 * np.pi * freq[:, None] / 240e3 * np.arange(t_shards)
                 * n_c, FOUR_PI)[..., None]             # (L, T, 1)
    ns = (np.arange(t_shards, dtype=np.float64) * n_c)[None, :, None]
    kw = dict(nco_scale=scale[:, None, None],
              phase_adjust=adjust[:, None, None])
    t = tpll.pll_extrapolate_by(
        tpll.PLLState(**{k: _t(v) for k, v in st.items()}), adv, ns, **kw)
    j = jpll.pll_extrapolate_by(
        jpll.PLLState(**{k: jnp.asarray(v) for k, v in st.items()}),
        adv, ns, **kw)
    assert t.theta.shape == (loops, t_shards, c)
    _assert_pll_states_close(t, j)


@pytest.mark.parametrize("n_steps,loop_div", [(3840, 1), (11520, 4), (1, 1)])
def test_pll_extrapolate_matches_jax(rng, n_steps, loop_div):
    st = _locked_state(rng, (6,))
    kw = dict(freq=19e3, fs=240e3, nco_scale=2.0, phase_adjust=0.1)
    t = tpll.pll_extrapolate(
        tpll.PLLState(**{k: _t(v) for k, v in st.items()}), n_steps, **kw)
    j = jpll.pll_extrapolate(
        jpll.PLLState(**{k: jnp.asarray(v) for k, v in st.items()}),
        n_steps, **kw)
    _assert_pll_states_close(t, j)


def _mix_inputs(rng, c, n, taps, up):
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    e, ni, nq = f32(c, n), f32(c, n), f32(c, n)
    # a carried zi as the receiver makes it: another block's mixed tail
    zi = np.asarray(jpf.resample_mul2_tail(
        jnp.asarray(f32(c, n)), jnp.asarray(f32(c, n)),
        jnp.asarray(f32(c, n)), taps - 1, up))
    return e, ni, nq, zi


@pytest.mark.parametrize("cfg_name,c,n", [("MODE0", 3, 3840),
                                          ("MODE0", 2, 15360),
                                          ("MODE1_RDS", 2, 4000)])
def test_resample_mul2_matches_xla_route(rng, cfg_name, c, n):
    cfg = {"MODE0": JMODE0, "MODE1_RDS": JMODE1_RDS}[cfg_name]
    h = j_comb(cfg)
    up, down = cfg.rds.up, cfg.rds.down
    e, ni, nq, zi = _mix_inputs(rng, c, n, len(h), up)
    ty, tz = tres.resample_mul2(_t(e), _t(ni), _t(nq), h, _t(zi), up, down)
    jy, jz = jpf.resample_mul2(*map(jnp.asarray, (e, ni, nq)), h,
                               jnp.asarray(zi), up, down, impl="xla")
    jy = np.asarray(jy)
    assert ty.shape == jy.shape == (c, 2, n * up // down)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0,
                               atol=1e-6 * float(np.abs(jy).max()))
    assert np.array_equal(tz.numpy(), np.asarray(jz))


def test_resample_mul2_matches_pallas_interpret(rng):
    """tests/test_pallas_fir.py::TestResampleMul2's shape (c = 32, n =
    3,840) and tolerance; the carry bit for bit."""
    h = j_comb(JMODE0)
    up, down = JMODE0.rds.up, JMODE0.rds.down
    e, ni, nq, zi = _mix_inputs(rng, 32, 3840, len(h), up)
    ty, tz = tres.resample_mul2(_t(e), _t(ni), _t(nq), h, _t(zi), up, down)
    jy, jz = jpf.resample_mul2(*map(jnp.asarray, (e, ni, nq)), h,
                               jnp.asarray(zi), up, down, impl="pallas")
    jy = np.asarray(jy)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0,
                               atol=2e-2 * float(np.abs(jy).max()) + 1e-6)
    assert np.array_equal(tz.numpy(), np.asarray(jz))


@pytest.mark.parametrize("cfg_name", ["MODE0", "MODE1_RDS"])
def test_resample_mul2_block_seam(rng, cfg_name):
    """Four chained chunks (each seeded by its left neighbour's carry, as
    the time shards are) equal one block, to float32 rounding."""
    cfg = {"MODE0": JMODE0, "MODE1_RDS": JMODE1_RDS}[cfg_name]
    h = j_comb(cfg)
    up, down = cfg.rds.up, cfg.rds.down
    n = cfg.if_len
    e, ni, nq, zi = _mix_inputs(rng, 2, n, len(h), up)
    full, full_zi = tres.resample_mul2(_t(e), _t(ni), _t(nq), h, _t(zi),
                                       up, down)
    parts, z = [], _t(zi)
    for k in range(4):
        sl = slice(k * n // 4, (k + 1) * n // 4)
        y, z = tres.resample_mul2(_t(e[:, sl]), _t(ni[:, sl]), _t(nq[:, sl]),
                                  h, z, up, down)
        parts.append(y)
    chained = torch.cat(parts, dim=-1).numpy()
    np.testing.assert_allclose(chained, full.numpy(), rtol=0,
                               atol=2e-6 * float(np.abs(full.numpy()).max()))
    assert torch.equal(z, full_zi)


def test_resample_mul2_split_impl_and_checks(rng):
    """Every instance runs the plain version on the CPU; unknown impls
    raise."""
    h = j_comb(JMODE0)
    e, ni, nq, zi = _mix_inputs(rng, 2, 3840, len(h), 19)
    a = (_t(e), _t(ni), _t(nq), h, _t(zi), 19, 80)
    auto = tres.resample_mul2(*a)
    for impl in ("pair", "split"):
        other = tres.resample_mul2(*a, impl=impl)
        assert all(torch.equal(x, y) for x, y in zip(auto, other))
    with pytest.raises(ValueError, match="unknown impl"):
        tres.resample_mul2(*a, impl="pallas")


def _halo_zi(e, ni, nq, zi, t1, up):
    """JAX's form of the time shards' carry: chunk 0 the block's zi, chunk
    s > 0 the zero-stuffed mixed tail of chunk s-1 (jpf's own helper)."""
    tails = [np.asarray(jpf.resample_mul2_tail(
        jnp.asarray(e[s]), jnp.asarray(ni[s]), jnp.asarray(nq[s]), t1, up))
        for s in range(e.shape[0] - 1)]
    return np.concatenate([zi[None]] + [t_[None] for t_ in tails])


@pytest.mark.parametrize("cfg_name,t_shards,c,n", [("MODE0", 4, 3, 3840),
                                                   ("MODE1_RDS", 4, 2, 4000),
                                                   ("MODE0", 2, 2, 160)])
def test_resample_mul2_segments_match_xla_route(rng, cfg_name, t_shards, c,
                                                 n):
    """The segmented plain version against the JAX function over the
    stacked (T*C, n) chunks given the halo zi: y at 1e-6 * max|ref|, the
    last chunk's carry bit for bit."""
    cfg = {"MODE0": JMODE0, "MODE1_RDS": JMODE1_RDS}[cfg_name]
    h = j_comb(cfg)
    up, down = cfg.rds.up, cfg.rds.down
    e, ni, nq, _ = _mix_inputs(rng, t_shards * c, n, len(h), up)
    e, ni, nq = (a.reshape(t_shards, c, n) for a in (e, ni, nq))
    zi = _mix_inputs(rng, c, n, len(h), up)[3]
    ty, tz = tres.resample_mul2(_t(e), _t(ni), _t(nq), h, _t(zi), up, down,
                                segments=t_shards)
    halo = _halo_zi(e, ni, nq, zi, len(h) - 1, up)
    flat = lambda a: jnp.asarray(a.reshape(t_shards * c, *a.shape[2:]))
    jy, jz = jpf.resample_mul2(flat(e), flat(ni), flat(nq), h, flat(halo),
                               up, down, impl="xla")
    jy = np.asarray(jy).reshape(t_shards, c, 2, -1)
    assert ty.shape == jy.shape and tz.shape == (c, 2, len(h) - 1)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0,
                               atol=1e-6 * float(np.abs(jy).max()))
    assert np.array_equal(tz.numpy(),
                          np.asarray(jz).reshape(t_shards, c, 2, -1)[-1])


def test_resample_mul2_segments_match_pallas_interpret(rng):
    """The same against JAX's Pallas route in interpret mode at
    tests/test_pallas_fir.py's shape (32 rows of 3,840: 4 chunks of 8
    stations) and its bf16 tolerance."""
    h = j_comb(JMODE0)
    e, ni, nq, _ = _mix_inputs(rng, 32, 3840, len(h), 19)
    e, ni, nq = (a.reshape(4, 8, 3840) for a in (e, ni, nq))
    zi = _mix_inputs(rng, 8, 3840, len(h), 19)[3]
    ty, tz = tres.resample_mul2(_t(e), _t(ni), _t(nq), h, _t(zi), 19, 80,
                                segments=4)
    halo = _halo_zi(e, ni, nq, zi, len(h) - 1, 19)
    flat = lambda a: jnp.asarray(a.reshape(32, *a.shape[2:]))
    jy, jz = jpf.resample_mul2(flat(e), flat(ni), flat(nq), h, flat(halo),
                               19, 80, impl="pallas")
    jy = np.asarray(jy).reshape(4, 8, 2, -1)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0,
                               atol=2e-2 * float(np.abs(jy).max()) + 1e-6)
    assert np.array_equal(tz.numpy(), np.asarray(jz).reshape(4, 8, 2, -1)[-1])


def test_resample_mul2_segments_equal_chained_blocks(rng):
    """Chunk s behind its left neighbour's inputs is chunk s chained from
    chunk s-1's carry: the segmented form equals four chained calls (the
    plain version's float32 sums of another batch shape: 1e-6 * max|y|),
    the carry bit for bit."""
    h = j_comb(JMODE0)
    e, ni, nq, zi = _mix_inputs(rng, 8, 3840, len(h), 19)
    e, ni, nq = (a.reshape(4, 2, 3840) for a in (e, ni, nq))
    zi = zi[:2]
    ty, tz = tres.resample_mul2(_t(e), _t(ni), _t(nq), h, _t(zi), 19, 80,
                                segments=4)
    z = _t(zi)
    for s in range(4):
        y, z = tres.resample_mul2(_t(e[s]), _t(ni[s]), _t(nq[s]), h, z, 19,
                                  80)
        np.testing.assert_allclose(ty[s].numpy(), y.numpy(), rtol=0,
                                   atol=1e-6 * float(y.abs().max()))
    assert torch.equal(tz, z)


class _OnCard(torch.Tensor):
    """A CPU tensor that claims to lie on a CUDA device."""

    is_cuda = property(lambda self: True)


def test_resample_mul2_segments_launch_or_raise(monkeypatch, rng):
    """A CUDA tensor reaches K6's one launch with the stacked rows and the
    segment count; the plain version never runs for it; a chunk shorter
    than the carried tail, or a zi of the wrong rows, raises."""
    from rtsdr_tpu_torch.ops import _cuda

    seen = []
    monkeypatch.setattr(_cuda, "launch",
                        lambda entry, count_as, *a: seen.append(
                            (entry, count_as, a[7:])))
    monkeypatch.setattr(tres, "resample_mul2_segments_ref",
                        lambda *a, **k: pytest.fail("plain version ran"))
    h = j_comb(JMODE0)
    x = torch.zeros(4, 3, 3840).as_subclass(_OnCard)
    zi = torch.zeros(3, 2, len(h) - 1)
    y, nz = tres.resample_mul2(x, x, x, h, zi, 19, 80, segments=4,
                               impl="split")
    assert tuple(y.shape) == (4, 3, 2, 912) and tuple(nz.shape) == (
        3, 2, len(h) - 1)
    assert seen == [("rtsdr_resample_mix", "resample_mix.split",
                     (12, 4, 3840, 912, len(h), 19, 80, 1, 19.0))]
    with pytest.raises(ValueError, match="shorter"):
        short = torch.zeros(4, 3, 80).as_subclass(_OnCard)
        tres.resample_mul2(short, short, short, h, zi, 19, 80, segments=4)
    with pytest.raises(ValueError, match="zi"):
        tres.resample_mul2(x, x, x, h, torch.zeros(4, 3, 2, len(h) - 1),
                           19, 80, segments=4)
    assert len(seen) == 1


def _segment_rows(rng, c, n_pairs, segments):
    """c raw rows of ``segments`` chunks, the carried zi on segment 0 and
    zeros on the others (as the time shards hand them on), and JAX's halo
    form of the same: each chunk behind its left neighbour's raw tail, the
    first behind the zero level."""
    raw = rng.integers(0, 256, (c, segments * 2 * n_pairs), dtype=np.uint8)
    zi = np.zeros((2, segments, c, 150), np.float32)
    zi[:, 0] = rng.standard_normal((2, c, 150)).astype(np.float32) * 0.1
    chunks = raw.reshape(c, segments, -1).transpose(1, 0, 2)
    halo = np.concatenate([np.full_like(chunks[:1, :, -300:], 128),
                           chunks[:-1, :, -300:]])
    raw_ext = np.concatenate([halo, chunks], -1).reshape(segments * c, -1)
    return raw, zi, raw_ext


@pytest.mark.parametrize("c,n_pairs", [(4, 3840), (3, 1500)])
def test_ingest_halo_matches_jax(rng, c, n_pairs):
    """The segmented form against JAX's halo form over the same chunks."""
    raw, zi, raw_ext = _segment_rows(rng, c, n_pairs, 3)
    t = ting.ingest_fir_decimate(_t(raw), RF_H, _t(zi[0]), _t(zi[1]), 10,
                                 segments=3)
    j = jing.ingest_fir_decimate(jnp.asarray(raw_ext), RF_H,
                                 jnp.asarray(zi[0].reshape(3 * c, 150)),
                                 jnp.asarray(zi[1].reshape(3 * c, 150)), 10,
                                 halo=True, impl="f32")
    for a, b, tol in zip(t, j, (3e-6, 3e-6, 0.0, 0.0)):
        b = np.asarray(b)
        assert a.shape == (3, c) + b.shape[1:]
        assert a.numpy().dtype == b.dtype
        np.testing.assert_allclose(a.numpy().reshape(b.shape), b, rtol=0,
                                   atol=tol)
    assert t[0].shape == (3, c, n_pairs // 10)


def test_ingest_halo_is_the_zi_form(rng):
    """A segment's left neighbour's bytes act exactly as the carried zi
    would, and the segments chained through their zi are the whole row
    through the serial form: bit for bit."""
    raw, zi, _ = _segment_rows(rng, 3, 2560, 4)
    t = ting.ingest_fir_decimate(_t(raw), RF_H, _t(zi[0]), _t(zi[1]), 10,
                                 segments=4)
    zi_i, zi_q = _t(zi[0, 0]), _t(zi[1, 0])
    for s, seg in enumerate(np.split(raw, 4, axis=1)):
        y_i, y_q, zi_i, zi_q = ting.ingest_fir_decimate(_t(seg), RF_H, zi_i,
                                                        zi_q, 10)
        assert torch.equal(t[0][s], y_i) and torch.equal(t[1][s], y_q)
        if s > 0:
            halo = ting.normalize_deinterleave(_t(raw.reshape(3, 4, -1)[
                :, s - 1, -300:]))
            z = ting.ingest_fir_decimate(_t(seg), RF_H, halo[:, 0],
                                         halo[:, 1], 10)
            assert torch.equal(t[0][s], z[0]) and torch.equal(t[1][s], z[1])
    assert torch.equal(t[2][-1], zi_i) and torch.equal(t[3][-1], zi_q)
    with pytest.raises(ValueError, match="fewer"):
        ting.ingest_fir_decimate(_t(raw[:, :1120]), RF_H, _t(zi[0]),
                                 _t(zi[1]), 10, segments=4)
