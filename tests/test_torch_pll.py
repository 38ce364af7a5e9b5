"""``rtsdr_tpu_torch.ops.pll`` (the plain per-sample loop, CPU) against
``rtsdr_tpu.ops.pll.pll(impl='scan')`` and, at one small shape, against the
Pallas kernel in interpret mode.

float64 at 1e-9 (same recurrence, different libm).  float32: NCO 5e-5,
state 1e-3 — the bounds of tests/test_pallas_pll.py: sequential float32
rounding differs between implementations, the loop feedback keeps the NCO
far tighter than the carried angles.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsdr_tpu.ops.pallas_pll import pll_pallas
from rtsdr_tpu_torch.ops import pll as tpll

# ``rtsdr_tpu.ops`` re-exports the function ``pll`` under the module's name
jpll = importlib.import_module("rtsdr_tpu.ops.pll")

torch.set_num_threads(1)

_FOUR_PI = 4 * np.pi
N = 1920
DT = {"f32": (np.float32, jnp.float32, torch.float32, 5e-5, 1e-3),
      "f64": (np.float64, jnp.float64, torch.float64, 1e-9, 1e-9)}


def _pilot(n, c=None, fs=240e3, f=19e3, t0=0):
    t = (np.arange(n) + t0) / fs
    if c is None:
        return np.cos(2 * np.pi * f * t + 0.4)
    return np.stack([np.cos(2 * np.pi * f * t + 0.1 * k) for k in range(c)])


def _tstate(jst, td):
    return tpll.PLLState(*(torch.as_tensor(np.array(v), dtype=td)
                           for v in jst))


def _assert_state_close(t_st, j_st, atol):
    assert type(t_st)._fields == type(j_st)._fields
    for name, a, b in zip(type(j_st)._fields, t_st, j_st):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name in ("phase_est", "theta"):     # angles mod 4 pi
            d = np.abs(a - b) % _FOUR_PI
            d = np.minimum(d, _FOUR_PI - d)
            np.testing.assert_allclose(d, 0.0, atol=atol, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=atol, err_msg=name)


def _both(x, batch, prec, **kw):
    nd, jd, td, tol_nco, tol_st = DT[prec]
    tx = (tuple(torch.as_tensor(p.astype(nd)) for p in x)
          if isinstance(x, tuple) else torch.as_tensor(x.astype(nd)))
    jx = (tuple(jnp.asarray(p.astype(nd)) for p in x)
          if isinstance(x, tuple) else jnp.asarray(x.astype(nd)))
    t = tpll.pll(tx, tpll.pll_init(batch, td, device="cpu"), impl="loop",
                 **kw)
    j = jpll.pll(jx, jpll.pll_init(batch, jd), impl="scan", **kw)
    for a, b in zip(t[:2], j[:2]):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=tol_nco)
    _assert_state_close(t[2], j[2], tol_st)
    return t, j


def test_pll_init_matches():
    for batch in ((), (2, 3)):
        t = tpll.pll_init(batch, torch.float32, device="cpu")
        j = jpll.pll_init(batch, jnp.float32)
        _assert_state_close(t, j, 0.0)


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_matches_scan(prec, batch):
    c = batch[0] if batch else None
    _both(_pilot(N, c), batch, prec, freq=19e3, fs=240e3, nco_scale=2.0)


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("loop_div", [1, 2, 4])
@pytest.mark.parametrize("delay_output", [True, False])
def test_loop_div_and_delay(prec, loop_div, delay_output):
    _both(_pilot(N, 2), (2,), prec, freq=19e3, fs=240e3, nco_scale=2.0,
          loop_div=loop_div, delay_output=delay_output)


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("as_tuple", [False, True])
def test_per_lane_constants_and_tuple_input(prec, as_tuple):
    """The receiver's fused stereo-pilot + RDS-carrier layout: config axis
    leads, constants per config."""
    c = 3
    pil = _pilot(N, c)
    car = _pilot(N, c, f=114e3)
    x = (pil, car) if as_tuple else np.stack([pil, car])
    shape = (2, 1)
    kw = dict(freq=np.array([19e3, 114e3]).reshape(shape), fs=240e3,
              nco_scale=np.array([2.0, 0.5]).reshape(shape),
              phase_adjust=np.array(
                  [0.0, math.pi / 3.3 - math.pi / 1.5]).reshape(shape),
              norm_bandwidth=np.array([0.01, 0.001]).reshape(shape))
    _both(x, (2, c), prec, **kw)


@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_two_chained_blocks(prec):
    nd, jd, td, tol_nco, tol_st = DT[prec]
    kw = dict(freq=19e3, fs=240e3, nco_scale=2.0)
    t_st = tpll.pll_init((2,), td, device="cpu")
    j_st = jpll.pll_init((2,), jd)
    for b in range(2):
        x = _pilot(N, 2, t0=b * N).astype(nd)
        ti, tq, t_st = tpll.pll(torch.as_tensor(x), t_st, impl="loop", **kw)
        ji, jq, j_st = jpll.pll(jnp.asarray(x), j_st, impl="scan", **kw)
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=tol_nco)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=tol_nco)
        _assert_state_close(t_st, j_st, tol_st)
        if b == 0:   # delayed view: element 0 is the previous last sample
            first = np.asarray(ji)[:, 0]
            assert np.array_equal(first, np.ones(2, nd))
        else:
            assert np.array_equal(ti.numpy()[:, 0], prev_last)
        prev_last = t_st.nco_i.numpy().copy()


def test_from_nontrivial_state_matches_scan(rng):
    """Both continue from the same mid-stream state."""
    x = _pilot(N, 2).astype(np.float32)
    _, _, j0 = jpll.pll(jnp.asarray(x), jpll.pll_init((2,), jnp.float32),
                        freq=19e3, fs=240e3, nco_scale=2.0)
    x2 = _pilot(N, 2, t0=N).astype(np.float32)
    ti, tq, t1 = tpll.pll(torch.as_tensor(x2), _tstate(j0, torch.float32),
                          freq=19e3, fs=240e3, nco_scale=2.0, impl="loop")
    ji, jq, j1 = jpll.pll(jnp.asarray(x2), j0, freq=19e3, fs=240e3,
                          nco_scale=2.0)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=5e-5)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=5e-5)
    _assert_state_close(t1, j1, 1e-3)


@pytest.mark.parametrize("loop_div", [1, 4])
def test_matches_pallas_interpret(loop_div):
    x = _pilot(N, 3).astype(np.float32)
    kw = dict(freq=19e3, fs=240e3, nco_scale=2.0, loop_div=loop_div)
    ti, tq, t_st = tpll.pll(torch.as_tensor(x),
                            tpll.pll_init((3,), device="cpu"), impl="loop",
                            **kw)
    pi, pq, p_st = pll_pallas(jnp.asarray(x), jpll.pll_init((3,), jnp.float32),
                              interpret=True, **kw)
    np.testing.assert_allclose(ti.numpy(), np.asarray(pi), atol=5e-5)
    np.testing.assert_allclose(tq.numpy(), np.asarray(pq), atol=5e-5)
    _assert_state_close(t_st, p_st, 1e-3)


def test_zero_input_gives_zero_error():
    """x == 0 (silence through zero FIR state): the detector error is 0 and
    the loop free-runs at the NCO ramp — the Pallas kernel's convention
    (the literal atan2(-0, -0) of the scan form would kick by pi whenever
    cos of the feedback angle is negative)."""
    n = 256
    x = torch.zeros(2, n)
    ti, tq, st = tpll.pll(x, tpll.pll_init((2,), device="cpu"), freq=19e3,
                          fs=240e3, nco_scale=2.0, impl="loop")
    assert float(st.integrator.abs().max()) == 0.0
    assert float(st.phase_est.abs().max()) == 0.0
    # open loop: nothing corrects the float32 rounding of the sequential
    # theta ramp (~2.4e-7 per step, doubled by nco_scale), hence 2e-4
    ramp = 2.0 * (2 * np.pi * 19e3 / 240e3) * np.arange(n)
    np.testing.assert_allclose(ti.numpy(), np.tile(np.cos(ramp), (2, 1)),
                               atol=2e-4)
    np.testing.assert_allclose(tq.numpy(), np.tile(np.sin(ramp), (2, 1)),
                               atol=2e-4)
    pi, pq, p_st = pll_pallas(jnp.zeros((2, n), jnp.float32),
                              jpll.pll_init((2,), jnp.float32), freq=19e3,
                              fs=240e3, nco_scale=2.0, interpret=True)
    np.testing.assert_allclose(ti.numpy(), np.asarray(pi), atol=2e-4)
    assert float(np.abs(np.asarray(p_st.integrator)).max()) == 0.0


def test_bad_arguments():
    x = torch.zeros(1, 30)
    st = tpll.pll_init((1,), device="cpu")
    with pytest.raises(ValueError):
        tpll.pll(x, st, freq=19e3, fs=240e3, loop_div=3)
    with pytest.raises(ValueError):
        tpll.pll(x, st, freq=19e3, fs=240e3, loop_div=4)   # 30 % 4 != 0
    with pytest.raises(ValueError):
        tpll.pll(x, st, freq=19e3, fs=240e3, impl="pallas")


def test_kernel_wrapper_on_cpu_tensor_is_the_plain_loop():
    """``pll_cuda`` takes its plain version only because the tensor lies on
    the CPU: same numbers as impl='loop', tuple input included."""
    from rtsdr_tpu_torch.ops.cuda_pll import pll_cuda

    x = torch.as_tensor(_pilot(256, 2).astype(np.float32))
    kw = dict(freq=19e3, fs=240e3, nco_scale=2.0, loop_div=2)
    a = pll_cuda((x, x), tpll.pll_init((2, 2), device="cpu"), **kw)
    b = tpll.pll(torch.stack([x, x]), tpll.pll_init((2, 2), device="cpu"),
                 impl="loop", **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for u, v in zip(a[2], b[2]):
        assert torch.equal(u, v)


# --------------------------------------------------------------------------
# CPU rehearsal of the kernel's reordered chain (csrc/pll.cu runs only on a
# card), in float32 arithmetic op for op (a fused multiply-add emulated in
# float64, rounded once): the kq = kp + ki fold, theta's per-sample ramp off
# the chain, the detector's wrap by the 1.5 * 2^23 rounding trick and a
# two-part 2*pi, the loop_div gate and zero mask as selects, phase's
# mod 4*pi deferred to once per 8 samples and to each 64-sample tile's end,
# the stored angle folded per sample only for a scale that is not a
# half-integer, the NCO from the stored angles, the delayed view.

_F32 = np.float32
_K_PI, _K_4PI = _F32(np.pi), _F32(4 * np.pi)
_K_INV2PI, _K_MAGIC = _F32(1 / (2 * np.pi)), _F32(12582912.0)
_K_HI = _F32(2 * np.pi)
_K_LO = _F32(2 * np.pi - np.float64(_K_HI))


def _fma(a, b, c):
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(_F32) \
        if np.ndim(a) or np.ndim(b) or np.ndim(c) else \
        _F32(np.float64(a) * np.float64(b) + np.float64(c))


def _fold(z):
    z = np.where(z >= _K_4PI, z - _K_4PI, z).astype(_F32)
    return np.where(z < 0, z + _K_4PI, z).astype(_F32)


def _chain_rehearsal(x, st, consts, loop_div, delay):
    """x (C, N) float32, st: numpy (7, C), consts: numpy (5, C) float32 (the
    wrapper's table) -> nco_i, nco_q (C, N), new state (7, C)."""
    c, n = x.shape
    kp, ki, dth, sc, ad = (consts[i].astype(_F32) for i in range(5))
    kq = (kp + ki).astype(_F32)
    kqlo, kilo = (-kq * _K_LO).astype(_F32), (-ki * _K_LO).astype(_F32)
    fold_store = np.any(_F32(2) * sc != np.rint(_F32(2) * sc))
    integ, phase = st[0].astype(_F32), st[1].astype(_F32)
    a = np.arctan2(st[3].astype(_F32), st[2].astype(_F32)).astype(_F32)
    theta = st[6].astype(_F32)
    tp = (a - phase).astype(_F32)
    ang = np.zeros((c, n + 1), _F32)
    ang[:, 0] = a
    for t0 in range(0, n, 64):
        length = min(64, n - t0)
        for tt in range(length):
            k = t0 + tt
            if k % loop_div == 0:
                xk = x[:, k]
                live = xk != 0
                off = np.where(xk < 0, _K_PI, _F32(0)).astype(_F32)
                mq, mi = np.where(live, kq, 0), np.where(live, ki, 0)
                mqlo, milo = np.where(live, kqlo, 0), np.where(live, kilo, 0)
                z = ((off - tp).astype(_F32) - phase).astype(_F32)
                kk = (_fma(z, _K_INV2PI, _K_MAGIC) - _K_MAGIC).astype(_F32)
                tr = _fma(-kk, _K_HI, z)
                pi_pre = (phase + integ).astype(_F32)
                phase = _fma(mq, tr, _fma(kk, mqlo, pi_pre))
                integ = _fma(mi, tr, _fma(kk, milo, integ))
            theta = _fold((theta + dth).astype(_F32))
            tp = theta
            ang[:, k + 1] = theta + (_fold(phase) if fold_store else phase)
            if tt % 8 == 7 or tt == length - 1:
                phase = _fold(phase)
                assert np.all((phase >= 0) & (phase <= _K_4PI))
                assert np.all((theta >= 0) & (theta <= _K_4PI))
    arg = _fma(ang, sc[:, None], ad[:, None]).astype(np.float64)
    ni, nq = np.cos(arg).astype(_F32), np.sin(arg).astype(_F32)
    if delay:
        ni[:, 0], nq[:, 0] = st[4], st[5]
        ni_out, nq_out = ni[:, :n], nq[:, :n]
    else:
        ni_out, nq_out = ni[:, 1:], nq[:, 1:]
    a_end = (theta + phase).astype(_F32)
    arg_end = _fma(a_end, sc, ad).astype(np.float64)
    new = np.stack([integ, phase, np.cos(np.float64(a_end)),
                    np.sin(np.float64(a_end)), np.cos(arg_end),
                    np.sin(arg_end), theta]).astype(_F32)
    return ni_out, nq_out, new


def _locked_lanes(n, scales):
    """(3, n) of two blocks: a pilot, a 114 kHz carrier (the squared RDS
    band-pass), a pilot with a stretch of exact zeros in the second block;
    the loops' constants, per lane."""
    from rtsdr_tpu_torch.utils.signals import generate_sin

    fs = 240e3
    pilot = generate_sin(fs, 19e3, 2 * n, 0.3)
    carrier = np.roll(generate_sin(fs, 114e3, 2 * n, 0.5), 3)
    gap = pilot.copy()
    gap[n + 1000:n + 1300] = 0.0
    x = np.stack([pilot, carrier, gap]).astype(np.float32)
    kw = dict(freq=np.array([19e3, 114e3, 19e3]), fs=fs,
              nco_scale=np.array(scales), phase_adjust=np.array([0, .3, 0]),
              norm_bandwidth=np.array([0.01, 0.01, 0.02]))
    return x, kw


@pytest.mark.parametrize("loop_div,delay,scales", [
    (1, True, [2.0, 0.5, 2.0]), (4, True, [2.0, 0.5, 2.0]),
    (1, False, [2.0, 0.5, 2.0]), (2, True, [2.0, 1.3, 1.0])])
def test_kernel_chain_equals_plain_loop(loop_div, delay, scales):
    """The kernel's reordered chain, rehearsed in float32 over the second
    of two 3,000-sample blocks (locked loops; a tile that is not full; a
    lane fed exact zeros for 300 samples), is within the kernel's
    tolerances of the plain loop: NCO 5e-5, state 1e-4 (angles mod 4 pi),
    integrator 1e-5."""
    from rtsdr_tpu_torch.ops.cuda_pll import _lane_consts

    n = 3000
    x, kw = _locked_lanes(n, scales)
    xt = torch.as_tensor(x)
    st0 = tpll.pll_init((3,), device="cpu")
    _, _, st1 = tpll.pll_loop(xt[:, :n], st0, loop_div=loop_div, **kw)
    ri, rq, rst = tpll.pll_loop(xt[:, n:].contiguous(), st1,
                                loop_div=loop_div, delay_output=delay, **kw)
    consts = _lane_consts((3,), 3, "cpu", kw["freq"], kw["fs"],
                          kw["nco_scale"], kw["phase_adjust"],
                          kw["norm_bandwidth"], loop_div).numpy()
    st = np.stack([v.numpy() for v in st1])
    ki, kq, kst = _chain_rehearsal(x[:, n:], st, consts, loop_div, delay)
    np.testing.assert_allclose(ki, ri.numpy(), rtol=0, atol=5e-5)
    np.testing.assert_allclose(kq, rq.numpy(), rtol=0, atol=5e-5)
    for i, name in enumerate(tpll.PLLState._fields):
        d = np.abs(kst[i].astype(np.float64) - rst[i].numpy())
        if name in ("phase_est", "theta"):
            d = np.minimum(d % _FOUR_PI, _FOUR_PI - d % _FOUR_PI)
        tol = 1e-5 if name == "integrator" else 1e-4
        assert d.max() <= tol, (name, d.max())
    # the loops are locked: the detector error is small on every lane
    assert float(rst.integrator.abs().max()) < 1e-2


def test_stacked_state_reads_one_block_without_a_copy():
    """The receiver's pilot and carrier states, split from one call's
    (7, 2C) state, stack back into views of that very buffer; other states
    are stacked once."""
    from rtsdr_tpu_torch.ops.cuda_pll import _rows_of_one_block, stacked_state

    block = torch.arange(7 * 2 * 3, dtype=torch.float32).view(7, 6)
    st2 = tpll.PLLState(*(row.view(2, 3) for row in block.unbind(0)))
    a = tpll.PLLState(*(v[0] for v in st2))
    b = tpll.PLLState(*(v[1] for v in st2))
    s = stacked_state((a, b))
    assert s.integrator.data_ptr() == block.data_ptr()
    assert _rows_of_one_block(s, 6).data_ptr() == block.data_ptr()
    for u, v in zip(s, st2):
        assert torch.equal(u, v)
    c = stacked_state((tpll.pll_init((3,), device="cpu"),) * 2)
    assert _rows_of_one_block(c, 6) is not None
    assert torch.equal(c.fb_i, torch.ones(2, 3))
    assert _rows_of_one_block(tpll.pll_init((3,), device="cpu"), 3) is None


@pytest.mark.parametrize("make", [
    lambda v: list(v), lambda v: tuple(v), lambda v: np.float32(v[0]),
    lambda v: np.array(v[0]), lambda v: np.array(v).reshape(2, 1)],
    ids=["list", "tuple", "numpy scalar", "0-d array", "(2, 1) array"])
def test_kernel_plan_key_takes_any_array_like(make):
    """The kernel wrapper's plan key takes every loop-constant form the
    plain loop takes (lists, tuples, numpy scalars, arrays of any rank):
    equal values give equal keys, other values other keys."""
    from rtsdr_tpu_torch.ops.cuda_pll import _arg_key

    a, b = _arg_key(make([19e3, 114e3])), _arg_key(make([19e3, 114e3]))
    assert a == b and hash(a) == hash(b)
    assert _arg_key(make([19.5e3, 114e3])) != a
    big = np.zeros(65)
    assert _arg_key(big) == ("id", id(big))
