"""The rational resampler and the fused mixer + resampler + RRC of the port
(plain versions, CPU) against the JAX functions on the same numpy inputs.

float32 at 2e-6 * max|ref| (sums of ~158 + 151 float32 terms in two
orders; in proportion more for the 9,003-tap filter against a dense zi),
float64 at 1e-12; carried states equal.  The interpret-mode Pallas
kernel is held at the tolerance its own tests use (tests/test_pallas_fir.py:
its operands are truncated to bf16, which is the TPU's arithmetic, not the
function's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsdr_tpu.config import MODE0 as JMODE0
from rtsdr_tpu.config import MODE1_RDS as JMODE1_RDS
from rtsdr_tpu.ops import coeffs
from rtsdr_tpu.ops import fir as jfir
from rtsdr_tpu.ops import pallas_fir as jpf
from rtsdr_tpu.pipeline.rds import composed_resampler_taps as j_comb
from rtsdr_tpu_torch.config import MODE0, MODE1_RDS
from rtsdr_tpu_torch.ops import cuda_resample as tres
from rtsdr_tpu_torch.ops import fir as tfir
from rtsdr_tpu_torch.pipeline.rds import composed_resampler_taps as t_comb

torch.set_num_threads(1)

DT = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}
RRC_H = coeffs.rrc_taps(57e3, 151, 0.9, 2375.0)


def _close(t, j, prec, taps=0):
    """``taps``: the 9,003-tap MODE1_RDS filter against a dense random zi
    sums three times the terms of the 3,001-tap one: its float32 bound
    scales with the term count."""
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape and t.dtype == j.dtype
    tol = (1e-12 if prec == "f64" else
           2e-6 * max(1.0, taps / 3001) * float(np.max(np.abs(j))) + 1e-30)
    np.testing.assert_allclose(t, j, rtol=0, atol=tol)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _taps(which):
    if which == "comb0":
        return j_comb(JMODE0)               # 3,001 taps, x19/80
    if which == "comb1":
        return j_comb(JMODE1_RDS)           # 9,003 taps, x57/250
    return coeffs.lowpass_taps(240e3 * 19, 28.5e3, int(which))


@pytest.mark.parametrize("cfg_name", ["MODE0", "MODE1_RDS"])
def test_composed_resampler_taps_bitwise(cfg_name):
    j = j_comb({"MODE0": JMODE0, "MODE1_RDS": JMODE1_RDS}[cfg_name])
    t = t_comb({"MODE0": MODE0, "MODE1_RDS": MODE1_RDS}[cfg_name])
    assert t.dtype == j.dtype == np.float64
    assert np.array_equal(t, j)
    assert len(t) == {"MODE0": 3001, "MODE1_RDS": 9003}[cfg_name]


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("up,down,n,which", [
    (19, 80, 1280, "301"), (19, 80, 1600, "comb0"),
    (57, 250, 1000, "453"), (57, 250, 2000, "comb1"),
    (24, 125, 1000, "301"), (3, 4, 64, "31"),
])
def test_fir_resample_matches_jax(rng, prec, up, down, n, which):
    nd, td = DT[prec]
    h = _taps(which)
    x = rng.standard_normal((2, 2, n)).astype(nd)
    zi = (rng.standard_normal((2, 2, len(h) - 1)) * 0.3).astype(nd)
    for gain in (None, 1.0):
        ty, tz = tfir.fir_resample(_t(x), h, _t(zi), up, down, gain)
        jy, jz = jfir.fir_resample(jnp.asarray(x), h, jnp.asarray(zi), up,
                                   down, gain)
        assert ty.shape[-1] == n * up // down
        _close(ty, jy, prec, len(h))
        assert np.array_equal(tz.numpy(), np.asarray(jz))


@pytest.mark.parametrize("up,down,which", [(19, 80, "comb0"),
                                           (57, 250, "453")])
def test_fir_resample_block_seam(rng, up, down, which):
    """Two blocks with the carried upsampled-domain zi == one long block
    (float64: exact sums up to order), and equal to the JAX chain."""
    h = _taps(which)
    n = 2 * down * 8
    x = rng.standard_normal((3, 2 * n))
    z0 = np.zeros((3, len(h) - 1))
    y1, z1 = tfir.fir_resample(_t(x[:, :n]), h, _t(z0), up, down)
    y2, z2 = tfir.fir_resample(_t(x[:, n:]), h, z1, up, down)
    whole, zw = tfir.fir_resample(_t(x), h, _t(z0), up, down)
    np.testing.assert_allclose(torch.cat([y1, y2], -1).numpy(),
                               whole.numpy(), rtol=0, atol=1e-12)
    assert torch.equal(z2, zw)
    jy1, jz1 = jfir.fir_resample(jnp.asarray(x[:, :n]), h, jnp.asarray(z0),
                                 up, down)
    jy2, _ = jfir.fir_resample(jnp.asarray(x[:, n:]), h, jz1, up, down)
    _close(y2, jy2, "f64")


def test_resample_helpers_match_jax(rng):
    x = rng.standard_normal((2, 3, 40)).astype(np.float32)
    for n_tail, up in ((30, 3), (31, 3), (150, 19), (7, 19)):
        t = tfir._upsampled_tail_of(_t(x), n_tail, up).numpy()
        j = np.asarray(jfir._upsampled_tail_of(jnp.asarray(x), n_tail, up))
        assert np.array_equal(t, j)
    for t1, up, down in ((3000, 19, 80), (9002, 57, 250), (30, 3, 4)):
        for a, b in zip(tfir._resample_boundary_index(t1, up, down),
                        jfir._resample_boundary_index(t1, up, down)):
            assert np.array_equal(a, b)


def _mix_inputs(rng, c, n, taps, nd=np.float32, batch=None):
    lead = (c,) if batch is None else batch
    mk = lambda *s: rng.standard_normal(s).astype(nd)
    return (mk(*lead, n), mk(*lead, n), mk(*lead, n),
            (mk(*lead, 2, taps - 1) * 0.1).astype(nd),
            (mk(*lead, 2, len(RRC_H) - 1) * 0.1).astype(nd))


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("up,down,n,which,batch", [
    (19, 80, 1600, "comb0", (3,)), (19, 80, 15360, "comb0", ()),
    (57, 250, 2000, "comb1", (2, 2)), (19, 80, 1280, "301", (1,)),
])
def test_resample_mul2_rrc_ref_matches_xla_route(rng, prec, up, down, n,
                                                 which, batch):
    nd, _ = DT[prec]
    h = _taps(which)
    e, ni, nq, zi, rzi = _mix_inputs(rng, None, n, len(h), nd, batch)
    t = tres.resample_mul2_rrc(_t(e), _t(ni), _t(nq), h, _t(zi), RRC_H,
                               _t(rzi), up, down)
    j = jpf.resample_mul2_rrc(*(jnp.asarray(a) for a in (e, ni, nq)), h,
                              jnp.asarray(zi), RRC_H, jnp.asarray(rzi), up,
                              down, impl="xla")
    assert t[0].shape == (*batch, 2, n * up // down)
    _close(t[0], j[0], prec, len(h))               # rrc
    assert np.array_equal(t[1].numpy(), np.asarray(j[1]))   # new resamp zi
    _close(t[2], j[2], prec, len(h))               # new rrc zi
    tail = tres.resample_mul2_tail(_t(e), _t(ni), _t(nq), len(h) - 1, up)
    jtail = jpf.resample_mul2_tail(*(jnp.asarray(a) for a in (e, ni, nq)),
                                   len(h) - 1, up)
    assert torch.equal(tail, t[1])
    assert np.array_equal(tail.numpy(), np.asarray(jtail))


def test_resample_mul2_rrc_block_seam(rng):
    """Two blocks with both carried states == one long block."""
    h = _taps("comb0")
    n = 1600
    e, ni, nq, _, _ = _mix_inputs(rng, 2, 2 * n, len(h), np.float64)
    z0 = torch.zeros(2, 2, len(h) - 1, dtype=torch.float64)
    r0 = torch.zeros(2, 2, len(RRC_H) - 1, dtype=torch.float64)
    first = lambda a: _t(a[:, :n])
    second = lambda a: _t(a[:, n:])
    y1, z1, r1 = tres.resample_mul2_rrc(first(e), first(ni), first(nq), h,
                                        z0, RRC_H, r0, 19, 80)
    y2, z2, r2 = tres.resample_mul2_rrc(second(e), second(ni), second(nq), h,
                                        z1, RRC_H, r1, 19, 80)
    yw, zw, rw = tres.resample_mul2_rrc(_t(e), _t(ni), _t(nq), h, z0, RRC_H,
                                        r0, 19, 80)
    np.testing.assert_allclose(torch.cat([y1, y2], -1).numpy(), yw.numpy(),
                               rtol=0, atol=1e-12)
    assert torch.equal(z2, zw)
    np.testing.assert_allclose(r2.numpy(), rw.numpy(), rtol=0, atol=1e-12)


def test_resample_mul2_rrc_ref_matches_pallas_interpret(rng):
    """The geometry of tests/test_pallas_fir.py::test_rrc_fused_matches_
    composition (C = 32, n = 3840), at its bf16 tolerance."""
    h = _taps("comb0")
    e, ni, nq, zi, rzi = _mix_inputs(rng, 32, 3840, len(h))
    t = tres.resample_mul2_rrc(_t(e), _t(ni), _t(nq), h, _t(zi), RRC_H,
                               _t(rzi), 19, 80)
    j = jpf.resample_mul2_rrc(*(jnp.asarray(a) for a in (e, ni, nq)), h,
                              jnp.asarray(zi), RRC_H, jnp.asarray(rzi), 19,
                              80, impl="pallas")
    for a, b in ((t[0], j[0]), (t[2], j[2])):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=2e-2 * float(np.max(np.abs(b))) + 1e-6)
    assert np.array_equal(t[1].numpy(), np.asarray(j[1]))


def test_short_block_raises_on_the_kernel_route(monkeypatch):
    from rtsdr_tpu_torch.ops import _cuda

    class OnCard(torch.Tensor):
        is_cuda = property(lambda self: True)

    seen = []
    monkeypatch.setattr(_cuda, "launch",
                        lambda entry, count_as, *a: seen.append(entry))
    h = _taps("301")
    x = torch.zeros(1, 80).as_subclass(OnCard)
    zi = torch.zeros(1, 2, 300)
    rzi = torch.zeros(1, 2, 150)
    with pytest.raises(ValueError, match="shorter"):
        tres.resample_mul2_rrc(x, x, x, h, zi, RRC_H, rzi, 19, 80)
    assert seen == []
