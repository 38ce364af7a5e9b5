"""``rtsdr_tpu_torch.ops.fir`` (plain versions, CPU) against
``rtsdr_tpu.ops.fir`` on the same numpy inputs.

float64 at 1e-12 (both are exact sums, orders differ); float32 at
2e-6 * max|ref| (151-term float32 sums in two different orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsdr_tpu.ops import coeffs
from rtsdr_tpu.ops import fir as jfir
from rtsdr_tpu_torch.ops import fir as tfir

torch.set_num_threads(1)

LP = coeffs.lowpass_taps(240e3, 16e3, 151)
BANK = [coeffs.bandpass_taps(240e3, 18.5e3, 19.5e3, 151),
        coeffs.bandpass_taps(240e3, 22e3, 54e3, 151),
        coeffs.bandpass_taps(240e3, 54e3, 60e3, 151)]
DT = {"f32": (np.float32, jnp.float32, torch.float32),
      "f64": (np.float64, jnp.float64, torch.float64)}


def _close(t, j, prec):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape and t.dtype == j.dtype
    tol = 1e-12 if prec == "f64" else 2e-6 * float(np.max(np.abs(j))) + 1e-30
    np.testing.assert_allclose(t, j, rtol=0, atol=tol)


def _t(a, td):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=td)


@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_zi_helpers(prec):
    nd, jd, td = DT[prec]
    for tf, jf in ((tfir.fir_zi, jfir.fir_zi),
                   (tfir.resample_zi, jfir.resample_zi)):
        t = tf(151, (2, 3), td, device="cpu")
        j = jf(151, (2, 3), jd)
        assert tuple(t.shape) == j.shape == (2, 3, 150)
        assert not t.any() and t.numpy().dtype == np.asarray(j).dtype


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("batch", [(), (3,), (2, 2)])
def test_fir_block(rng, prec, batch):
    nd, jd, td = DT[prec]
    x = rng.standard_normal((*batch, 1000)).astype(nd)
    zi = rng.standard_normal((*batch, 150)).astype(nd)
    ty, tz = tfir.fir_block(_t(x, td), LP, _t(zi, td))
    jy, jz = jfir.fir_block(jnp.asarray(x), LP, jnp.asarray(zi))
    _close(ty, jy, prec)
    assert np.array_equal(np.asarray(tz), np.asarray(jz))


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("n_f", [1, 2, 3])
def test_fir_block_bank_and_multi(rng, prec, n_f):
    nd, jd, td = DT[prec]
    x = rng.standard_normal((2, 1280)).astype(nd)
    zi = rng.standard_normal((2, 150)).astype(nd)
    hs = BANK[:n_f]
    tys, tz = tfir.fir_block_bank(_t(x, td), hs, _t(zi, td))
    jys, jz = jfir.fir_block_bank(jnp.asarray(x), hs, jnp.asarray(zi))
    assert isinstance(tys, tuple) and len(tys) == len(jys) == n_f
    for ty, jy in zip(tys, jys):
        _close(ty, jy, prec)
    assert np.array_equal(np.asarray(tz), np.asarray(jz))
    tm, _ = tfir.fir_block_multi(_t(x, td), hs, _t(zi, td))
    jm, _ = jfir.fir_block_multi(jnp.asarray(x), hs, jnp.asarray(zi))
    _close(tm, jm, prec)


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("decim", [1, 5, 10])
def test_fir_decimate(rng, prec, decim):
    nd, jd, td = DT[prec]
    x = rng.standard_normal((3, 2, 1500)).astype(nd)
    zi = rng.standard_normal((3, 2, 150)).astype(nd)
    ty, tz = tfir.fir_decimate(_t(x, td), LP, _t(zi, td), decim)
    jy, jz = jfir.fir_decimate(jnp.asarray(x), LP, jnp.asarray(zi), decim)
    _close(ty, jy, prec)
    assert np.array_equal(np.asarray(tz), np.asarray(jz))


@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_fir_resample_up1(rng, prec):
    nd, jd, td = DT[prec]
    x = rng.standard_normal((2, 1500)).astype(nd)
    zi = rng.standard_normal((2, 150)).astype(nd)
    for gain in (None, 3.0):
        ty, tz = tfir.fir_resample(_t(x, td), LP, _t(zi, td), 1, 5, gain)
        jy, jz = jfir.fir_resample(jnp.asarray(x), LP, jnp.asarray(zi),
                                   1, 5, gain)
        _close(ty, jy, prec)
        assert np.array_equal(np.asarray(tz), np.asarray(jz))


def test_fir_resample_up_gt1_names_the_slice():
    """``up > 1`` is the explicit zero-stuff / filter / keep-every-down-th
    pipeline (tests/test_torch_resample.py holds it against the JAX one);
    what it refuses is a block that does not divide."""
    x = torch.ones(1, 250)
    y, zi = tfir.fir_resample(x, LP, torch.zeros(1, 150), 24, 125)
    assert y.shape == (1, 48) and zi.shape == (1, 150)
    with pytest.raises(ValueError, match="do not divide"):
        tfir.fir_resample(torch.zeros(1, 251), LP, torch.zeros(1, 150),
                          24, 125)


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("decim", [1, 5])
def test_seams_three_blocks(rng, prec, decim):
    """Four chained blocks (three seams) equal the JAX chain block by
    block, and in float64 equal one long block."""
    nd, jd, td = DT[prec]
    n = 4 * 640
    x = rng.standard_normal((2, n)).astype(nd)
    tz = tfir.fir_zi(151, (2,), td, device="cpu")
    jz = jfir.fir_zi(151, (2,), jd)
    outs = []
    for b in range(4):
        xb = x[:, b * 640:(b + 1) * 640]
        ty, tz = tfir.fir_decimate(_t(xb, td), LP, tz, decim)
        jy, jz = jfir.fir_decimate(jnp.asarray(xb), LP, jz, decim)
        _close(ty, jy, prec)
        assert np.array_equal(np.asarray(tz), np.asarray(jz))
        outs.append(ty)
    if prec == "f64":
        whole, _ = tfir.fir_decimate(
            _t(x, td), LP, tfir.fir_zi(151, (2,), td, device="cpu"), decim)
        np.testing.assert_allclose(torch.cat(outs, -1).numpy(),
                                   whole.numpy(), rtol=0, atol=1e-12)
