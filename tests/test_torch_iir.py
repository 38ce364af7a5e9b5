"""``rtsdr_tpu_torch.ops.iir`` (log-depth doubling scan) against
``rtsdr_tpu.ops.iir`` (associative scan): float64 at 1e-12, float32 at
2e-6 * max|ref|, across three block seams, and against the literal
per-sample recurrence."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsdr_tpu.ops import iir as jiir
from rtsdr_tpu_torch.ops import iir as tiir

torch.set_num_threads(1)

DT = {"f32": (np.float32, jnp.float32, torch.float32),
      "f64": (np.float64, jnp.float64, torch.float64)}


def _tol(prec, ref):
    return 1e-12 if prec == "f64" else 2e-6 * float(np.max(np.abs(ref)))


def test_deemphasis_coeffs_equal():
    for fs, tau in ((48e3, 75e-6), (48e3, 50e-6), (44.1e3, 75e-6)):
        assert tiir.deemphasis_coeffs(fs, tau) == jiir.deemphasis_coeffs(fs, tau)


@pytest.mark.parametrize("prec,a", [
    ("f32", 0.7575), ("f32", 0.95), ("f32", -0.5), ("f32", 0.0),
    ("f64", 0.7575), ("f64", 0.95), ("f64", -0.5), ("f64", 0.0),
    ("f64", 0.999),   # long memory: every doubling pass contributes
])
def test_first_order_iir_matches(rng, prec, a):
    nd, jd, td = DT[prec]
    x = rng.standard_normal((2, 3, 777)).astype(nd)
    y0 = rng.standard_normal((2, 3)).astype(nd)
    ty, tl = tiir.first_order_iir(torch.as_tensor(x), 1.0 - a, a,
                                  torch.as_tensor(y0))
    jy, jl = jiir.first_order_iir(jnp.asarray(x), 1.0 - a, a, jnp.asarray(y0))
    jy = np.asarray(jy)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0, atol=_tol(prec, jy))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=_tol(prec, jy))
    if prec == "f64":        # the recurrence itself
        ref = np.empty_like(x)
        prev = y0
        for k in range(x.shape[-1]):
            prev = (1.0 - a) * x[..., k] + a * prev
            ref[..., k] = prev
        np.testing.assert_allclose(ty.numpy(), ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("tau", [75e-6, 50e-6])
def test_deemphasize_three_seams(rng, prec, tau):
    nd, jd, td = DT[prec]
    x = rng.standard_normal((2, 2, 4 * 3072)).astype(nd)
    tc = torch.zeros((2, 2), dtype=td)
    jc = jnp.zeros((2, 2), jd)
    for b in range(4):
        xb = x[..., b * 3072:(b + 1) * 3072]
        ty, tc = tiir.deemphasize(torch.as_tensor(xb.copy()), tc, 48e3, tau)
        jy, jc = jiir.deemphasize(jnp.asarray(xb), jc, 48e3, tau)
        jy = np.asarray(jy)
        np.testing.assert_allclose(ty.numpy(), jy, rtol=0,
                                   atol=_tol(prec, jy))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                                   atol=_tol(prec, jy))
