"""``rtsdr_tpu_torch.ops.demod`` against ``rtsdr_tpu.ops.demod``: float64
at 1e-12, float32 at 2e-6 * max|ref| (atan2 of the two libraries differs by
an ulp or two on (-pi, pi]), across three block seams.

The float32 input is a constant-envelope FM signal, as a receiver sees: on
near-zero I/Q the angle is ill-conditioned and any two float32 atan2
implementations part."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsdr_tpu.ops import demod as jdemod
from rtsdr_tpu_torch.ops import demod as tdemod

torch.set_num_threads(1)

DT = {"f32": (np.float32, jnp.float32, torch.float32),
      "f64": (np.float64, jnp.float64, torch.float64)}


def _iq(rng, batch, n, nd):
    dphi = rng.uniform(-2.0, 2.0, (*batch, n))
    ph = np.cumsum(dphi, axis=-1) + rng.uniform(0, 6, (*batch, 1))
    amp = 0.78 + 0.05 * rng.standard_normal((*batch, n))
    return (amp * np.cos(ph)).astype(nd), (amp * np.sin(ph)).astype(nd)


def test_demod_init():
    for batch in ((), (4,)):
        ti, tq = tdemod.demod_init(batch, torch.float32, device="cpu")
        ji, jq = jdemod.demod_init(batch, jnp.float32)
        assert np.array_equal(ti.numpy(), np.asarray(ji))
        assert np.array_equal(tq.numpy(), np.asarray(jq))


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("fn", ["fm_discriminator", "fm_discriminator_linear"])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_discriminators_with_seams(rng, prec, fn, batch):
    nd, jd, td = DT[prec]
    i, q = _iq(rng, batch, 4 * 500, nd)
    ts = tdemod.demod_init(batch, td, device="cpu")
    js = jdemod.demod_init(batch, jd)
    for b in range(4):       # three seams
        sl = slice(b * 500, (b + 1) * 500)
        tf, ts = getattr(tdemod, fn)(torch.as_tensor(i[..., sl].copy()),
                                     torch.as_tensor(q[..., sl].copy()), ts)
        jf, js = getattr(jdemod, fn)(jnp.asarray(i[..., sl]),
                                     jnp.asarray(q[..., sl]), js)
        jf = np.asarray(jf)
        assert tf.numpy().dtype == jf.dtype
        tol = (1e-12 if prec == "f64"
               else 2e-6 * float(np.max(np.abs(jf))))
        np.testing.assert_allclose(tf.numpy(), jf, rtol=0, atol=tol)
        for a, c in zip(ts, js):
            assert np.array_equal(a.numpy(), np.asarray(c))
