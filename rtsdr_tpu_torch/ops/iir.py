"""First-order IIR filtering as a log-depth doubling scan.

Counterpart of ``rtsdr_tpu/ops/iir.py`` (which uses
``jax.lax.associative_scan``).  The one-pole recurrence

    y[n] = b * x[n] + a * y[n-1]

has the closed form ``y[n] = sum_{k<=n} a^(n-k) * b*x[k] + a^(n+1) *
y_prev``.  The sum is built by doubling: after the pass with offset ``d``
every element holds its window of ``2d`` terms (``c += a^d * shift(c,
d)``), so ``ceil(log2 N)`` vectorized passes replace the per-sample loop,
exact for any ``a`` (passes whose weight ``a^d`` has underflowed to zero
are skipped).  Block continuity carries y[-1].  Stock tensor ops on any
device: this stage has no hand-written kernel in either package.
"""

from __future__ import annotations

import math

import torch


def first_order_iir(x: torch.Tensor, b: float, a: float,
                    y_prev: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """y[n] = b*x[n] + a*y[n-1] over the last axis, batched leading dims.

    y_prev: (...,) last output of the previous block; returns (y, new y_prev).
    """
    n = x.shape[-1]
    c = b * x
    d = 1
    while d < n:
        w = a ** d
        if w == 0.0:
            break
        nxt = c.clone()
        nxt[..., d:] += w * c[..., :n - d]
        c = nxt
        d *= 2
    a_pow = torch.full((n,), a, dtype=x.dtype, device=x.device).cumprod(0)
    y = c + a_pow * y_prev[..., None]
    return y, y[..., -1]


def deemphasis_coeffs(fs: float, tau: float = 75e-6) -> tuple[float, float]:
    """Standard FM de-emphasis one-pole coefficients (matched-z transform):
    a = exp(-1/(fs*tau)), b = 1-a (unit DC gain)."""
    a = math.exp(-1.0 / (fs * tau))
    return 1.0 - a, a


def deemphasize(x: torch.Tensor, y_prev: torch.Tensor, fs: float = 48e3,
                tau: float = 75e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply FM de-emphasis to an audio block (stateful)."""
    b, a = deemphasis_coeffs(fs, tau)
    return first_order_iir(x, b, a, y_prev)
