"""FM discriminator (counterpart of ``rtsdr_tpu/ops/demod.py``).

Two variants, both branch-free and fully vectorized:

* ``fm_discriminator`` — exact phase-difference demodulator,
      dphi[k] = atan2(Q[k] I[k-1] - I[k] Q[k-1],  I[k] I[k-1] + Q[k] Q[k-1]),
  equal to the golden model's atan2 + unwrap + derivative loop.

* ``fm_discriminator_linear`` — the derivative approximation
      (I dQ - Q dI) / (I^2 + Q^2).

State is the previous block's last (I, Q) pair.
"""

from __future__ import annotations

import torch


def demod_init(batch_shape: tuple = (), dtype=torch.float32, device="cuda"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Initial state: previous (I, Q) = (1, 0), i.e. previous phase = 0,
    matching the golden model's ``prev_phase=0`` default."""
    return (torch.ones(batch_shape, dtype=dtype, device=device),
            torch.zeros(batch_shape, dtype=dtype, device=device))


def _shift_prev(x: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    return torch.cat([x0[..., None], x[..., :-1]], dim=-1)


def fm_discriminator(i: torch.Tensor, q: torch.Tensor, state
                     ) -> tuple[torch.Tensor, tuple]:
    """Exact FM demodulation: wrapped phase derivative of the IQ stream.

    Args:
      i, q:  (..., N) in-phase / quadrature samples at the IF rate.
      state: (prev_i, prev_q) each (...,) — last sample of previous block.

    Returns:
      fm: (..., N) instantaneous frequency in rad/sample, in (-pi, pi].
      new state.
    """
    prev_i, prev_q = state
    ip = _shift_prev(i, prev_i)
    qp = _shift_prev(q, prev_q)
    num = q * ip - i * qp
    den = i * ip + q * qp
    fm = torch.atan2(num, den)
    return fm, (i[..., -1], q[..., -1])


def fm_discriminator_linear(i: torch.Tensor, q: torch.Tensor, state,
                            eps: float = 1e-12
                            ) -> tuple[torch.Tensor, tuple]:
    """Derivative-form discriminator (reference src/rf_module.cpp:27)."""
    prev_i, prev_q = state
    ip = _shift_prev(i, prev_i)
    qp = _shift_prev(q, prev_q)
    num = i * (q - qp) - q * (i - ip)
    den = i * i + q * q
    fm = num / (den + eps)
    return fm, (i[..., -1], q[..., -1])
