"""PLL / NCO carrier recovery (counterpart of ``rtsdr_tpu/ops/pll.py``).

Faithful to the golden model ``fmPll``: first-order loop with an atan2
phase detector, PI loop filter (Cp=2.666, Ci=3.555, Kp=B*Cp, Ki=B^2*Ci),
and an NCO emitting cos/sin(trigArg*ncoScale + phaseAdjust).  The
recurrence is sequential per channel; parallelism is across channels.

As in the JAX package (and unlike the golden model) ``theta`` and
``phase_est`` wrap modulo 4*pi every step (a floor-mod, ``torch.remainder``)
— exact for any half-integer ``nco_scale`` — and both NCO quadratures are
carried in the state.

Output alignment: ``pll`` returns the model's ``ncoOut[0:N]`` view, i.e. the
NCO delayed by one sample: element 0 is the previous block's last NCO
sample, and ``state.nco_i/q`` is the undelayed last sample.

The per-sample Python loop here is the PLAIN VERSION of the CUDA kernel
(``ops/cuda_pll.py``); ``impl='auto'`` sends CUDA input to the kernel
(float32 or it raises) and CPU input to the loop.  ``pll_extrapolate_by``
/ ``pll_extrapolate`` advance a locked state with no input (the seeds of
the time-sharded receiver's concurrent PLL handoffs).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class PLLState(NamedTuple):
    """Block-continuity state (reference pll_state_type, src/helper.h:17-19)."""

    integrator: torch.Tensor
    phase_est: torch.Tensor   # wrapped mod 4*pi
    fb_i: torch.Tensor
    fb_q: torch.Tensor
    nco_i: torch.Tensor       # last NCO cos sample (model recovery_state[4])
    nco_q: torch.Tensor       # last NCO sin sample
    theta: torch.Tensor       # 2*pi*(freq/fs)*trigOffset, wrapped mod 4*pi


_FOUR_PI = 4.0 * math.pi
_CP, _CI = 2.666, 3.555


def pll_init(batch_shape: tuple = (), dtype=torch.float32,
             device="cuda") -> PLLState:
    """Initial state matching the model's [0, 0, 1, 0, 1, 0] convention
    (model/fmMonoBlock.py:76) plus nco_q=0.  Every leaf is its own tensor."""
    def z():
        return torch.zeros(batch_shape, dtype=dtype, device=device)

    def o():
        return torch.ones(batch_shape, dtype=dtype, device=device)

    return PLLState(integrator=z(), phase_est=z(), fb_i=o(), fb_q=z(),
                    nco_i=o(), nco_q=z(), theta=z())


def loop_constants(freq, fs: float, nco_scale, phase_adjust, norm_bandwidth,
                   loop_div: int) -> tuple[np.ndarray, ...]:
    """(kp, ki, dtheta, scale, adjust) in float64, each a numpy array
    broadcastable to the batch shape.  ``loop_div`` scales the gains so the
    loop's bandwidth in Hz is unchanged at the decimated update rate.
    Shared by the loop below and the kernel wrapper so both round the SAME
    float64 values to the working dtype."""
    nb64 = np.asarray(norm_bandwidth, np.float64) * loop_div
    f64 = np.asarray(freq, np.float64)
    return (np.asarray(nb64 * _CP), np.asarray(nb64 * nb64 * _CI),
            np.asarray(2.0 * math.pi * f64 / fs),
            np.asarray(nco_scale, np.float64),
            np.asarray(phase_adjust, np.float64))


def pll(
    x,
    state: PLLState,
    *,
    freq,
    fs: float,
    nco_scale=1.0,
    phase_adjust=0.0,
    norm_bandwidth=0.01,
    impl: str = "auto",
    delay_output: bool = True,
    loop_div: int = 1,
) -> tuple[torch.Tensor, torch.Tensor, PLLState]:
    """Run the PLL over one block.

    Args:
      x: (..., N) real input (band-passed pilot / squared carrier); or a
        TUPLE of equal-shape tensors, treated exactly as
        ``torch.stack(x, dim=0)`` — the kernel then reads the parts directly
        instead of materializing the stacked copy.
      state: PLLState with fields shaped (...,).
      freq / norm_bandwidth / nco_scale / phase_adjust: scalars, or arrays
        broadcastable to the batch shape (differently-configured loops
        fused into one call); the derived constants are computed in float64
        on the host, then cast.
      impl: 'loop' (the plain per-sample loop, any device/dtype), 'cuda'
        (the kernel; float32 CUDA input or it raises), or 'auto' (the
        kernel for CUDA input, the loop for CPU input).
      delay_output: True (default) reproduces the golden model's
        ``ncoOut[0:N]`` mixer view — the *time-aligned* one.  False shifts
        the NCO one sample early (diagnostic only).
      loop_div: run the loop-filter recurrence only every ``loop_div``-th
        sample (1 = golden parity; 1, 2, 4 or 8).  The NCO / feedback
        angles still advance at full rate; the PI gains are scaled so the
        loop's bandwidth in Hz is unchanged.  N must be divisible by
        loop_div.

    Returns:
      nco_i, nco_q: (..., N) NCO outputs *delayed by one sample*.
      new_state.
    """
    parts = list(x) if isinstance(x, (tuple, list)) else None
    x0 = parts[0] if parts is not None else x
    if loop_div not in (1, 2, 4, 8):
        raise ValueError("loop_div must be 1, 2, 4 or 8")
    if x0.shape[-1] % loop_div:
        raise ValueError("block length must be divisible by loop_div")
    if impl == "auto":
        impl = "cuda" if x0.is_cuda else "loop"
    if impl == "cuda":
        from rtsdr_tpu_torch.ops.cuda_pll import pll_cuda

        return pll_cuda(
            x, state, freq=freq, fs=fs, nco_scale=nco_scale,
            phase_adjust=phase_adjust, norm_bandwidth=norm_bandwidth,
            delay_output=delay_output, loop_div=loop_div)
    if impl != "loop":
        raise ValueError(f"unknown pll impl {impl!r}")
    if parts is not None:
        x = torch.stack(parts, dim=0)
    return pll_loop(x, state, freq=freq, fs=fs, nco_scale=nco_scale,
                    phase_adjust=phase_adjust,
                    norm_bandwidth=norm_bandwidth,
                    delay_output=delay_output, loop_div=loop_div)


def pll_loop(x: torch.Tensor, state: PLLState, *, freq, fs: float,
             nco_scale=1.0, phase_adjust=0.0, norm_bandwidth=0.01,
             delay_output: bool = True, loop_div: int = 1):
    """The plain version: the golden model's per-sample loop, vectorized
    over the batch, with the atan2 detector taken literally — except that
    an input of exactly 0 gives error 0, as in both kernels (the literal
    atan2(-0, -0) would kick the loop by pi whenever cos of the feedback
    angle is negative).  Only the recurrence (detector, loop filter, theta
    ramp, feedback cos/sin) runs per sample; the NCO synthesis is one
    vectorized pass afterwards."""
    dtype, dev = x.dtype, x.device
    batch = x.shape[:-1]
    n = x.shape[-1]
    consts = loop_constants(freq, fs, nco_scale, phase_adjust,
                            norm_bandwidth, loop_div)
    kp, ki, dtheta, scale, adjust = (
        torch.as_tensor(np.broadcast_to(c, batch).copy(), device=dev
                        ).to(dtype) for c in consts)

    xs = x.movedim(-1, 0).contiguous()                # (N, ...)
    # x * (-fb_q) == (-x) * fb_q exactly; the zero mask as a factor
    neg_xs, nonzero = -xs, (xs != 0).to(dtype)
    args = torch.empty((n, *batch), dtype=dtype, device=dev)
    integ, phase, fb_i, fb_q, theta = (
        v.expand(batch).clone(memory_format=torch.contiguous_format)
        for v in (state.integrator, state.phase_est, state.fb_i, state.fb_q,
                  state.theta))
    # the same operations in the same order, written in place into
    # preallocated tensors (about a quarter less time per sample on the CPU)
    err_i, err_q, err, tmp = (torch.empty_like(integ) for _ in range(4))
    for k in range(n):
        if k % loop_div == 0:
            torch.mul(neg_xs[k], fb_q, out=err_q)
            torch.mul(xs[k], fb_i, out=err_i)
            torch.atan2(err_q, err_i, out=err)
            err.mul_(nonzero[k])
            integ.add_(torch.mul(ki, err, out=tmp))
            phase.add_(torch.mul(kp, err, out=tmp)).add_(integ)
            torch.remainder(phase, _FOUR_PI, out=phase)
        torch.remainder(theta.add_(dtheta), _FOUR_PI, out=theta)
        arg = torch.add(theta, phase, out=args[k])
        torch.cos(arg, out=fb_i)
        torch.sin(arg, out=fb_q)

    nco_arg = args * scale + adjust
    nco_i_new = torch.cos(nco_arg).movedim(0, -1)
    nco_q_new = torch.sin(nco_arg).movedim(0, -1)
    if delay_output:
        # Delayed-by-one view: prepend previous block's last NCO sample.
        nco_i = torch.cat([state.nco_i[..., None], nco_i_new[..., :-1]], -1)
        nco_q = torch.cat([state.nco_q[..., None], nco_q_new[..., :-1]], -1)
    else:
        nco_i, nco_q = nco_i_new.contiguous(), nco_q_new.contiguous()
    new_state = PLLState(
        integrator=integ, phase_est=phase, fb_i=fb_i, fb_q=fb_q,
        nco_i=nco_i_new[..., -1].clone(), nco_q=nco_q_new[..., -1].clone(),
        theta=theta)
    return nco_i, nco_q, new_state


def pll_extrapolate_by(state: PLLState, theta_advance, n_steps, *,
                       nco_scale=1.0, phase_adjust=0.0) -> PLLState:
    """Advance a PLL state with no input, assuming lock, by a precomputed
    ramp advance.

    In lock the detector error is ~0, so per step the loop advances
    ``theta`` by the NCO ramp ``2*pi*freq/fs`` and ``phase_est`` by the
    integrator; the feedback and NCO samples are recomputed from the
    extrapolated angles exactly as the loop would.

    ``theta_advance`` is ``(n_steps * dtheta) mod 4*pi``, computed on the
    host in float64 so that extrapolation adds no trig-argument drift.
    ``theta_advance``, ``n_steps``, ``nco_scale`` and ``phase_adjust`` may
    be numpy arrays broadcastable against the state's batch shape (the
    time-sharded receiver extrapolates each shard by its own offset, and
    two differently configured loops, in one call); the result has the
    broadcast shape.  They may also be tensors on the state's device, made
    once (with the same float64 -> dtype rounding), so that a captured
    step copies nothing from the host.
    """
    leaf = state.phase_est
    dtype, dev = leaf.dtype, leaf.device

    def const(v):
        if isinstance(v, torch.Tensor):   # made on the device beforehand
            return v.to(dtype=dtype, device=dev)
        return torch.as_tensor(np.asarray(v, np.float64)).to(dtype).to(dev)

    theta = torch.remainder(state.theta + const(theta_advance), _FOUR_PI)
    phase = torch.remainder(state.phase_est
                            + const(n_steps) * state.integrator, _FOUR_PI)
    arg = theta + phase
    nco_arg = arg * const(nco_scale) + const(phase_adjust)
    shape = arg.shape
    return PLLState(integrator=state.integrator.expand(shape).contiguous(),
                    phase_est=phase, fb_i=torch.cos(arg), fb_q=torch.sin(arg),
                    nco_i=torch.cos(nco_arg), nco_q=torch.sin(nco_arg),
                    theta=theta)


def pll_extrapolate(state: PLLState, n_steps: int, *, freq, fs: float,
                    nco_scale=1.0, phase_adjust=0.0) -> PLLState:
    """Advance a PLL state ``n_steps`` samples with no input, assuming
    lock (the float64 ramp advance computed here; see
    ``pll_extrapolate_by``)."""
    dth = np.mod(2.0 * np.pi * np.float64(freq) / np.float64(fs)
                 * np.float64(n_steps), 2.0 * _FOUR_PI) % _FOUR_PI
    return pll_extrapolate_by(state, dth, float(n_steps),
                              nco_scale=nco_scale, phase_adjust=phase_adjust)
