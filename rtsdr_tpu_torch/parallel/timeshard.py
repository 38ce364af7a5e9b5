"""Time-block sharded receiver: one block split into T chunks side by side.

Counterpart of ``rtsdr_tpu/parallel/timeshard.py``.  Every FIR's and
resampler's carried state is the last ``taps-1`` input samples, so chunk
t's state is chunk t-1's input tail (a halo exchange); the discriminator's
one-sample state is the same pattern; the PLL recurrence either pipelines
its state chunk to chunk (``'exact'``) or runs all chunks at once from
extrapolated seeds (``'stale'``, ``'iterate'``); the RDS bit layer runs
once on the gathered 57 kS/s stream.

JAX runs each time shard on its own device of the mesh's ``t`` axis.  The
port has two routes, chosen by the mesh (``parallel/mesh.py``), and one
body of stage code that both call: each stage's local work goes through
the axis's ``map`` and each collective of the time axis through its other
methods.

* The stacked route (``_TimeAxis``) keeps the T chunks of one channel
  shard on that shard's device, stacked along a leading dimension; each
  collective becomes a tensor operation on that dimension:

  =====================  =============================================
  JAX                    here
  =====================  =============================================
  ``axis_index``         the position along the stacked dimension
  ``ppermute`` right     shift by one shard (``halo``: shard 0 takes the
                         carried value in the same copy)
  ``where(t == 0, ..)``  shard 0 takes the carried value (``first_or``)
  ``psum(where(last))``  shard T-1
  ``psum``               sum over the stacked dimension
  ``all_gather(tiled)``  the stacked dimension folded into time
  =====================  =============================================

  The kernels see the stacked (T*C, N/T) rows in one launch each; the
  ingest kernel and the RDS mixer + resampler read each chunk's left halo
  in place (their segmented forms).  The two PLL loops (stereo pilot, RDS
  carrier) run as one launch, as in the serial receiver: ``'exact'``
  launches T times, chunk after chunk, C lanes each; ``'stale'`` once over
  T*C lanes; ``'iterate'`` twice.

* The spread route (``_SpreadAxis``) steps each time shard at its own
  device and CUDA stream and moves each halo, PLL handoff and gathered
  value between them after an event of the stream that made it
  (``utils/shards.py::move``).  Every stage launches once per shard; the
  ingest kernel's carried zi is the left neighbour's last t1 raw I/Q pairs,
  the mixer + resampler's its zero-stuffed mixed tail; ``'exact'`` chains
  T PLL launches, ``'stale'`` makes T independent ones, ``'iterate'`` 2T.
  The carried state and the outputs stay on the channel shard's first
  device in the serial layout, so a state resumes in either route.  With
  every shard of a row on one GPU the step compiles to one CUDA graph:
  each hand-over's event forks a shard's stream from the capturing one,
  and ``join`` brings every shard's stream back before the capture ends.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rtsdr_tpu_torch.config import ReceiverConfig
from rtsdr_tpu_torch.device import require_kernel_dtype
from rtsdr_tpu_torch.ops import coeffs
from rtsdr_tpu_torch.ops.cuda_fir import fir_bank_carried, fir_block_pre
from rtsdr_tpu_torch.ops.cuda_pll import stacked_state
from rtsdr_tpu_torch.ops.cuda_resample import (
    resample_mul2,
    resample_mul2_tail,
)
from rtsdr_tpu_torch.ops.demod import fm_discriminator
from rtsdr_tpu_torch.ops.fir import (
    _upsampled_tail_of,
    fir_block,
    fir_block_bank,
    fir_decimate,
    fir_resample,
)
from rtsdr_tpu_torch.ops.iir import deemphasize
from rtsdr_tpu_torch.ops.ingestfir import (
    ingest_fir_decimate,
    normalize_deinterleave,
)
from rtsdr_tpu_torch.ops.pll import PLLState, pll, pll_extrapolate_by
from rtsdr_tpu_torch.parallel.channels import shard_rows
from rtsdr_tpu_torch.parallel.mesh import (
    CHANNEL_AXIS,
    TIME_AXIS,
    Mesh,
    row_split,
)
from rtsdr_tpu_torch.pipeline.audio import AudioState, audio_lpf_taps
from rtsdr_tpu_torch.pipeline.frame import make_frame
from rtsdr_tpu_torch.pipeline.frontend import FrontendState, rf_lpf_taps
from rtsdr_tpu_torch.pipeline.rds import RDSState, composed_resampler_taps
from rtsdr_tpu_torch.pipeline.receiver import (
    ReceiverOutputs,
    ReceiverState,
    make_receiver,
)
from rtsdr_tpu_torch.utils.shards import (
    caller_place,
    move,
    on_place,
    record,
    time_shard_places,
)


class _TimeAxis:
    """The stacked route: the collectives of the time axis over T chunks
    stacked along ``dim`` (0 unless said) on the channel shard's device.
    A stage's local work runs once over the stacked chunks (``map``)."""

    stacked = True

    def __init__(self, n_shards: int):
        self.n = n_shards

    def map(self, fn, *xs):
        return fn(*xs)

    def chunks(self, raw_u8):
        """(C, B) -> the T chunks (T, C, B/T), a view."""
        return raw_u8.reshape(raw_u8.shape[0], self.n, -1).transpose(0, 1)

    def first_or(self, carried, received, dim=0):
        """Shard 0 takes ``carried`` (shaped as one shard), the others
        their ``received``."""
        return torch.cat([carried.unsqueeze(dim).to(received.dtype),
                          received.narrow(dim, 1, self.n - 1)], dim)

    def halo(self, carried, local, dim=0):
        """``first_or(carried, ppermute_right(local))`` in one copy: each
        shard gets its left neighbour's ``local``, shard 0 the carried
        state."""
        return torch.cat([carried.unsqueeze(dim).to(local.dtype),
                          local.narrow(dim, 0, self.n - 1)], dim)

    def from_last(self, x, dim=0):
        """The last shard's value (the block's new carried state)."""
        return x.select(dim, self.n - 1)

    def psum(self, x, dim=0):
        return x.sum(dim)

    def all_gather(self, x, dim=0):
        """(..T.., ..., n) -> (..., T*n): the chunks in time order."""
        x = x.movedim(dim, -2)
        return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])

    def chain(self, fn, carry, xs, out_dim=0):
        """``*ys, carry = fn([x[k] for x in xs], carry)`` chunk after chunk;
        returns the ys stacked along ``out_dim`` and the last carry."""
        outs = []
        for k in range(self.n):
            *ys, carry = fn([x[k] for x in xs], carry)
            outs.append(ys)
        return (*(torch.stack(y, out_dim) for y in zip(*outs)), carry)

    def join(self):
        pass


class _Shards(tuple):
    """The spread route's value of a stage: one tensor per time shard, each
    at its shard's place."""


def _unzip(outs):
    """Per-shard results of one structure -> that structure of ``_Shards``."""
    first = outs[0]
    if isinstance(first, (tuple, list)):
        parts = [_unzip([o[i] for o in outs]) for i in range(len(first))]
        if hasattr(first, "_fields"):
            return type(first)(*parts)
        return type(first)(parts)
    return _Shards(outs)


class _SpreadAxis:
    """The spread route: the collectives of the time axis over T shards,
    each stepping at its own ``Place`` (device and stream), where JAX runs
    each on its own chip.  A stage's value is a ``_Shards`` tuple; the
    carried state and the gathered outputs live at ``home``, the caller's
    stream on the channel shard's first device.  Every hand-over is a
    ``move``: the reader's stream waits on an event of the maker's, then
    copies or holds the value.

      =====================  =============================================
      JAX                    here
      =====================  =============================================
      ``ppermute`` right     shard t-1's value moved to shard t (``halo``;
                             shard 0 takes the carried value from home)
      ``where(t == 0, ..)``  shard 0 takes the carried value (``first_or``)
      ``psum(where(last))``  shard T-1's value moved home (``from_last``)
      ``psum``               each shard's value moved home, summed there
      ``all_gather(tiled)``  each shard's value moved home, concatenated
      =====================  =============================================
    """

    stacked = False

    def __init__(self, places, home):
        self.places, self.home, self.n = places, home, len(places)

    def _take(self, x, t):
        """Shard t's part of a stage's argument: its own value, a value at
        home moved to it, a structure of either, or a constant."""
        if isinstance(x, _Shards):
            return x[t]
        if isinstance(x, torch.Tensor):
            return move(x, self.home, self.places[t])
        if isinstance(x, (tuple, list)):
            parts = [self._take(v, t) for v in x]
            return type(x)(*parts) if hasattr(x, "_fields") else type(x)(parts)
        return x

    def map(self, fn, *xs):
        """``fn`` on every shard's arguments, at that shard's place."""
        outs = []
        for t, place in enumerate(self.places):
            args = [self._take(x, t) for x in xs]
            with on_place(place):
                outs.append(fn(*args))
        return _unzip(outs)

    def chunks(self, raw_u8):
        """(C, B) at home -> shard t's (C, B/T), contiguous at its place."""
        n = raw_u8.shape[-1] // self.n
        return self.map(lambda r: r.contiguous(), _Shards(
            move(raw_u8[:, t * n:(t + 1) * n], self.home, place)
            for t, place in enumerate(self.places)))

    def first_or(self, carried, received, dim=0):
        """Shard 0 takes ``carried``, shard t > 0 its part of ``received``
        (a tensor at home whose ``dim`` indexes the shards)."""
        got = [move(carried, self.home, self.places[0])]
        for t in range(1, self.n):
            got.append(move(received.select(dim, t), self.home,
                            self.places[t]))
        return self._dense(got)

    def halo(self, carried, local, dim=0, recv=None):
        """Shard t > 0 takes shard t-1's ``local`` (``recv`` of it, at
        shard t, if given), shard 0 the carried state from home."""
        if recv is None:
            carried = carried.to(local[0].dtype)
        got = [move(carried, self.home, self.places[0])]
        for t in range(1, self.n):
            x = move(local[t - 1], self.places[t - 1], self.places[t])
            if recv is not None:
                with on_place(self.places[t]):
                    x = recv(x)
            got.append(x)
        return self._dense(got)

    def _dense(self, values):
        """Each shard's value contiguous (as the stacked route's
        concatenation leaves it: what the kernels read), copied on its
        shard's stream where it is a view."""
        out = []
        for x, place in zip(values, self.places):
            with on_place(place):
                out.append(x.contiguous())
        return _Shards(out)

    def from_last(self, x, dim=0):
        return move(x[-1], self.places[-1], self.home)

    def psum(self, x, dim=0):
        """The sum over shards at home, in the stacked route's order."""
        return torch.stack([move(v, p, self.home)
                            for v, p in zip(x, self.places)], dim).sum(dim)

    def all_gather(self, x, dim=0):
        return torch.cat([move(v, p, self.home)
                          for v, p in zip(x, self.places)], -1)

    def chain(self, fn, carry, xs, out_dim=0):
        """``*ys, carry = fn([x[t] for x in xs], carry)`` at shard t after
        shard t-1, the carry moved from each to the next (from home to
        shard 0, from shard T-1 back home)."""
        outs, at = [], self.home
        for t, place in enumerate(self.places):
            carry = type(carry)(*(move(v, at, place) for v in carry))
            with on_place(place):
                *ys, carry = fn([x[t] for x in xs], carry)
            outs.append(ys)
            at = place
        carry = type(carry)(*(move(v, at, self.home) for v in carry))
        return (*(_Shards(y) for y in zip(*outs)), carry)

    def join(self):
        """Home waits for each shard's work of the step, so what the
        caller queues next follows all of it (in a capture: every shard's
        stream joins the capturing one again, as a capture must end)."""
        if self.home.stream is not None:
            for place in self.places:
                self.home.stream.wait_event(record(place))


def make_time_sharded_receiver(
    cfg: ReceiverConfig,
    mesh: Mesh,
    n_channels: int,
    dtype=torch.float32,
    *,
    enable_rds: bool | None = None,
    enable_frame: bool = True,
    offset_mode: str = "hold",
    use_abs_clock: bool = False,
    resync: bool = False,
    pll_impl: str = "auto",
    deemphasis: float | None = None,
    ingest_impl: str = "auto",
    resamp_impl: str = "auto",
    pll_handoff: str = "exact",
    pll_loop_div: int = 1,
    error_correct: bool = False,
    stereo_blend: bool | tuple = False,
    derotate: bool = False,
    jit: bool = True,
):
    """Build ``(init_fn, step_fn)`` sharded over (channel, time).

    ``step_fn(state, raw_u8)``: raw_u8 is (n_channels, block_size) uint8 (a
    host array or a tensor on any device); each channel shard's rows go to
    its device.  ``state`` is a tuple with one serial-layout
    ``ReceiverState`` per channel shard, each on its device (``init_fn``
    makes it).  Outputs are the serial receiver's ``ReceiverOutputs``
    shapes, rows in global order, on the mesh's first device (with
    ``enable_frame=False`` the RDS output is the gathered (rrc_i, rrc_q)
    pair).

    ``pll_handoff``:
      * ``'exact'``: the PLL state pipelines chunk to chunk — T dependent
        launches; the serial receiver's result.
      * ``'stale'``: every chunk runs at once, seeded from the exact carry
        of the previous block extrapolated at the locked slope across the
        chunk's own offset (``ops/pll.py::pll_extrapolate_by``); shard 0 is
        exact.  A lock-transient approximation, not bit-exact.
      * ``'iterate'``: ``'stale'`` plus one pass in which chunk k is
        re-seeded from chunk k-1's end state of the first pass.

    On a spread mesh (``mesh.spread``) each time shard steps on its own
    device and stream; state and outputs are as on a stacked one.

    ``jit`` (default True): the step is compiled with its state donated,
    as the JAX package's ``jax.jit(shard_map(...), donate_argnums=0)``
    (``utils/jit.py``: the state it returns is updated in place by the next
    call): on a mesh of one device one ``CompiledStep``, whose graph on the
    spread route holds the T branches forked onto the shards' streams and
    joined back; on a mesh over two or more devices one part per device
    (``parallel/channels.py::shard_rows``).  A mesh row spread over two or
    more distinct GPUs steps eagerly whatever ``jit`` says: its hand-overs
    are peer copies between devices, which one device's graph cannot hold.

    ``ingest_impl``: ``'fused'`` (the ingest kernel: on the stacked route
    over every chunk and its left neighbour's raw tail in place,
    ``ingest_fir_decimate(..., segments=T)``; on the spread route per shard,
    behind the neighbour's raw tail as its zi) or ``'split'``
    (normalize, then the FIR bank at stride ``decim``); ``'auto'`` is
    ``'fused'`` on a CUDA mesh and ``'split'`` on the CPU.
    """
    if enable_rds is None:
        enable_rds = cfg.rds is not None
    if enable_rds and cfg.rds is None:
        raise ValueError(f"mode {cfg.mode} has no RDS path")
    if pll_handoff not in ("exact", "stale", "iterate"):
        raise ValueError(f"unknown pll_handoff {pll_handoff!r}")
    if resamp_impl != "auto":
        raise ValueError(
            f"resamp_impl={resamp_impl!r}: the port has one route, chosen "
            "by the tensor's device ('auto')")
    blend_range = None
    if stereo_blend:
        blend_range = (0.02, 0.08) if stereo_blend is True else stereo_blend
        if not blend_range[1] > blend_range[0]:
            raise ValueError(
                f"stereo_blend thresholds need hi > lo, got {blend_range}")
    T = mesh.shape[TIME_AXIS]
    n_sh = mesh.shape[CHANNEL_AXIS]
    rows = row_split(n_channels, n_sh)
    if cfg.block_size % (2 * cfg.rf.decim * T):
        raise ValueError(f"block of {cfg.block_size} bytes does not split "
                         f"into {T} whole decimation groups")
    chunk_if = cfg.if_len // T
    if chunk_if % pll_loop_div:
        raise ValueError(f"if_len/T = {chunk_if} not divisible by "
                         f"pll_loop_div={pll_loop_div}")
    if (chunk_if * cfg.mono.up) % cfg.mono.down or (
            enable_rds and (chunk_if * cfg.rds.up) % cfg.rds.down):
        raise ValueError(f"if_len/T = {chunk_if} does not divide the "
                         "resampler grid; pick T dividing it")
    for row in mesh.time_devices:
        for dev in row:
            require_kernel_dtype(dev, dtype)
    if ingest_impl == "auto":
        ingest_impl = "fused" if mesh.devices[0].type == "cuda" else "split"
    if ingest_impl not in ("fused", "split"):
        raise ValueError(f"unknown ingest_impl {ingest_impl!r}")
    fused_ingest = ingest_impl == "fused"
    if fused_ingest and dtype != torch.float32:
        raise ValueError("fused ingest computes in float32; use 'split'")

    per = n_channels // n_sh
    serial_inits = [make_receiver(
        cfg, (per,), dtype, enable_rds=enable_rds, enable_frame=enable_frame,
        offset_mode=offset_mode, use_abs_clock=use_abs_clock,
        deemphasis=deemphasis, error_correct=error_correct,
        stereo_blend=stereo_blend, derotate=derotate, device=dev)[0]
        for dev in mesh.devices]

    # coefficients (host constants; the wrappers keep device copies)
    ax = _TimeAxis(T)
    t1 = cfg.rf.taps - 1
    rf_h = rf_lpf_taps(cfg)
    up, down = cfg.mono.up, cfg.mono.down
    mono_h = audio_lpf_taps(cfg)
    a_t1 = len(mono_h) - 1
    s_t1 = cfg.stereo.taps - 1
    bank_h = [coeffs.bandpass_taps(cfg.rf.if_fs, cfg.stereo.pilot_lo,
                                   cfg.stereo.pilot_hi, cfg.stereo.taps),
              coeffs.bandpass_taps(cfg.rf.if_fs, cfg.stereo.chan_lo,
                                   cfg.stereo.chan_hi, cfg.stereo.taps)]
    loops = [cfg.stereo.pll]
    if enable_rds:
        r = cfg.rds
        if r.taps != cfg.stereo.taps:
            raise ValueError("the RDS extract band-pass shares the stereo "
                             "band-passes' launch: equal tap counts needed")
        bank_h.append(coeffs.bandpass_taps(cfg.rf.if_fs, r.extract_lo,
                                           r.extract_hi, r.taps))
        squared_h = coeffs.bandpass_taps(cfg.rf.if_fs, r.squared_lo,
                                         r.squared_hi, r.taps)
        comb_h = composed_resampler_taps(cfg)
        rrc_h = coeffs.rrc_taps(r.rrc_fs, r.rrc_taps, r.rrc_beta,
                                r.symbol_rate)
        rrc_t1 = len(rrc_h) - 1
        loops.append(r.pll)
        frame_fn = None
        if enable_frame:
            frame_fn = make_frame(cfg, offset_mode=offset_mode,
                                  use_abs_clock=use_abs_clock, resync=resync,
                                  error_correct=error_correct,
                                  derotate=derotate)
    # the loops run as ONE launch: loop axis first, constants per loop
    n_loops = len(loops)
    loop_consts = {k: np.array([getattr(lp, k) for lp in loops])
                   for k in ("freq", "nco_scale", "phase_adjust",
                             "norm_bandwidth")}
    # stale / iterate seeds: chunk t starts t*chunk_if samples after the
    # carried state; ramp advances in float64 on the host, (loop, t, 1)
    adv_tab = np.mod(2.0 * math.pi * loop_consts["freq"][:, None]
                     / np.float64(cfg.rf.if_fs) * np.arange(T) * chunk_if,
                     4.0 * math.pi)[..., None]
    # the loop filter adds the integrator once per pll_loop_div samples
    ns_tab = (np.arange(T, dtype=np.float64) * chunk_if
              / pll_loop_div)[None, :, None]
    pll_passes = {"exact": 0, "stale": 1, "iterate": 2}[pll_handoff]

    comb_t1 = len(comb_h) - 1 if enable_rds else 0

    # the constants in the shapes the calls take, made once: the PLL
    # kernel's plans go by the arrays' identity, and the seeds' constants
    # lie on the state's device (a per-step host copy would synchronise)
    shaped_consts: dict = {}

    def consts_for(ndim):
        if ndim not in shaped_consts:
            shape = (n_loops,) + (1,) * (ndim - 1)
            shaped_consts[ndim] = {k: v.reshape(shape)
                                   for k, v in loop_consts.items()}
        return shaped_consts[ndim]

    seed_consts: dict = {}

    def seed_consts_on(leaf):
        key = (leaf.device, leaf.dtype)
        if key not in seed_consts:
            seed_consts[key] = tuple(
                torch.as_tensor(np.asarray(v, np.float64)).to(leaf.dtype)
                .to(leaf.device)
                for v in (adv_tab, ns_tab,
                          loop_consts["nco_scale"][:, None, None],
                          loop_consts["phase_adjust"][:, None, None]))
        return seed_consts[key]

    def run_pll(parts, st):
        return pll(tuple(parts), st, fs=cfg.rf.if_fs, impl=pll_impl,
                   loop_div=pll_loop_div,
                   **consts_for(st.integrator.dim()))

    def tail(n):
        return lambda x: x[..., -n:]

    def pll_chain(ax, parts, st):
        """parts: the loops' per-shard (C, n) inputs; st: PLLState (L, C).
        Returns nco_i, nco_q per shard (L, C, n; stacked: (L, T, C, n))
        and the new (L, C) state."""
        if pll_passes == 0:
            return ax.chain(run_pll, st, parts, out_dim=1)
        adv, ns, scale, adjust = seed_consts_on(st.theta)
        seed = pll_extrapolate_by(
            PLLState(*(leaf[:, None] for leaf in st)), adv, ns,
            nco_scale=scale, phase_adjust=adjust)
        start = PLLState(*(ax.first_or(a, b, 1) for a, b in zip(st, seed)))
        for p in range(pll_passes):
            nco_i, nco_q, end = ax.map(run_pll, parts, start)
            if p + 1 < pll_passes:
                start = PLLState(*(ax.halo(a, b, 1)
                                   for a, b in zip(st, end)))
        return (nco_i, nco_q,
                PLLState(*(ax.from_last(e, 1).contiguous() for e in end)))

    def ingest(ax, raw_u8, fe):
        """Raw bytes -> each shard's decimated (if_i, if_q) and the block's
        new RF zis."""
        if fused_ingest and ax.stacked:
            # one launch reads every chunk and its left neighbour's raw tail
            # in place; the carried zi adds on shard 0 only
            no_zi = torch.zeros((T, raw_u8.shape[0], t1), dtype=dtype,
                                device=fe.zi_i.device)
            if_i, if_q, zi_i, zi_q = ingest_fir_decimate(
                raw_u8, rf_h, ax.first_or(fe.zi_i, no_zi),
                ax.first_or(fe.zi_q, no_zi), cfg.rf.decim, segments=T)
            return if_i, if_q, ax.from_last(zi_i), ax.from_last(zi_q)
        chunks = ax.chunks(raw_u8)
        zi_fe = torch.stack([fe.zi_i, fe.zi_q], dim=-2)
        if fused_ingest:
            # the ingest kernel per shard: its carried zi is the left
            # neighbour's last t1 raw I/Q pairs, normalized where they land
            zi = ax.halo(zi_fe, ax.map(tail(2 * t1), chunks),
                         recv=lambda r: normalize_deinterleave(r, dtype))
            if_i, if_q, zi_i, zi_q = ax.map(
                lambda r, z: ingest_fir_decimate(
                    r, rf_h, z[..., 0, :].contiguous(),
                    z[..., 1, :].contiguous(), cfg.rf.decim), chunks, zi)
            return if_i, if_q, ax.from_last(zi_i), ax.from_last(zi_q)
        iq = ax.map(lambda r: normalize_deinterleave(r, dtype), chunks)
        iq_ds, zi_fe = ax.map(
            lambda x, z: fir_decimate(x, rf_h, z, cfg.rf.decim), iq,
            ax.halo(zi_fe, ax.map(tail(t1), iq)))
        if_i, if_q = ax.map(lambda y: (y[..., 0, :], y[..., 1, :]), iq_ds)
        zi_fe = ax.from_last(zi_fe)
        return if_i, if_q, zi_fe[..., 0, :], zi_fe[..., 1, :]

    def discriminate(i, q, prev_i, prev_q):
        fm, (pi, pq) = fm_discriminator(i, q, (prev_i, prev_q))
        return fm, pi, pq

    def last(x):
        return x[..., -1]

    @torch.no_grad()
    def shard_body(ax, state: ReceiverState, raw_u8: torch.Tensor):
        fe, au = state.frontend, state.audio

        # ---- ingest + front end
        if_i, if_q, zi_i, zi_q = ingest(ax, raw_u8, fe)
        fm, pi, pq = ax.map(discriminate, if_i, if_q,
                            ax.halo(fe.prev_i, ax.map(last, if_i)),
                            ax.halo(fe.prev_q, ax.map(last, if_q)))
        fe_state = FrontendState(
            zi_i=zi_i.contiguous(), zi_q=zi_q.contiguous(),
            prev_i=ax.from_last(pi).clone(), prev_q=ax.from_last(pq).clone())

        # ---- IF band-passes (pilot, stereo channel[, RDS extract]): one
        # launch over fm with one shared tail, as in the serial receiver
        bank, if_tail = ax.map(lambda x, z: fir_block_bank(x, bank_h, z), fm,
                               ax.halo(au.pilot_zi, ax.map(tail(s_t1), fm)))
        if_tail = ax.from_last(if_tail).contiguous()
        pilot, chan = bank[0], bank[1]
        parts = [pilot]
        if enable_rds:
            extract = bank[2]
            pre_pll, squared_zi = ax.map(
                lambda x, z: fir_block_pre(x, squared_h, z, "square"),
                extract, ax.halo(state.rds.squared_zi, ax.map(
                    lambda x: x[..., -s_t1:] * x[..., -s_t1:], extract)))
            parts.append(pre_pll)

        # ---- the PLL loops, one launch per chunk / pass
        st = stacked_state((au.pll, state.rds.pll) if enable_rds
                           else (au.pll,))
        nco_i, nco_q, st = pll_chain(ax, parts, st)
        pilot_st = PLLState(*(v[0] for v in st))
        nco = ax.map(lambda x: x[0], nco_i)

        # ---- mono + stereo
        if up == 1:
            (mono,), mono_zi = ax.map(
                lambda x, z: fir_bank_carried(x, [mono_h], z, down), fm,
                ax.halo(au.mono_zi, ax.map(tail(a_t1), fm)))
            (stereo,), stereo_zi = ax.map(
                lambda x, n, z: fir_bank_carried(x, [mono_h], z, down, x2=n,
                                                 pre="mul2"),
                chan, nco, ax.halo(au.stereo_zi, ax.map(
                    lambda x, n: 2.0 * x[..., -a_t1:] * n[..., -a_t1:],
                    chan, nco)))
            mono_zi, stereo_zi = ax.from_last(mono_zi), ax.from_last(stereo_zi)
        else:
            pair = ax.map(lambda f, x, n: torch.stack([f, 2.0 * x * n],
                                                      dim=-2), fm, chan, nco)
            pair_zi = torch.stack([au.mono_zi, au.stereo_zi], dim=-2)
            ys, zi2 = ax.map(
                lambda x, z: fir_resample(x, mono_h, z, up, down), pair,
                ax.halo(pair_zi, ax.map(
                    lambda x: _upsampled_tail_of(x, a_t1, up), pair)))
            mono, stereo = ax.map(lambda y: (y[..., 0, :], y[..., 1, :]), ys)
            zi2 = ax.from_last(zi2)
            mono_zi, stereo_zi = zi2[..., 0, :], zi2[..., 1, :]
        if blend_range is not None:
            # pilot RMS over the whole block: per-chunk power sums, summed
            lo, hi = blend_range
            p_ss = ax.psum(ax.map(
                lambda x: torch.sum(x * x, dim=-1, keepdim=True), pilot))
            p_rms = torch.sqrt(p_ss * (1.0 / cfg.if_len))
            stereo = ax.map(torch.mul, stereo, torch.clamp(
                (p_rms - lo) * (1.0 / (hi - lo)), 0.0, 1.0))
        left = ax.all_gather(ax.map(lambda m, x: 0.5 * (m + x), mono, stereo))
        right = ax.all_gather(ax.map(lambda m, x: 0.5 * (m - x), mono,
                                     stereo))
        mono = ax.all_gather(mono)
        de = None
        if deemphasis is not None:
            # the 48 kS/s IIR runs once over the gathered block
            lr, de = deemphasize(torch.stack([left, right], dim=-2), au.deemph,
                                 fs=cfg.audio_fs, tau=deemphasis)
            left, right = lr[..., 0, :], lr[..., 1, :]
        au_state = AudioState(mono_zi=mono_zi.contiguous(), pilot_zi=if_tail,
                              chan_zi=if_tail,
                              stereo_zi=stereo_zi.contiguous(),
                              pll=pilot_st, deemph=de)

        rds_state = frame_state = rds_out = None
        if enable_rds:
            if ax.stacked:
                # mixers + resampler (K6 on a CUDA tensor) over the stacked
                # chunks: each reads its left neighbour's inputs in place as
                # its halo, chunk 0 the carried zi; the new zi is the last
                # chunk's
                resamp, resamp_zi = resample_mul2(
                    extract, nco_i[1], nco_q[1], comb_h, state.rds.resamp_zi,
                    r.up, r.down, segments=T)
            else:
                # K6 per shard, its zi the left neighbour's zero-stuffed
                # mixed tail (the value the kernel writes as new_zi)
                ni, nq = ax.map(lambda a, b: (a[1], b[1]), nco_i, nco_q)
                resamp, resamp_zi = ax.map(
                    lambda e, a, b, z: resample_mul2(e, a, b, comb_h, z, r.up,
                                                     r.down),
                    extract, ni, nq, ax.halo(state.rds.resamp_zi, ax.map(
                        lambda e, a, b: resample_mul2_tail(e, a, b, comb_t1,
                                                           r.up),
                        extract, ni, nq)))
                resamp_zi = ax.from_last(resamp_zi)
            rrc, rrc_zi = ax.map(
                lambda x, z: fir_block(x, rrc_h, z), resamp,
                ax.halo(state.rds.rrc_zi, ax.map(tail(rrc_t1), resamp)))
            rds_state = RDSState(
                extract_zi=if_tail,
                squared_zi=ax.from_last(squared_zi).contiguous(),
                pll=PLLState(*(v[1] for v in st)),
                resamp_zi=resamp_zi,
                rrc_zi=ax.from_last(rrc_zi).contiguous())
            rrc = ax.all_gather(rrc)                        # (C, 2, rds_len)
            if frame_fn is not None:
                rds_out, frame_state = frame_fn(state.frame, rrc[..., 0, :],
                                                rrc[..., 1, :])
            else:
                rds_out = (rrc[..., 0, :], rrc[..., 1, :])
        ax.join()
        new_state = ReceiverState(frontend=fe_state, audio=au_state,
                                  rds=rds_state, frame=frame_state)
        return new_state, ReceiverOutputs(left=left, right=right, mono=mono,
                                          rds=rds_out)

    if mesh.spread:
        # one stream per (channel shard, time shard), made once
        rows_places = [time_shard_places(row) for row in mesh.time_devices]
        bodies = [
            lambda st, raw, places=places: shard_body(
                _SpreadAxis(places, caller_place(raw.device)), st, raw)
            for places in rows_places]
    else:
        bodies = [lambda st, raw: shard_body(ax, st, raw)] * n_sh

    # a row spread over distinct GPUs steps eagerly (see the docstring)
    rows_on_one_device = all(len(set(row)) == 1 for row in mesh.time_devices)
    return shard_rows(
        serial_inits, bodies, rows, mesh.devices, jit and rows_on_one_device,
        f"time-sharded receiver ({n_sh} x {T} shards, {pll_handoff}, "
        f"{'spread' if mesh.spread else 'stacked'})")
