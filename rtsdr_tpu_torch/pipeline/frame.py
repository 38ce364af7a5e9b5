"""RDS bit layer: clock recovery, Manchester + differential decode, frame sync.

Counterpart of ``rtsdr_tpu/pipeline/frame.py``, following the golden model
(model/fmRDSblock.py:206-347).  Everything is fixed-shape (padded tensors +
carried counts), so one step is the same sequence of tensor ops whatever
the data; the per-block symbol/bit counts vary by +-1 with the clock offset.

Where the reference is written per channel and mapped over the batch, this
module is written **batched over leading dims**: ``frame(state, rrc_i,
rrc_q)`` takes (..., rds_len) inputs and a state whose leaves are (...,) /
(..., 27), integers as int32, flags as bool, all on the inputs' device.
The layer is stock tensor ops (``gather`` / ``unfold`` where the reference
spells a selection as a one-hot product) except the resync walk: the
reference's ``lax.scan`` over the windows, which XLA compiles into one
device loop, is one hand-written kernel here on a CUDA tensor
(``ops/cuda_sync.py``, ``csrc/sync_walk.cu``).

The 26x10 GF(2) parity multiply is one batched float32 matmul over all
window positions at once (sums <= 26: exact), followed by ``mod 2``.

Stage-by-stage golden parity notes:
  * clock recovery: block-0 offset = argmax of the first 24 RRC samples
    (signed, as the model; the C++ uses abs) -- ``use_abs_clock`` selects.
  * offset update: ``offset_mode='track'`` reproduces the model's per-block
    update (model/fmRDSblock.py:219) exactly, via the closed form
    ``24 + R - offset - 24*n_sym``.  ``'hold'`` keeps the initial offset --
    with ``R % 24 == 0`` the offset never drifts; 'hold' is the default.
  * frame sync: the model re-evaluates each block's last window as the next
    block's first window at the same global position (its carry is 27 bits,
    model/fmRDSblock.py:346); reproduced, including the resulting
    duplicate/false-positive report at seams.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from rtsdr_tpu_torch.config import ReceiverConfig
from rtsdr_tpu_torch.device import resolve_device
from rtsdr_tpu_torch.ops.cuda_sync import sync_walk

# RDS parity-check matrix H (26 x 10) over GF(2) and the four offset-word
# syndromes, from the RDS standard (as used at model/fmRDSblock.py:50 and
# src/fm_radio.cpp:477-482).  Layout: first 10 rows identity (checkword),
# last 16 rows the info-word parity contribution.
_H_LOWER = [
    [1, 0, 1, 1, 0, 1, 1, 1, 0, 0],
    [0, 1, 0, 1, 1, 0, 1, 1, 1, 0],
    [0, 0, 1, 0, 1, 1, 0, 1, 1, 1],
    [1, 0, 1, 0, 0, 0, 0, 1, 1, 1],
    [1, 1, 1, 0, 0, 1, 1, 1, 1, 1],
    [1, 1, 0, 0, 0, 1, 0, 0, 1, 1],
    [1, 1, 0, 1, 0, 1, 0, 1, 0, 1],
    [1, 1, 0, 1, 1, 1, 0, 1, 1, 0],
    [0, 1, 1, 0, 1, 1, 1, 0, 1, 1],
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 1],
    [1, 1, 1, 1, 0, 1, 1, 1, 0, 0],
    [0, 1, 1, 1, 1, 0, 1, 1, 1, 0],
    [0, 0, 1, 1, 1, 1, 0, 1, 1, 1],
    [1, 0, 1, 0, 1, 0, 0, 1, 1, 1],
    [1, 1, 1, 0, 0, 0, 1, 1, 1, 1],
    [1, 1, 0, 0, 0, 1, 1, 0, 1, 1],
]
H_MATRIX = np.concatenate([np.eye(10, dtype=np.int32),
                           np.array(_H_LOWER, dtype=np.int32)])

SYNDROMES = np.array(
    [
        [1, 1, 1, 1, 0, 1, 1, 0, 0, 0],  # A
        [1, 1, 1, 1, 0, 1, 0, 1, 0, 0],  # B
        [1, 0, 0, 1, 0, 1, 1, 1, 0, 0],  # C
        [1, 0, 0, 1, 0, 1, 1, 0, 0, 0],  # D
        [1, 1, 1, 1, 0, 0, 1, 1, 0, 0],  # C' (offset word 0b1101010000)
    ],
    dtype=np.int32,
)
SYNDROME_NAMES = ["A", "B", "C", "D", "C'"]

CARRY_BITS = 27  # model/fmRDSblock.py:346 carries position-1 onward

_BURST_SPAN = 5  # the (26,16) shortened cyclic code corrects <=5-bit bursts


def _burst_table() -> tuple[np.ndarray, np.ndarray]:
    """Syndrome -> burst-error lookup for the RDS (26,16) code.

    Every burst of span <= 5 inside the 26-bit block maps to a UNIQUE
    nonzero 10-bit syndrome under H (367 patterns, zero collisions —
    asserted here at build time), so correction is one table lookup off
    the syndrome the frame layer already computes.  The reference only
    *detects* (src/fm_radio.cpp:631-646); IEC 62106 annex B specifies
    exactly this burst-correction capability.

    Returns (corr_flag, err_info, err_span): ``corr_flag[s]`` = 1 if
    syndrome ``s`` is a correctable burst, ``err_info[s]`` = the 16 info
    bits of the error pattern (to XOR onto the received info word),
    ``err_span[s]`` = the burst's span in bits (1..5; 0 where not
    correctable).  Check-bit error bits need no repair — the payload is
    only the info word.  The span disambiguates between offset words:
    the table covers ~36% of the 10-bit syndrome space, so a genuinely
    corrupted block usually hits it for a WRONG offset too — but chance
    hits are overwhelmingly long bursts (268/367 entries have span >= 4)
    while real click/noise errors are short, so "smallest span wins,
    ties reject" keeps nearly all true repairs and almost no false ones.
    """
    pow2 = 1 << np.arange(9, -1, -1)
    corr_flag = np.zeros(1024, np.int32)
    err_info = np.zeros(1024, np.int32)
    err_span = np.zeros(1024, np.int32)
    for span in range(1, _BURST_SPAN + 1):
        for start in range(0, 26 - span + 1):
            for inter in [0] if span <= 2 else range(1 << (span - 2)):
                bits = np.zeros(26, np.int64)
                bits[start] = 1
                if span >= 2:
                    bits[start + span - 1] = 1
                for k in range(span - 2):
                    bits[start + 1 + k] = (inter >> k) & 1
                s = int(((bits @ H_MATRIX) % 2) @ pow2)
                assert s != 0 and not corr_flag[s], "burst syndromes collide"
                corr_flag[s] = 1
                err_info[s] = int(bits[:16] @ (1 << np.arange(15, -1, -1)))
                err_span[s] = span
    return corr_flag, err_info, err_span


def _gardner_ted_slope(sps: int, rrc: np.ndarray) -> float:
    """Expected Gardner TED S-curve slope (error units per sample of
    timing offset) for Manchester chips matched-filtered by ``rrc``.

    Derivation: the receiver chip stream is y(t) = sum_m c_m g(t - m*sps)
    with g = rrc (tx) convolved with rrc (rx) and Manchester chip
    correlation R(m,m)=1, R(2k,2k+1)=-1, else 0 (chips within one bit are
    always opposite; distinct bits are independent).  The detector error
    e(tau) = E[mid*(sym_n - sym_{n-1})]/E[sym^2] then has a closed form in
    g, evaluated here on the integer sample grid and differenced at
    tau=+-1; verified against brute-force simulation (the two agree to
    <1%, and 1/slope = 5.87 for the mode-0 RRC matches the round-3
    empirically-calibrated 6.0 this replaces).
    """
    g = np.convolve(rrc, rrc)
    c = len(g) // 2
    m_max = (c // sps) + 2

    def corr(t1: int, t2: int) -> float:
        s = 0.0
        for m in range(-m_max, m_max):
            tm, tn = t1 - m * sps, t2 - m * sps
            if abs(tm) <= c and abs(tn) <= c:
                s += g[c + tm] * g[c + tn]
        for k in range(-m_max // 2 - 1, m_max // 2 + 1):
            for p, q in ((2 * k, 2 * k + 1), (2 * k + 1, 2 * k)):
                tp, tq = t1 - p * sps, t2 - q * sps
                if abs(tp) <= c and abs(tq) <= c:
                    s -= g[c + tp] * g[c + tq]
        return s

    def e_of_tau(tau: int) -> float:
        num = den = 0.0
        half = sps // 2
        for n0 in (0, 1):   # chip-parity average (Manchester is period-2)
            t_sym = n0 * sps + tau
            t_prev = (n0 - 1) * sps + tau
            t_mid = n0 * sps - half + tau
            num += corr(t_mid, t_sym) - corr(t_mid, t_prev)
            den += corr(t_sym, t_sym)
        return num / den

    return (e_of_tau(1) - e_of_tau(-1)) / 2.0


def gardner_gain(cfg: ReceiverConfig) -> float:
    """Deadbeat Gardner loop gain 1/slope: one block's averaged error maps
    to the full offset correction in samples (the per-block step is then
    clipped to +-1 sample by the loop).  Replaces the round-3 magic 6.0,
    which was calibrated empirically on the synthetic multiplex — the
    derived value (5.87 for mode 0) reproduces it and now tracks the
    configured sps / RRC beta instead of silently going stale with them.
    """
    from rtsdr_tpu_torch.ops.coeffs import rrc_taps
    r = cfg.rds
    rrc = np.asarray(rrc_taps(r.rrc_fs, r.rrc_taps, r.rrc_beta,
                              r.symbol_rate), np.float64)
    return float(1.0 / _gardner_ted_slope(r.sps, rrc))




class FrameState(NamedTuple):
    offset: torch.Tensor        # int32 clock offset into the RRC block
    start_pos: torch.Tensor     # int32 0/1 Manchester phase
    lonely_bit: torch.Tensor    # float last unpaired symbol (start_pos=1)
    prebit: torch.Tensor        # int32 differential-decode carry
    first_block: torch.Tensor   # bool
    carry: torch.Tensor         # int32 (..., CARRY_BITS) frame-sync bit carry
    carry_len: torch.Tensor     # int32 (0 on the first block, then 27)
    base_pos: torch.Tensor      # int32 global position of this block's window 0
    last_position: torch.Tensor  # int32, -1 until first sync
    bad_count: torch.Tensor     # int32 consecutive false positives (resync)
    offset_frac: torch.Tensor   # float timing-loop integrator ('gardner')
    derot_phase: torch.Tensor   # float carried constellation angle (derotate)


class FrameOutputs(NamedTuple):
    n_sym: torch.Tensor         # int32
    symbols_i: torch.Tensor     # (..., S_MAX) float, padded
    symbols_q: torch.Tensor     # (..., S_MAX) float (constellation diagnostics)
    n_windows: torch.Tensor     # int32
    syndrome_id: torch.Tensor   # (..., W_MAX) int32: 0 none, 1..5 = A,B,C,D,C'
    is_sync: torch.Tensor       # (..., W_MAX) bool: accepted (26-spaced) sync
    is_false_pos: torch.Tensor  # (..., W_MAX) bool: matched but wrongly spaced
    positions: torch.Tensor     # (..., W_MAX) int32 global bit positions
    is_resync: torch.Tensor     # (..., W_MAX) bool: resync fired after this window
    info_word: torch.Tensor     # (..., W_MAX) int32: the window's 16 info
    #                             bits, MSB-first (payload for group decoding)
    corrected: torch.Tensor     # (..., W_MAX) bool: syndrome repaired by burst
    #                             correction (error_correct=True); info_word
    #                             and syndrome_id already reflect the repair


_I32 = torch.int32


def frame_init(cfg: ReceiverConfig, batch_shape: tuple = (),
               dtype=torch.float32, device="cuda") -> FrameState:
    dev = resolve_device(device)

    def full(value, dt, *tail):
        return torch.full((*batch_shape, *tail), value, dtype=dt, device=dev)

    return FrameState(
        offset=full(0, _I32),
        start_pos=full(0, _I32),
        lonely_bit=full(0, dtype),
        prebit=full(0, _I32),
        first_block=full(True, torch.bool),
        carry=full(0, _I32, CARRY_BITS),
        carry_len=full(0, _I32),
        base_pos=full(0, _I32),
        last_position=full(-1, _I32),
        bad_count=full(0, _I32),
        offset_frac=full(0, dtype),
        derot_phase=full(0, dtype),
    )


def frame_sizes(cfg: ReceiverConfig) -> tuple[int, int, int, int]:
    """(S_MAX symbols, B_MAX bits, E_MAX ext bits, W_MAX windows) per block."""
    r_len = cfg.rds_len
    s_max = r_len // cfg.rds.sps
    b_max = s_max // 2
    e_max = CARRY_BITS + b_max
    w_max = e_max - 26
    return s_max, b_max, e_max, w_max


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx] per batch element (idx (...,) integer), 0 where idx is out
    of range — what a one-hot contraction gives."""
    n = x.shape[-1]
    ok = (idx >= 0) & (idx < n)
    got = x.gather(-1, idx.clamp(0, n - 1).long()[..., None])[..., 0]
    return torch.where(ok, got, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def resolve_sync(sid, w_valid, base_pos, last_position, bad_count,
                 *, resync: bool, corr=None):
    """Resolve which syndrome matches are accepted 26-spaced syncs.

    Semantics identical to the reference's sequential walk
    (src/fm_radio.cpp:649-713): a match is accepted iff never-synced-before
    or exactly 26 bits after the last accepted sync; other matches are
    false positives.  With ``resync`` (the C++ recovery mechanism), >10
    consecutive false positives reset the anchor.

    ``corr`` (optional bool tensor): windows whose syndrome was REPAIRED by
    burst correction.  Corrected windows extend an existing 26-spaced
    chain (they are accepted only at on-chain positions, never as the
    anchor), never count as false positives, and never trip the resync
    counter.

    Without resync the recurrence has a closed form -- no sequential walk:
    acceptances within a block form ONE arithmetic chain of 26-spaced
    positions.  Entering synced (last>=0) the chain can only start at
    w_chain = last+26-base; entering unsynced it starts at the first
    match.  Position start+26k is accepted iff every chain position
    start..start+26k matched -- a cumulative-AND, i.e. cumsum of misses
    == 0.  With resync the walk is sequential in the window: on a CUDA
    tensor one launch of the walk kernel (``ops/cuda_sync.py``, K7; the
    counterpart of the reference's ``lax.scan``), which takes int32 and
    bool only and raises on anything else; on a CPU tensor its plain
    version, ``_walk_plain``.

    All arguments are batched over leading dims: per-window tensors are
    (..., W), the others (...,).  Returns (is_sync, is_false_pos,
    is_resync, new_last_position, new_bad_count).
    """
    if resync and sid.is_cuda:
        return sync_walk(sid, w_valid, base_pos, last_position, bad_count,
                         corr=corr)
    w_max = sid.shape[-1]
    dev = sid.device
    w = torch.arange(w_max, dtype=_I32, device=dev)
    last_position = last_position.to(_I32)
    bad_count = bad_count.to(_I32)
    base_pos = base_pos.to(_I32)
    if corr is None:
        corr = torch.zeros_like(w_valid)

    if not resync:
        is_match = (sid > 0) & w_valid
        full = is_match | (corr & w_valid)
        synced = last_position >= 0
        w_chain = last_position + 26 - base_pos
        # the anchor (chain start when entering unsynced) must be an
        # EXACT match -- corrected windows only continue a chain
        w_first = torch.argmax(is_match.to(torch.uint8), dim=-1).to(_I32)
        start = torch.where(synced, w_chain, w_first)
        delta = w - start[..., None]
        on_chain = (delta >= 0) & (delta % 26 == 0)
        # synced with the chain slot already behind this block: nothing
        # can be accepted.  Unsynced with no exact match: nothing can
        # anchor (argmax's 0 must not let a corrected window at w=0 start
        # a chain).
        possible = torch.where(synced, w_chain >= 0, is_match.any(-1))
        fails = on_chain & ~full
        cum_fails = torch.cumsum(fails.to(_I32), dim=-1)
        is_sync = on_chain & full & (cum_fails == 0) & possible[..., None]
        is_fp = is_match & ~is_sync
        is_resync = torch.zeros_like(is_sync)
        w_last = torch.where(is_sync, w, w.new_full((), -1)).amax(-1)
        new_last = torch.where(is_sync.any(-1), base_pos + w_last,
                               last_position)
        return is_sync, is_fp, is_resync, new_last, bad_count
    return _walk_plain(sid, w_valid, base_pos, last_position, bad_count,
                       corr)


def _walk_plain(sid, w_valid, base_pos, last_position, bad_count, corr):
    """The resync walk window by window in stock ops (W steps of batched
    ops): the plain version of the walk kernel.  Integers int32, flags
    bool, batched over leading dims as ``resolve_sync``'s."""
    zero = torch.zeros_like(bad_count)
    minus1 = torch.full_like(last_position, -1)
    last_pos, bad = last_position, bad_count
    matches = (sid > 0) & w_valid
    repairs = corr & w_valid
    reals, fps, fires = [], [], []
    for k in range(sid.shape[-1]):
        gp = base_pos + k
        on_lattice = gp - last_pos == 26
        ok = (last_pos < 0) | on_lattice
        is_match = matches[..., k]
        real = (is_match & ok) | (repairs[..., k] & (last_pos >= 0)
                                  & on_lattice)
        fp = is_match & ~ok
        last_pos = torch.where(real, gp, last_pos)
        bad = torch.where(real, zero, torch.where(fp, bad + 1, bad))
        fire = bad > 10
        last_pos = torch.where(fire, minus1, last_pos)
        bad = torch.where(fire, zero, bad)
        reals.append(real)
        fps.append(fp)
        fires.append(fire)
    return (torch.stack(reals, -1), torch.stack(fps, -1),
            torch.stack(fires, -1), last_pos, bad)


def make_frame(cfg: ReceiverConfig, offset_mode: str = "hold",
               use_abs_clock: bool = False, resync: bool = False,
               with_cprime: bool = True, error_correct: bool = False,
               derotate: bool = False):
    """Returns ``frame(state, rrc_i, rrc_q) -> (outputs, new_state)``,
    batched over leading dims (inputs (..., cfg.rds_len)).

    ``with_cprime`` (default True) also matches the C' offset word that
    real version-B groups (0B/2B/15B) transmit in block 3 (IEC 62106
    offset-word table).  The reference C++ checks only A/B/C/D, so on a
    standards-compliant signal its sync chain breaks at every version-B
    group; pass False only for strict reference-parity comparisons.
    syndrome_id 5 = C'.

    ``error_correct`` (off by default for golden parity) enables the
    (26,16) code's burst correction (<=5-bit bursts, IEC 62106 annex B): a
    non-matching window whose error syndrome hits the burst table for
    exactly ONE offset word is repaired -- its info bits are XOR-fixed and
    it extends an existing 26-spaced sync chain (never anchors one; see
    resolve_sync).  The ``corrected`` output column counts repairs.

    ``resync=True`` adds the C++'s recovery mechanism: after >10
    consecutive wrongly-spaced syndrome matches the sync anchor resets,
    letting the decoder re-acquire after a signal dropout.  Off by default
    for golden-model parity.

    ``offset_mode``: clock-recovery strategy.
      * 'hold'  -- block-0 argmax held forever; default, golden parity.
      * 'track' -- the model's per-block phase bookkeeping
                  (model/fmRDSblock.py:219); golden parity.  NOTE the
                  model's update maps phase k to 24-k (its own quirk), so
                  unless the acquired offset is 12 (or 0/24) the sampling
                  phase oscillates off-peak on alternate blocks -- keep it
                  for model-parity checks, use 'hold'/'gardner' for real
                  decoding.
      * 'argmax' -- re-estimate the offset from each block's square-law
                  envelope; self-corrects slow clock drift at the cost of
                  occasional one-symbol slips at re-estimation seams.
      * 'gardner' -- decision-directed Gardner timing loop: per block, the
                  timing error mean(mid_n * (sym_n - sym_{n-1})) drives an
                  integrator that steps the offset by at most one sample
                  per block -- tracks receiver sample-clock error.

    ``derotate`` (off by default for golden parity): estimate the
    constellation rotation per block by the BPSK squaring method --
    theta = angle(sum (sym_i + j*sym_q)^2) / 2 -- and rotate the symbols
    back onto the I axis before slicing.  The estimate's pi ambiguity is
    harmless (differential decode is polarity-invariant); the carried
    angle keeps the branch choice continuous across blocks.
    """
    if offset_mode not in ("hold", "track", "argmax", "gardner"):
        raise ValueError(f"unknown offset_mode {offset_mode!r}")
    r_len = cfg.rds_len
    sps = cfg.rds.sps
    s_max, b_max, e_max, w_max = frame_sizes(cfg)
    synds_np = SYNDROMES if with_cprime else SYNDROMES[:4]
    g_gain = gardner_gain(cfg) if offset_mode == "gardner" else 0.0
    off_int_np = (synds_np @ (1 << np.arange(9, -1, -1))).astype(np.int64)
    burst_np = _burst_table() if error_correct else None
    consts: dict = {}

    def on(dev):
        """The layer's constant tables on ``dev`` (made once per device)."""
        t = consts.get(dev)
        if t is None:
            f32 = torch.float32
            t = {
                "h": torch.as_tensor(H_MATRIX, dtype=f32, device=dev),
                "synds": torch.as_tensor(synds_np, dtype=_I32, device=dev),
                "pow16": torch.as_tensor(2.0 ** np.arange(15, -1, -1),
                                         dtype=f32, device=dev),
                "pow10": torch.as_tensor(2.0 ** np.arange(9, -1, -1),
                                         dtype=f32, device=dev),
                "off_int": torch.as_tensor(off_int_np, device=dev),
            }
            if burst_np is not None:
                t["burst"] = tuple(torch.as_tensor(a, dtype=_I32, device=dev)
                                   for a in burst_np)
            consts[dev] = t
        return t

    def same_sign(a, b):
        return ((a > 0) & (b > 0)) | ((a < 0) & (b < 0))

    def shifted(x):
        """x delayed by one along the last axis, x[0] repeated."""
        return torch.cat([x[..., :1], x[..., :-1]], dim=-1)

    @torch.no_grad()
    def frame(state: FrameState, rrc_i: torch.Tensor, rrc_q: torch.Tensor):
        dev = rrc_i.device
        batch = tuple(rrc_i.shape[:-1])
        k = on(dev)
        first = state.first_block
        first1 = first[..., None]

        def i32(x):
            return x.to(_I32)

        def ar(n):
            return torch.arange(n, dtype=_I32, device=dev)

        # ---- clock recovery (model/fmRDSblock.py:207-219) ----
        if offset_mode in ("argmax", "gardner"):
            # extension modes use the square-law timing metric over the
            # WHOLE block, folded mod sps: sum_m i^2+q^2 at each phase.
            # Rotation-invariant and averages ~150 symbols instead of one.
            e_len = (rrc_i.shape[-1] // sps) * sps
            env = (rrc_i[..., :e_len] * rrc_i[..., :e_len]
                   + rrc_q[..., :e_len] * rrc_q[..., :e_len])
            peak = env.reshape(*batch, -1, sps).sum(dim=-2)
        else:
            # golden-parity modes keep the model's one-symbol peek; the
            # signed form picks a wrong offset on any block whose first
            # symbol is negative, so use_abs_clock offers the magnitude
            first24 = rrc_i[..., :sps]
            peak = first24.abs() if use_abs_clock else first24
        offset0 = i32(torch.argmax(peak, dim=-1))
        carried_start = i32(state.start_pos)
        if offset_mode == "argmax":
            offset = offset0  # re-estimated every block
            # if the fresh estimate wrapped relative to the last block's,
            # one symbol was skipped/duplicated at the seam -- this
            # block's Manchester pairing parity is flipped
            slipped_now = (~first) & ((offset - state.offset).abs()
                                      > sps // 2)
            carried_start = torch.where(slipped_now, 1 - carried_start,
                                        carried_start)
        else:
            offset = torch.where(first, offset0, i32(state.offset))

        # symbols = rrc[offset::24].  r_len = s_max*sps exactly, so the
        # reshape (s_max, sps) holds every phase; column offset % sps is
        # the symbol stream.  Track mode can produce offset == sps (==
        # phase 0 one symbol later): fold the dropped first symbol in with
        # a validity mask.
        phases_i = rrc_i.reshape(*batch, s_max, sps)
        phases_q = rrc_q.reshape(*batch, s_max, sps)

        def column(phases, col):
            idx = col.long()[..., None, None].expand(*batch, s_max, 1)
            return phases.gather(-1, idx)[..., 0]

        sym_i = column(phases_i, offset % sps)
        sym_q = column(phases_q, offset % sps)
        n_sym = i32((r_len - offset + sps - 1) // sps)
        # offset==sps: symbols start one sample-row later; shift left by one
        shift_sym = (offset >= sps)[..., None]
        sym_i = torch.where(shift_sym, torch.roll(sym_i, -1, dims=-1), sym_i)
        sym_q = torch.where(shift_sym, torch.roll(sym_q, -1, dims=-1), sym_q)
        sym_pos_valid = ar(s_max) < n_sym[..., None]
        fzero = torch.zeros((), dtype=rrc_i.dtype, device=dev)
        sym_i = torch.where(sym_pos_valid, sym_i, fzero)
        sym_q = torch.where(sym_pos_valid, sym_q, fzero)

        derot_new = state.derot_phase
        if derotate:
            # BPSK squaring estimate: sum of (i+jq)^2 over the block's
            # symbols points at 2*theta (the data sign squares away);
            # padding symbols are exact zeros and add nothing
            c2r = (sym_i * sym_i - sym_q * sym_q).sum(-1)
            c2i = (2.0 * sym_i * sym_q).sum(-1)
            th = 0.5 * torch.atan2(c2i, c2r)
            # continuity: of the pi-spaced candidates, keep the one
            # nearest the carried angle (polarity never flips mid-stream)
            adj = state.derot_phase + torch.remainder(
                th - state.derot_phase + math.pi / 2, math.pi) - math.pi / 2
            th_u = torch.where(first, th, adj)
            derot_new = torch.remainder(th_u + math.pi, 2 * math.pi) - math.pi
            c, s = torch.cos(th_u)[..., None], torch.sin(th_u)[..., None]
            sym_i, sym_q = sym_i * c + sym_q * s, sym_q * c - sym_i * s

        new_frac = state.offset_frac
        gardner_slip = None
        if offset_mode == "track":
            new_offset = i32(sps + r_len - offset - sps * n_sym)
        elif offset_mode == "gardner":
            # Gardner TED over the block: midpoints from a second phase
            # column, error normalized by symbol power, integrator steps
            # the offset at most +-1 sample per block
            half = sps // 2
            midm = column(phases_i, (offset - half) % sps)
            if derotate:
                # keep the TED coherent with the derotated symbols (a
                # raw-I midpoint shrinks by cos(theta) and dies at 90)
                midq = column(phases_q, (offset - half) % sps)
                midm = midm * c + midq * s
            # midm[j] sits between sym[j-1], sym[j] when offset >= half,
            # else between sym[j], sym[j+1] -> use previous row for pair n
            mid_n = torch.where((offset >= half)[..., None], midm,
                                shifted(midm))
            dsym = sym_i - shifted(sym_i)
            nmask = (ar(s_max) >= 1) & sym_pos_valid
            num = torch.where(nmask, dsym * mid_n, fzero).sum(-1)
            den = torch.where(sym_pos_valid, sym_i * sym_i, fzero).sum(-1)
            e = num / (den + 1e-12)
            # e > 0 <=> sampling late (mid sample past the transition
            # crossing, same sign as the symbol step) -> move earlier
            frac = state.offset_frac - g_gain * e
            step = torch.clamp(torch.round(frac), -1.0, 1.0)
            new_frac = frac - step
            new_offset = i32((offset + i32(step)) % sps)
            # an offset WRAP skips or duplicates one symbol at the next
            # block seam, which flips the Manchester pairing parity --
            # carry the flipped phase (applied to start_pos below)
            gardner_slip = (new_offset - offset).abs() > sps // 2
        else:
            new_offset = offset

        # ---- Manchester phase screening, first block only
        # (model/fmRDSblock.py:233-250) ----
        # s_max may be odd (scaled-down test geometries): the last symbol
        # then never pairs within the block (it is the lonely-bit carry),
        # so the even/odd planes cover exactly 2*b_max symbols
        pairs2_i = sym_i[..., :2 * b_max].reshape(*batch, b_max, 2)
        even, odd = pairs2_i[..., 0], pairs2_i[..., 1]

        s4 = s_max // 4
        m_mask = ar(s4) < (n_sym // 4)[..., None]
        a0 = even[..., :s4]           # sym[2m]
        a1 = odd[..., :s4]            # sym[2m+1]
        a2 = even[..., 1:s4 + 1]      # sym[2m+2]  (2m+2 <= s_max/2 < s_max)
        c0 = same_sign(a0, a1) & m_mask
        c1 = (~same_sign(a0, a1)) & same_sign(a1, a2) & m_mask
        start0 = i32(c0.sum(-1) > c1.sum(-1))
        start_pos = torch.where(first, start0, carried_start)
        start_pos_carry = (start_pos if gardner_slip is None
                           else torch.where(gardner_slip, 1 - start_pos,
                                            start_pos))

        # ---- symbol pairs -> bits (model/fmRDSblock.py:252-277) ----
        # start_pos=0: bit j = sym[2j]   > sym[2j+1]  =  even[j] > odd[j]
        # start_pos=1: bit j = sym[2j-1] > sym[2j]    =  odd[j-1] > even[j]
        #              (j=0 handled by the carried front bit)
        j = ar(b_max)
        start1 = (start_pos == 1)[..., None]
        pair_bits = torch.where(start1, i32(shifted(odd) > even),
                                i32(even > odd))
        front = i32((state.lonely_bit > sym_i[..., 0]) & ~first)
        bits = torch.where((j == 0) & start1, front[..., None], pair_bits)
        n_bits = n_sym // 2
        lonely = torch.where(start_pos == 1, _take(sym_i, n_sym - 1),
                             state.lonely_bit)

        # ---- differential decode (model/fmRDSblock.py:281-292) ----
        prev = torch.cat([i32(state.prebit)[..., None], bits[..., :-1]], -1)
        diff_all = bits ^ prev
        diff = torch.where(first1, torch.roll(diff_all, -1, dims=-1),
                           diff_all)
        n_diff = n_bits - i32(first)
        prebit_new = _take(bits, n_bits - 1)

        # ---- frame sync (model/fmRDSblock.py:296-346) ----
        # ext = [carry (carry_len) | diff (n_diff)], fixed size e_max;
        # padded bits past the valid length are ignored by the
        # w < n_windows mask.  carry_len is only ever 0 (first block) or
        # 27, so both layouts are static concats and a select.
        ext_first = torch.cat(
            [diff, torch.zeros((*batch, CARRY_BITS), dtype=_I32, device=dev)],
            -1)
        ext_later = torch.cat([i32(state.carry), diff], -1)
        ext = torch.where(first1, ext_first, ext_later)

        length = i32(state.carry_len) + n_diff
        n_windows = length - 26

        w = ar(w_max)
        # windows27[w, j] = ext[w + j].  Column 26 is not part of the
        # 26-bit syndrome window; it rides along for the 27-bit carry.
        windows27 = ext.unfold(-1, CARRY_BITS, 1)         # (..., w_max, 27)
        wf = windows27.to(torch.float32)
        # GF(2) syndrome: one matmul over every window at once, in float32
        # (sums are <= 26, so exact).
        synd = i32(torch.remainder(torch.matmul(wf[..., :26], k["h"]), 2.0))
        match = (synd[..., None, :] == k["synds"]).all(-1)  # (..., W, n_syn)
        sid = torch.where(match.any(-1),
                          i32(torch.argmax(match.to(torch.uint8), -1)) + 1,
                          torch.zeros((), dtype=_I32, device=dev))

        # 16-bit info payload per window.  The RDS standard transmits
        # [info(16, MSB first) | crc^offset(10)], so on a real capture the
        # info word is window bits 0..15.  One exact float32 matvec.
        info_word = i32(torch.matmul(wf[..., :16], k["pow16"]))

        if error_correct:
            # burst correction: error syndrome = syndrome XOR offset-word
            # syndrome; a hit in the (collision-free) burst table repairs
            # the block
            synd_int = torch.matmul(synd.to(torch.float32),
                                    k["pow10"]).long()
            e_syn = synd_int[..., None] ^ k["off_int"]          # (..., W, O)
            flag_t, errinfo_t, errspan_t = k["burst"]
            corr_ok = flag_t[e_syn]
            err_info = errinfo_t[e_syn]
            err_span = errspan_t[e_syn].to(torch.float32)
            # several offset words usually "explain" a corrupted block
            # (chance table hits); the SHORTEST burst is the credible
            # repair -- accept it only when it is strictly shortest
            # (ties reject) and the window didn't already match exactly
            cost = torch.where(corr_ok > 0, err_span,
                               err_span.new_full((), math.inf))
            best = cost.amin(-1)
            n_best = (cost == best[..., None]).sum(-1)
            corr = torch.isfinite(best) & (n_best == 1) & (sid == 0)
            o_sel = torch.argmin(cost, dim=-1)
            err_sel = err_info.gather(-1, o_sel[..., None])[..., 0]
            info_word = torch.where(corr, info_word ^ err_sel, info_word)
        else:
            corr = torch.zeros((*batch, w_max), dtype=torch.bool, device=dev)

        base_pos = i32(state.base_pos)
        positions = base_pos[..., None] + w
        w_valid = w < n_windows[..., None]

        # resolve sees exact matches (sid) and repairs (corr) separately:
        # repairs may only CONTINUE a chain; the merged id is for output
        (is_sync, is_fp, is_resync, last_position, bad_count) = resolve_sync(
            sid, w_valid, base_pos, i32(state.last_position),
            i32(state.bad_count), resync=resync, corr=corr)
        if error_correct:
            sid = torch.where(corr, i32(o_sel) + 1, sid)

        # carry = ext[n_windows-1 : n_windows-1+27]: one row of windows27
        # (zeros when that row does not exist)
        row = n_windows - 1
        row_ok = ((row >= 0) & (row < w_max))[..., None]
        idx = row.clamp(0, w_max - 1).long()[..., None, None].expand(
            *batch, 1, CARRY_BITS)
        carry_new = torch.where(row_ok, windows27.gather(-2, idx)[..., 0, :],
                                torch.zeros((), dtype=_I32, device=dev))
        base_new = base_pos + n_windows - 1

        outputs = FrameOutputs(
            n_sym=n_sym, symbols_i=sym_i, symbols_q=sym_q,
            n_windows=n_windows, syndrome_id=sid, is_sync=is_sync,
            is_false_pos=is_fp, positions=positions, is_resync=is_resync,
            info_word=info_word, corrected=corr & is_sync)
        new_state = FrameState(
            offset=new_offset, start_pos=start_pos_carry, lonely_bit=lonely,
            prebit=prebit_new, first_block=torch.zeros_like(first),
            carry=carry_new, carry_len=torch.full_like(n_windows, CARRY_BITS),
            base_pos=base_new, last_position=last_position,
            bad_count=bad_count, offset_frac=new_frac,
            derot_phase=derot_new)
        return outputs, new_state

    return frame
