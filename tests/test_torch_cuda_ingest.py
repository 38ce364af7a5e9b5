"""CPU rehearsal of the fused-ingest kernel's plan (``csrc/ingest.cu``, K1).

The kernel runs only on a card, so what it computes is re-derived here in
numpy, index for index, and held against the plain versions
(``ingest_fir_*_ref``) at the tolerances ``chip_smoke.py`` holds the kernel
to on the card: I/Q 3e-6, fm 5e-6 rad, audio and bank 2e-6 * max|ref|,
carried state 1e-6.

The plan: one block per (row, tile).  A tile owns ``tile`` IF outputs and
computes ``4 * threads`` IF slots that start ``halo`` before them (the
audio stage's look-back).  The raw window is staged as bytes, then split
into ``decim`` polyphase planes of I and of Q, converted once and with the
carried ``zi`` added where the window reaches before the block:

    plane_phi[s] = x[decim * (mlo - q_pad + 1 + s) - phi]

and the RF low-pass of slot o is

    y[mlo + o] = sum_phi sum_u g_phi[u] * plane_phi[o + u],
    g_phi[u] = h[decim * (q_pad - 1 - u) + phi]    (0 past the taps),

summed phi ascending, u ascending, one fused multiply-add each (each thread
makes 4 consecutive slots from a sliding 8-sample register window).  The fm
of every slot goes to ``down`` polyphase planes of its own; the audio
low-pass sums each phase on its own (u ascending) and then adds the phase
sums, phase by phase.  The bank stage (stride 1) sums its taps in the
plain version's order.

Fused multiply-adds are emulated in float64 (the product of two float32
values is exact there) and rounded to float32 once per step.
"""

import numpy as np
import pytest
import torch

from rtsdr_tpu_torch.config import MODE0, MODE1
from rtsdr_tpu_torch.ops import coeffs
from rtsdr_tpu_torch.ops import ingestfir as ting
from rtsdr_tpu_torch.pipeline.audio import audio_lpf_taps
from rtsdr_tpu_torch.pipeline.frontend import rf_lpf_taps
from rtsdr_tpu_torch.utils.signals import fm_multiplex_iq

torch.set_num_threads(1)

IQ, FM, FM_AUDIO, FM_AUDIO_BANK = range(4)
RF_H = np.asarray(rf_lpf_taps(MODE0), np.float64)
MONO_H = np.asarray(audio_lpf_taps(MODE0), np.float64)
IF_FS = MODE0.rf.if_fs
BANK_H = [np.asarray(coeffs.bandpass_taps(IF_FS, lo, hi, 151), np.float64)
          for lo, hi in ((18.5e3, 19.5e3), (22e3, 54e3), (54e3, 60e3))]
DECIM, DOWN = MODE0.rf.decim, MODE0.mono.down
N_SM = 132
SMEM_TWO_BLOCKS = 113 * 1024     # what two blocks of an SM may each have


def _r4(n):
    return -(-n // 4) * 4


def plan_constants(taps, decim, ataps, down, mode):
    """(q_pad, aq_pad, halo, quantum): taps per RF / audio phase filter
    (multiples of 4), the IF slots computed before a tile's first output,
    what a tile's output count is a multiple of."""
    q_pad = _r4(-(-taps // decim))
    if mode < FM_AUDIO:
        return q_pad, 0, 4 * (mode == FM), 4
    aq_pad = _r4(-(-ataps // down))
    return q_pad, aq_pad, _r4(down * aq_pad), 4 * down


def shared_bytes(threads, taps, decim, ataps, down, mode, n_bank=0,
                 btaps=0):
    """The kernel's dynamic shared memory for a block of ``threads``: the
    phase taps and the RF planes (the IF slots, the audio planes and their
    partial sums reuse the planes' memory once the RF stage has read it)."""
    q_pad, aq_pad, _, _ = plan_constants(taps, decim, ataps, down, mode)
    ps = 4 * threads + q_pad                      # floats per RF plane
    tap_floats = decim * q_pad + (down * aq_pad if mode >= FM_AUDIO else 0)
    tap_floats += _r4(3 * btaps) if mode == FM_AUDIO_BANK else 0
    return 4 * (tap_floats + 2 * decim * ps)


def geometry(c, m_if, mode, taps=151, decim=DECIM, ataps=151, down=DOWN,
             btaps=0, n_sm=N_SM):
    """The (threads, tile) that ``rtsdr_ingest_*`` picks: the widest block
    that still gives two blocks per SM, else the narrowest that holds a
    tile."""
    _, _, halo, quantum = plan_constants(taps, decim, ataps, down, mode)
    pick = None
    for threads in (256, 128, 64, 32):
        tile = (4 * threads - halo) // quantum * quantum
        if tile < quantum:
            continue
        pick = (threads, tile)
        if (c * -(-m_if // tile) >= 2 * n_sm
                and shared_bytes(threads, taps, decim, ataps, down, mode,
                                 btaps=btaps) <= SMEM_TWO_BLOCKS):
            break
    return pick


def _fma(a, b, acc):
    return (np.float64(a) * b.astype(np.float64) + acc).astype(np.float32)


def rehearse(raw, h, zi_i, zi_q, decim, mode, threads, tile, prev=None,
             audio_h=None, audio_zi=None, down=1, bank_h=None, bank_zi=None,
             n_seg=1):
    """What the kernel writes, block by block, for rows of ``raw`` (C / n_seg
    source rows of n_seg segments in the iq mode)."""
    h = np.asarray(h, np.float64).astype(np.float32)
    taps, t1 = len(h), len(h) - 1
    ataps = len(audio_h) if audio_h is not None else 1
    at1 = ataps - 1
    q_pad, aq_pad, halo, _ = plan_constants(taps, decim, ataps, down, mode)
    n_src, row_bytes = raw.shape[0], raw.shape[1] // n_seg
    n_ch, n_pairs = n_src * n_seg, row_bytes // 2
    m_if = n_pairs // decim
    slots = 4 * threads
    ps = slots + q_pad
    g = np.zeros((decim, q_pad), np.float32)      # reversed phase taps
    for phi in range(decim):
        for u in range(q_pad):
            k = decim * (q_pad - 1 - u) + phi
            g[phi, u] = h[k] if k < taps else 0.0
    if mode >= FM_AUDIO:
        ah = np.asarray(audio_h, np.float64).astype(np.float32)
        ga = np.zeros((down, aq_pad), np.float32)
        for psi in range(down):
            for u in range(aq_pad):
                k = down * (aq_pad - 1 - u) + psi
                ga[psi, u] = ah[k] if k < ataps else 0.0
        n_audio = m_if // down
        audio = np.full((n_ch, n_audio), np.nan, np.float32)
    out_i = np.full((n_ch, m_if), np.nan, np.float32)
    out_q = np.full((n_ch, m_if), np.nan, np.float32)
    fm = np.full((n_ch, m_if), np.nan, np.float32)
    n_bank = len(bank_h) if bank_h is not None else 0
    bank = np.full((n_bank, n_ch, m_if), np.nan, np.float32)
    seg = np.arange(n_ch) // n_src
    src = np.arange(n_ch) % n_src
    o = np.arange(slots)
    for t0 in range(0, m_if, tile):
        own = min(tile, m_if - t0)
        mlo = t0 - halo
        # planes: pair index i of the segment, bytes 2i, 2i+1; the bytes
        # before the segment in its raw row are real, before the row the
        # zero level (128); zi adds where -t1 <= i < 0
        i = (decim * (mlo - q_pad + 1 + np.arange(ps))[None, :]
             - np.arange(decim)[:, None])                       # (decim, ps)
        planes = []
        for b in (0, 1):
            byte = 2 * i + b                                    # in segment
            gb = seg[:, None, None] * row_bytes + byte[None]    # in raw row
            ok = (byte[None] >= -seg[:, None, None] * row_bytes) & \
                 (byte[None] < row_bytes)
            v = np.where(ok, raw[src[:, None, None],
                                 np.clip(gb, 0, raw.shape[1] - 1)], 128)
            v = ((v.astype(np.float32) - 128.0) / 128.0).astype(np.float32)
            zi = zi_i if b == 0 else zi_q
            back = (i >= -t1) & (i < 0)
            v = np.where(back[None],
                         v + zi[:, np.clip(t1 + i, 0, t1 - 1)], v)
            planes.append(v.astype(np.float32))                 # (C, d, ps)
        # RF low-pass: phi ascending, u ascending
        acc = [np.zeros((n_ch, slots), np.float32) for _ in (0, 1)]
        for phi in range(decim):
            for u in range(q_pad):
                for b in (0, 1):
                    acc[b] = _fma(g[phi, u], planes[b][:, phi, o + u], acc[b])
        m = mlo + o
        if mode == IQ:
            keep = (m >= t0) & (m < t0 + own)
            out_i[:, m[keep]] = acc[0][:, keep]
            out_q[:, m[keep]] = acc[1][:, keep]
            continue
        si, sq = acc
        si[:, m < 0], sq[:, m < 0] = 0.0, 0.0
        if mlo < 0:                 # slot of IF sample -1: the carried one
            si[:, -1 - mlo], sq[:, -1 - mlo] = prev[0], prev[1]
        # discriminator, slot r from slots r and r-1
        r = np.arange(1, halo + own)
        j = mlo + r
        f = np.arctan2(sq[:, r] * si[:, r - 1] - si[:, r] * sq[:, r - 1],
                       si[:, r] * si[:, r - 1] + sq[:, r] * sq[:, r - 1]
                       ).astype(np.float32)
        before = j < 0
        if at1:
            f[:, before] = np.where(
                j[before] >= -at1,
                audio_zi[:, np.clip(at1 + j[before], 0, at1 - 1)], 0.0)
        else:
            f[:, before] = 0.0
        sf = np.zeros((n_ch, slots), np.float32)
        sf[:, r] = f
        fm[:, j[j >= t0]] = f[:, j >= t0]
        if mode == FM:
            continue
        # audio planes: fm of slot r to plane psi, index s
        e = halo - down * aq_pad
        aps = _r4(slots // down + aq_pad + 4)
        ap = np.zeros((n_ch, down, aps), np.float32)
        jp = r - e - down
        put = jp + down - 1 >= 0
        s_ = (jp[put] + down - 1) // down
        psi = down * s_ - jp[put]
        ap[:, psi, s_] = f[:, put]
        # a partial sum per phase (u ascending), then the partials added
        # phase by phase
        a0, n_a = t0 // down, own // down
        al = np.arange(_r4(n_a))
        aacc = None
        for p_ in range(down):
            part = np.zeros((n_ch, len(al)), np.float32)
            for u in range(aq_pad):
                part = _fma(ga[p_, u], ap[:, p_, al + u], part)
            aacc = part if aacc is None else (aacc + part).astype(np.float32)
        audio[:, a0:a0 + n_a] = aacc[:, :n_a]
        if mode == FM_AUDIO_BANK:
            bt1 = len(bank_h[0]) - 1
            hb = np.stack(bank_h).astype(np.float32)
            for oo in range(own):
                mm = t0 + oo
                for f_ in range(n_bank):
                    a = np.zeros(n_ch, np.float32)
                    for k in range(bt1 + 1):
                        xv = (sf[:, halo + oo - k] if k <= mm
                              else bank_zi[:, mm + bt1 - k])
                        a = _fma(hb[f_, k], xv, a)
                    bank[f_, :, mm] = a
    if mode == IQ:
        return out_i, out_q
    if mode == FM:
        return (fm,)
    return (fm, audio) + ((tuple(bank),) if n_bank else ())


def _fm_bytes(rng, c, n_pairs, noise=8):
    """(c, 2*n_pairs) uint8 of the stations the card's cases see: 16
    distinct synthetic stereo stations (``fm_multiplex_iq``), tiled, every
    row but row 0 under its own +-``noise`` LSB of uniform noise."""
    stations = [fm_multiplex_iq(n_pairs, mono_hz=700.0 + 130.0 * k,
                                stereo_hz=1500.0 + 210.0 * k,
                                pilot_phase=0.37 * k).astype(np.int16)
                for k in range(min(c, 16))]
    raw = np.stack([stations[k % 16] for k in range(c)])
    raw[1:] += rng.integers(-noise, noise + 1, raw[1:].shape,
                            dtype=np.int16)
    return np.clip(raw, 0, 255).astype(np.uint8)


def _state(rng, c, t1=150, at1=150):
    f = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    return dict(zi_i=f(c, t1), zi_q=f(c, t1), prev_i=f(c) + 0.7,
                prev_q=f(c), azi=f(c, at1))


def _second_block(rng, c, n_pairs):
    """Block 1 of the stations, with the state the plain version leaves
    after block 0 (a mid-stream state, as the receiver has it)."""
    raw = _fm_bytes(rng, c, 2 * n_pairs)
    z = lambda *s: torch.zeros(s)
    out = ting.ingest_fir_demod_audio_ref(
        torch.as_tensor(raw[:, :2 * n_pairs].copy()), RF_H, z(c, 150),
        z(c, 150), torch.ones(c), z(c), DECIM, MONO_H, z(c, 150), DOWN)
    keys = ("zi_i", "zi_q", "prev_i", "prev_q", "azi")
    return raw[:, 2 * n_pairs:].copy(), dict(
        zip(keys, (t.numpy() for t in out[2:7])))


def _close(got, want, atol):
    want = want.numpy() if isinstance(want, torch.Tensor) else want
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("c,n_pairs,segments", [
    (2, 153600 // 8, None),      # MODE0's decimation, a ragged last tile
    (1, 7000, None),             # C = 1 geometry
    (1024, 2600, None),          # C = 1,024 geometry, one ragged tile
    (2, 4 * 4000, 4),            # segmented: 4 segments read in place
    (3, 2 * 160, 2)])            # segments barely longer than the tail
def test_iq_plan_equals_plain(c, n_pairs, segments):
    rng = np.random.default_rng(11 + c + n_pairs)
    raw = rng.integers(0, 256, (c, 2 * n_pairs), dtype=np.uint8)
    n_seg = segments or 1
    rows = c * n_seg
    s = _state(rng, rows)
    m_if = n_pairs // n_seg // DECIM
    th, tile = geometry(rows, m_if, IQ)
    yi, yq = rehearse(raw, RF_H, s["zi_i"], s["zi_q"], DECIM, IQ, th, tile,
                      n_seg=n_seg)
    lead = (segments,) if segments else ()
    zi_i = torch.as_tensor(s["zi_i"]).reshape(*lead, c, -1)
    zi_q = torch.as_tensor(s["zi_q"]).reshape(*lead, c, -1)
    ri, rq, _, _ = ting.ingest_fir_decimate_ref(
        torch.as_tensor(raw), RF_H, zi_i, zi_q, DECIM, segments)
    _close(yi, ri.reshape(rows, -1), 3e-6)
    _close(yq, rq.reshape(rows, -1), 3e-6)


@pytest.mark.parametrize("c,n_pairs", [
    (2, MODE1.iq_len // 4),      # mode 1's decimation, a ragged last tile
    (1, 16000),
    (1024, 1240)])
def test_fm_plan_equals_plain(c, n_pairs):
    rng = np.random.default_rng(5 + c)
    raw, s = _second_block(rng, c, n_pairs)
    th, tile = geometry(c, n_pairs // DECIM, FM)
    (fm,) = rehearse(raw, RF_H, s["zi_i"], s["zi_q"], DECIM, FM, th, tile,
                     prev=(s["prev_i"], s["prev_q"]))
    ref = ting.ingest_fir_demod_ref(
        torch.as_tensor(raw), RF_H,
        *(torch.as_tensor(s[k]) for k in ("zi_i", "zi_q", "prev_i",
                                          "prev_q")), DECIM)
    _close(fm, ref[0], 5e-6)


@pytest.mark.parametrize("c,n_pairs,bank", [
    (1, MODE0.iq_len // 4, False),   # C = 1 geometry, MODE0's rates
    (2, 6 * 8600 + 700, False),      # wide tiles forced: ragged last tile
    (2, 1700, True),                 # short block, bank entry
    (1024, 1800, False)])            # C = 1,024 geometry
def test_fm_audio_plan_equals_plain(c, n_pairs, bank):
    rng = np.random.default_rng(3 + c + n_pairs)
    raw, s = _second_block(rng, c, n_pairs)
    m_if = n_pairs // DECIM
    mode = FM_AUDIO_BANK if bank else FM_AUDIO
    th, tile = geometry(c, m_if, mode, btaps=151 if bank else 0)
    if c == 2 and not bank:
        th, tile = 256, geometry(1024, 15360, FM_AUDIO)[1]
    bzi = (rng.standard_normal((c, 150)) * 0.1).astype(np.float32)
    got = rehearse(raw, RF_H, s["zi_i"], s["zi_q"], DECIM, mode, th, tile,
                   prev=(s["prev_i"], s["prev_q"]), audio_h=MONO_H,
                   audio_zi=s["azi"], down=DOWN,
                   bank_h=BANK_H if bank else None, bank_zi=bzi)
    t = lambda a: torch.as_tensor(a)
    ref = ting.ingest_fir_demod_audio_ref(
        t(raw), RF_H, t(s["zi_i"]), t(s["zi_q"]), t(s["prev_i"]),
        t(s["prev_q"]), DECIM, MONO_H, t(s["azi"]), DOWN,
        bank_h=BANK_H if bank else None, bank_zi=t(bzi) if bank else None)
    _close(got[0], ref[0], 5e-6)
    _close(got[1], ref[1], 2e-6 * float(ref[1].abs().max()))
    if bank:
        dfm = float(np.abs(got[0] - ref[0].numpy()).max())
        for a, b, h in zip(got[2], ref[7], BANK_H):
            _close(a, b, 2e-6 * float(b.abs().max())
                   + max(dfm, 2.5e-7) * float(np.abs(h).sum()))


def test_geometry_fills_the_card():
    """Wide tiles at C >= 1,024 (the audio halo a small share of a tile);
    C = 1 spread over the card with the narrowest block that holds a tile;
    every pick within the shared memory of two blocks per SM."""
    assert geometry(1024, 15360, FM_AUDIO) == (256, 860)
    assert geometry(1024, 16000, FM) == (256, 1020)
    assert geometry(4096, 3840, IQ) == (256, 1024)
    g1 = geometry(1, 15360, FM_AUDIO)
    assert g1 == (64, 80) and -(-15360 // g1[1]) >= N_SM
    assert geometry(1, 16000, FM) == (32, 124)
    for mode in (IQ, FM, FM_AUDIO, FM_AUDIO_BANK):
        for th in (256, 128, 64):
            assert shared_bytes(th, 151, DECIM, 151, DOWN, mode,
                                btaps=151) <= SMEM_TWO_BLOCKS
    # the audio halo (160 slots: 32 taps per phase x 5) and its share
    assert plan_constants(151, DECIM, 151, DOWN, FM_AUDIO) == (16, 32, 160,
                                                              20)
    assert (1024 - 860) / 860 < 0.2
