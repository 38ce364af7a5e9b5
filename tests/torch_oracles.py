"""Numpy/scipy golden oracles without JAX: a copy of the golden decoder of
``tests/oracles.py`` (``golden_pll``, ``golden_fm_demod``,
``golden_mono_stereo``, ``golden_rds_dsp``, ``GoldenFrameDecoder``) whose
two tables come from the port, ``rtsdr_tpu_torch.ops.coeffs.rrc_taps`` and
``rtsdr_tpu_torch.pipeline.frame.H_MATRIX``, so that it runs wherever the
port runs (beside the receiver on the card, where ``chip_smoke.py`` makes
the JAX package unimportable).  The synthesizers are the port's own,
``rtsdr_tpu_torch/utils/signals.py``, re-exported here.
``tests/test_torch_oracles.py`` holds every output equal to
``tests/oracles.py``'s.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import signal


# ---------------------------------------------------------------- PLL oracle
def golden_pll(pll_in, freq, fs, state, nco_scale=1.0, phase_adjust=0.0,
               norm_bandwidth=0.01):
    """State: [integrator, phaseEst, fbI, fbQ, ncoLast, trigOffset, ncoLastQ]."""
    cp, ci = 2.666, 3.555
    kp = norm_bandwidth * cp
    ki = norm_bandwidth * norm_bandwidth * ci

    n = len(pll_in)
    nco = np.empty(n + 1)
    nco_q = np.empty(n + 1)
    integrator, phase_est, fb_i, fb_q, nco_last, trig_offset, nco_last_q = state
    nco[0] = nco_last
    nco_q[0] = nco_last_q

    for k in range(n):
        error_i = pll_in[k] * (+fb_i)
        error_q = pll_in[k] * (-fb_q)
        error_d = math.atan2(error_q, error_i)
        integrator += ki * error_d
        phase_est += kp * error_d + integrator
        trig_arg = 2 * math.pi * (freq / fs) * (trig_offset + k + 1) + phase_est
        fb_i = math.cos(trig_arg)
        fb_q = math.sin(trig_arg)
        nco[k + 1] = math.cos(trig_arg * nco_scale + phase_adjust)
        nco_q[k + 1] = math.sin(trig_arg * nco_scale + phase_adjust)

    state = [integrator, phase_est, fb_i, fb_q, nco[-1], trig_offset + n,
             nco_q[-1]]
    return nco, nco_q, state


def pll_init_state():
    return [0.0, 0.0, 1.0, 0.0, 1.0, 0.0, 0.0]


# ----------------------------------------------------------- demod oracle
def golden_fm_demod(i, q, prev_phase=0.0):
    out = np.empty(len(i))
    for k in range(len(i)):
        current = math.atan2(q[k], i[k])
        prev_phase, current = np.unwrap([prev_phase, current])
        out[k] = current - prev_phase
        prev_phase = current
    return out, prev_phase


# ------------------------------------------------- mono/stereo chain oracle
def golden_mono_stereo(iq_u8, n_blocks, block_size=307200, rf_fs=2.4e6,
                       up=1, down=5):
    """Block-chained mono+stereo pipeline following model/fmMonoBlock.py.

    iq_u8: interleaved uint8; returns dict of concatenated outputs.
    """
    rf_taps, rf_fc, rf_decim = 151, 100e3, 10
    if_fs = rf_fs / rf_decim
    a_taps = 151 * up
    rf_coeff = signal.firwin(rf_taps, rf_fc / (rf_fs / 2), window="hann")
    audio_coeff = signal.firwin(a_taps, 16e3 / (if_fs * up / 2), window="hann")
    pilot_coeff = signal.firwin(151, [18.5e3 / (if_fs / 2), 19.5e3 / (if_fs / 2)],
                                window="hann", pass_zero="bandpass")
    chan_coeff = signal.firwin(151, [22e3 / (if_fs / 2), 54e3 / (if_fs / 2)],
                               window="hann", pass_zero="bandpass")

    zi_i = np.zeros(rf_taps - 1)
    zi_q = np.zeros(rf_taps - 1)
    prev_phase = 0.0
    zi_mono = np.zeros(a_taps - 1)
    zi_pilot = np.zeros(150)
    zi_chan = np.zeros(150)
    zi_st = np.zeros(a_taps - 1)
    pll_state = pll_init_state()

    iq = (iq_u8.astype(np.float64) - 128.0) / 128.0
    outs = {k: [] for k in ("fm", "mono", "left", "right", "stereo")}

    for b in range(n_blocks):
        blk = iq[b * block_size:(b + 1) * block_size]
        i_f, zi_i = signal.lfilter(rf_coeff, 1.0, blk[0::2], zi=zi_i)
        q_f, zi_q = signal.lfilter(rf_coeff, 1.0, blk[1::2], zi=zi_q)
        i_ds, q_ds = i_f[::rf_decim], q_f[::rf_decim]
        fm, prev_phase = golden_fm_demod(i_ds, q_ds, prev_phase)

        # mono: upsample(up) -> LPF -> [::down] * up
        um = np.zeros(len(fm) * up)
        um[::up] = fm
        mono_f, zi_mono = signal.lfilter(audio_coeff, 1.0, um, zi=zi_mono)
        mono = mono_f[::down] * up

        pilot, zi_pilot = signal.lfilter(pilot_coeff, 1.0, fm, zi=zi_pilot)
        nco, _, pll_state = golden_pll(pilot, 19e3, if_fs, pll_state, 2.0)
        chan, zi_chan = signal.lfilter(chan_coeff, 1.0, fm, zi=zi_chan)
        mixed = 2.0 * chan * nco[: len(chan)]
        us = np.zeros(len(mixed) * up)
        us[::up] = mixed
        st_f, zi_st = signal.lfilter(audio_coeff, 1.0, us, zi=zi_st)
        stereo = st_f[::down] * up

        outs["fm"].append(fm)
        outs["mono"].append(mono)
        outs["stereo"].append(stereo)
        outs["left"].append((mono + stereo) / 2)
        outs["right"].append((mono - stereo) / 2)

    return {k: np.concatenate(v) for k, v in outs.items()}


# -------------------------------------------------------- RDS chain oracle
def golden_rds_dsp(fm_blocks, if_fs=240e3):
    """RDS DSP chain (model/fmRDSblock.py:154-204) over a list of fm_demod
    blocks; returns per-block (rrc_i, rrc_q)."""
    taps = 151
    extract_coeff = signal.firwin(taps, [54e3 / (if_fs / 2), 60e3 / (if_fs / 2)],
                                  window="hann", pass_zero="bandpass")
    square_coeff = signal.firwin(taps, [113.5e3 / (if_fs / 2), 114.5e3 / (if_fs / 2)],
                                 window="hann", pass_zero="bandpass")
    lpf_coeff = signal.firwin(taps, 3e3 / (if_fs / 2), window="hann")
    anti_coeff = signal.firwin(taps, (57e3 / 2) / (if_fs * 19 / 2), window="hann")
    from rtsdr_tpu_torch.ops.coeffs import rrc_taps as _rrc
    rrc_coeff = _rrc(57e3, 151)

    zi_e = np.zeros(taps - 1)
    zi_s = np.zeros(taps - 1)
    zi_l = np.zeros(taps - 1)
    zi_lq = np.zeros(taps - 1)
    zi_a = np.zeros(taps - 1)
    zi_aq = np.zeros(taps - 1)
    zi_r = np.zeros(150)
    zi_rq = np.zeros(150)
    pll_state = pll_init_state()
    phase_adj = math.pi / 3.3 - math.pi / 1.5

    out = []
    for fm in fm_blocks:
        extract, zi_e = signal.lfilter(extract_coeff, 1.0, fm, zi=zi_e)
        pre_pll, zi_s = signal.lfilter(square_coeff, 1.0, np.square(extract), zi=zi_s)
        nco, nco_q, pll_state = golden_pll(pre_pll, 114e3, if_fs, pll_state,
                                           0.5, phase_adj, 0.001)
        mixed = extract * nco[: len(extract)] * 2
        mixed_q = extract * nco_q[: len(extract)] * 2
        lpf, zi_l = signal.lfilter(lpf_coeff, 1.0, mixed, zi=zi_l)
        lpf_q, zi_lq = signal.lfilter(lpf_coeff, 1.0, mixed_q, zi=zi_lq)
        n = len(lpf)
        u = np.zeros(n * 19)
        uq = np.zeros(n * 19)
        u[::19] = lpf
        uq[::19] = lpf_q
        ai, zi_a = signal.lfilter(anti_coeff, 1.0, u, zi=zi_a)
        aiq, zi_aq = signal.lfilter(anti_coeff, 1.0, uq, zi=zi_aq)
        res = ai[::80] * 19
        res_q = aiq[::80] * 19
        rrc_i, zi_r = signal.lfilter(rrc_coeff, 1.0, res, zi=zi_r)
        rrc_q, zi_rq = signal.lfilter(rrc_coeff, 1.0, res_q, zi=zi_rq)
        out.append((rrc_i, rrc_q))
    return out


# ----------------------------------------------------- bit layer oracle
H = None  # filled below


def _build_h():
    from rtsdr_tpu_torch.pipeline.frame import H_MATRIX
    return np.asarray(H_MATRIX)


SYNDROME_LIST = {
    "A": [1, 1, 1, 1, 0, 1, 1, 0, 0, 0],
    "B": [1, 1, 1, 1, 0, 1, 0, 1, 0, 0],
    "C": [1, 0, 0, 1, 0, 1, 1, 1, 0, 0],
    "D": [1, 0, 0, 1, 0, 1, 1, 0, 0, 0],
    "C'": [1, 1, 1, 1, 0, 0, 1, 1, 0, 0],  # version-B block 3 (IEC 62106)
}


class GoldenFrameDecoder:
    """Bit layer transcription of model/fmRDSblock.py:206-347, block-chained.

    offset_mode='track' follows the model's per-block clock-offset update;
    'hold' keeps the initial offset (the C++ behavior,
    src/fm_radio.cpp:529-538).
    """

    def __init__(self, offset_mode="track", with_cprime=True):
        self.h = _build_h()
        self.syndromes = dict(SYNDROME_LIST)
        if not with_cprime:   # strict 4-syndrome reference behavior
            del self.syndromes["C'"]
        self.offset_mode = offset_mode
        self.block_count = 0
        self.int_offset = 0
        self.start_pos = 0
        self.lonely_bit = 0.0
        self.front_bit = 0
        self.prebit = 0
        self.prev_sync_bits = np.zeros(0, dtype=int)
        self.printposition = 0
        self.last_position = -1

    def step(self, rrc_i, rrc_q):
        events = []
        if self.block_count == 0:
            self.int_offset = int(np.argmax(rrc_i[0:24]))

        symbols = rrc_i[self.int_offset::24]
        n_sym = len(symbols)
        if self.offset_mode == "track":
            self.int_offset = 24 - (
                np.where(rrc_i[len(rrc_i) - 24:] == symbols[-1])[0][0])

        if self.block_count == 0:
            count0 = count1 = 0
            for m in range(n_sym // 4):
                if (symbols[2 * m] > 0 and symbols[2 * m + 1] > 0) or (
                        symbols[2 * m] < 0 and symbols[2 * m + 1] < 0):
                    count0 += 1
                elif (symbols[2 * m + 1] > 0 and symbols[2 * m + 2] > 0) or (
                        symbols[2 * m + 1] < 0 and symbols[2 * m + 2] < 0):
                    count1 += 1
            self.start_pos = 1 if count0 > count1 else 0

        sp = self.start_pos
        bits = np.zeros(n_sym // 2 - sp, dtype=int)
        if sp == 1 and self.block_count != 0:
            if self.lonely_bit > symbols[0]:
                self.front_bit = 1
            elif self.lonely_bit < symbols[0]:
                self.front_bit = 0
        for k in range(len(bits)):
            if sp + 2 * k + 1 > n_sym - 1:
                break
            if symbols[2 * k + sp] > symbols[2 * k + 1 + sp]:
                bits[k] = 1
            elif symbols[2 * k + sp] < symbols[2 * k + 1 + sp]:
                bits[k] = 0
        if sp == 1:
            bits = np.insert(bits, 0, self.front_bit)
            self.lonely_bit = symbols[-1]

        if self.block_count == 0:
            self.prebit = bits[0]
            offset = 1
        else:
            offset = 0
        diff = np.zeros(len(bits) - offset, dtype=int)
        for t in range(len(diff)):
            diff[t] = self.prebit ^ bits[t + offset]
            self.prebit = bits[t + offset]
        self.prebit = bits[-1]

        if self.block_count != 0:
            diff = np.concatenate([self.prev_sync_bits, diff])

        position = 0
        while True:
            block = diff[position:position + 26]
            synd = (block @ self.h) % 2
            for name, pat in self.syndromes.items():
                if list(synd) == pat:
                    if self.last_position == -1 or (
                            self.printposition - self.last_position == 26):
                        events.append((name, self.printposition, True))
                        self.last_position = self.printposition
                    else:
                        events.append((name, self.printposition, False))
            position += 1
            if position + 26 > len(diff) - 1:
                break
            self.printposition += 1
        self.prev_sync_bits = diff[position - 1:].copy()
        self.block_count += 1
        return symbols, events


# ------------------------------------------------------------ synthesizers
from rtsdr_tpu_torch.utils.signals import (  # noqa: E402,F401
    RDS_CRC_POLY,
    RDS_OFFSET_WORDS,
    encode_rds_blocks,
    rds_baseband,
    rds_crc10,
    synth_multiplex_iq,
)
