"""The plain reference receiver: NumPy and SciPy, float64, block by block.

A frozen copy of the golden decoder of ``tests/torch_oracles.py`` (after
the reference's Python models, model/fmMonoBlock.py and model/fmRDSblock.py)
with its own tables: the filters are ``scipy.signal.firwin`` designs, the
RRC pulse and the RDS parity matrix are written out here.  It imports
nothing of the program, of ``tests/`` or of JAX.

It starts at the RF low-pass: its input is each lane's float64 I and Q at
``rf.fs``, which the configuration's reference front makes from what a
stream carries (``front_<name>.py`` beside this file, named by the
configuration's ``reference_front``; ``front_u8.py``, a station's own u8
I/Q, where it names none).

It follows a configuration file (``benchmark/configs/*.json``) and its
receiver settings: stereo on, the RDS chain, the bit layer with the clock
offset held from the first block (``offset_mode`` "hold"), the C' offset
word, and ``resync``: more than 10 consecutive wrongly spaced syndrome
matches reset the sync anchor.

Every stage is written as its arithmetic, vectorised over lanes (rows of
one block each): a filter or a rational resampler as the sum over its
taps of the inputs it needs (the polyphase least), carrying the last
inputs it needs as its history; the PLL as the model's per-sample loop.
``precision="bfloat16"`` rounds every stage's taps, inputs and outputs to
bfloat16 (8 significant bits): the control that a comparison has to fail;
``precision="float32"`` rounds them to float32, a witness of what rounding
at the program's precision does to the float64 result.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import signal

from benchmark.traffic.synth import rrc_taps

# RDS parity-check matrix (26 x 10) and the offset-word syndromes A, B, C,
# D, C' (IEC 62106; model/fmRDSblock.py:50, src/fm_radio.cpp:477-482)
H_MATRIX = np.array([
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 0], [0, 1, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 1, 0, 0, 0, 0, 0, 0, 0], [0, 0, 0, 1, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 1, 0, 0, 0, 0, 0], [0, 0, 0, 0, 0, 1, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 1, 0, 0, 0], [0, 0, 0, 0, 0, 0, 0, 1, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 0], [0, 0, 0, 0, 0, 0, 0, 0, 0, 1],
    [1, 0, 1, 1, 0, 1, 1, 1, 0, 0], [0, 1, 0, 1, 1, 0, 1, 1, 1, 0],
    [0, 0, 1, 0, 1, 1, 0, 1, 1, 1], [1, 0, 1, 0, 0, 0, 0, 1, 1, 1],
    [1, 1, 1, 0, 0, 1, 1, 1, 1, 1], [1, 1, 0, 0, 0, 1, 0, 0, 1, 1],
    [1, 1, 0, 1, 0, 1, 0, 1, 0, 1], [1, 1, 0, 1, 1, 1, 0, 1, 1, 0],
    [0, 1, 1, 0, 1, 1, 1, 0, 1, 1], [1, 0, 0, 0, 0, 0, 0, 0, 0, 1],
    [1, 1, 1, 1, 0, 1, 1, 1, 0, 0], [0, 1, 1, 1, 1, 0, 1, 1, 1, 0],
    [0, 0, 1, 1, 1, 1, 0, 1, 1, 1], [1, 0, 1, 0, 1, 0, 0, 1, 1, 1],
    [1, 1, 1, 0, 0, 0, 1, 1, 1, 1], [1, 1, 0, 0, 0, 1, 1, 0, 1, 1],
], dtype=np.int64)
SYNDROMES = np.array([
    [1, 1, 1, 1, 0, 1, 1, 0, 0, 0],   # A
    [1, 1, 1, 1, 0, 1, 0, 1, 0, 0],   # B
    [1, 0, 0, 1, 0, 1, 1, 1, 0, 0],   # C
    [1, 0, 0, 1, 0, 1, 1, 0, 0, 0],   # D
    [1, 1, 1, 1, 0, 0, 1, 1, 0, 0],   # C'
], dtype=np.int64)
CARRY_BITS = 27
RESYNC_AFTER = 10

PLL_FIELDS = ("integrator", "phase_est", "fb_i", "fb_q", "nco_i", "nco_q",
              "theta")
FRAME_FIELDS = ("offset", "start_pos", "lonely_bit", "prebit", "first_block",
                "carry", "base_pos", "last_position", "bad_count")


def to_precision(x, precision: str):
    """``x`` as float64 after rounding to ``precision`` ("float64": as it
    is; "float32": to the nearest float32; "bfloat16": round to nearest
    even on 8 significant bits)."""
    x = np.asarray(x, np.float64)
    if precision == "float64":
        return x
    if precision == "float32":
        return x.astype(np.float32).astype(np.float64)
    if precision != "bfloat16":
        raise ValueError(f"precision {precision!r}")
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def lowpass(fs: float, fc: float, taps: int) -> np.ndarray:
    return signal.firwin(taps, fc / (fs / 2), window="hann")


def bandpass(fs: float, lo: float, hi: float, taps: int) -> np.ndarray:
    return signal.firwin(taps, [lo / (fs / 2), hi / (fs / 2)],
                         window="hann", pass_zero="bandpass")


class Resampler:
    """``y[m] = up * sum_k h[k] u[m * down - k]`` over the input ``x``
    zero-stuffed by ``up`` (``u[j * up] = x[j]``), for blocks of ``n_in``
    inputs, the model's ``lfilter`` then ``[::down] * up`` with the filter
    state carried: each output sums only the taps that meet an input."""

    def __init__(self, h, up: int, down: int, n_in: int, precision: str):
        h = np.asarray(h, np.float64)
        taps = len(h)
        if (n_in * up) % down:
            raise ValueError("block does not divide the resampler")
        n_out = n_in * up // down
        nk = -(-taps // up)
        m = np.arange(n_out)
        j_top = (m * down) // up
        j = j_top[:, None] - np.arange(nk)[None, :]
        k = (m * down)[:, None] - j * up
        coef = np.where(k < taps, h[np.minimum(k, taps - 1)], 0.0) * up
        self.hist = nk - 1
        self.index = j + self.hist
        self.coef = to_precision(coef, precision)
        self.precision = precision
        self.n_out = n_out

    def zeros(self, lanes: int) -> np.ndarray:
        return np.zeros((lanes, self.hist))

    def __call__(self, hist: np.ndarray, x: np.ndarray):
        """``(y, new_hist)`` for lanes ``x`` (L, n_in) behind ``hist``."""
        xx = np.concatenate([hist, to_precision(x, self.precision)], -1)
        y = np.empty((len(xx), self.n_out))
        for lane in range(len(xx)):
            y[lane] = np.einsum("mk,mk->m", xx[lane][self.index], self.coef)
        return to_precision(y, self.precision), xx[:, xx.shape[1] - self.hist:]


def pll(x, st: dict, freq: float, fs: float, pcfg: dict, precision: str):
    """The model's PLL (model/fmPll.py) over lanes ``x`` (L, n): atan2
    phase detector, PI loop filter, NCO ``cos/sin(arg * scale + adjust)``;
    ``st`` holds ``PLL_FIELDS`` as (L,) arrays, ``theta`` being the ramp's
    angle ``2 pi freq / fs * trigOffset``.  Returns the NCO delayed by one
    sample (element 0 is the previous block's last) and the new state.  An
    input of exactly 0 gives error 0."""
    x = to_precision(x, precision)
    lanes, n = x.shape
    kp = pcfg["norm_bandwidth"] * pcfg["cp"]
    ki = pcfg["norm_bandwidth"] ** 2 * pcfg["ci"]
    dth = 2.0 * math.pi * freq / fs
    scale, adjust = pcfg["nco_scale"], pcfg["phase_adjust"]
    integ = st["integrator"].astype(np.float64)
    phase = st["phase_est"].astype(np.float64)
    fb_i = st["fb_i"].astype(np.float64)
    fb_q = st["fb_q"].astype(np.float64)
    theta = st["theta"].astype(np.float64)
    args = np.empty((n, lanes))
    xs = np.ascontiguousarray(x.T)
    nonzero = xs != 0
    for k in range(n):
        xk = xs[k]
        err = np.arctan2(-xk * fb_q, xk * fb_i) * nonzero[k]
        integ = integ + ki * err
        phase = phase + kp * err + integ
        arg = theta + dth * (k + 1) + phase
        args[k] = arg
        fb_i = np.cos(arg)
        fb_q = np.sin(arg)
    nco_arg = (args * scale + adjust).T
    nco_i = to_precision(np.cos(nco_arg), precision)
    nco_q = to_precision(np.sin(nco_arg), precision)
    new = {"integrator": integ, "phase_est": phase, "fb_i": fb_i,
           "fb_q": fb_q, "nco_i": nco_i[:, -1].copy(),
           "nco_q": nco_q[:, -1].copy(), "theta": theta + dth * n}
    delayed_i = np.concatenate([st["nco_i"][:, None], nco_i[:, :-1]], -1)
    delayed_q = np.concatenate([st["nco_q"][:, None], nco_q[:, :-1]], -1)
    return delayed_i, delayed_q, new


def pll_init(lanes: int) -> dict:
    z, o = np.zeros(lanes), np.ones(lanes)
    return {"integrator": z, "phase_est": z, "fb_i": o, "fb_q": z,
            "nco_i": o, "nco_q": z, "theta": z}


def frame_init() -> dict:
    return {"offset": 0, "start_pos": 0, "lonely_bit": 0.0, "prebit": 0,
            "first_block": True, "carry": np.zeros(CARRY_BITS, np.int64),
            "base_pos": 0, "last_position": -1, "bad_count": 0}


def frame_block(rrc_i: np.ndarray, st: dict, sps: int, resync: bool):
    """The bit layer over one lane's block of RRC samples
    (model/fmRDSblock.py:206-347 with the clock offset held from the first
    block, plus the C++'s resync): ``(outputs, new_state)``.  Outputs:
    ``n_sym``, ``symbols``, ``n_windows`` and per window ``syndrome_id``
    (0 none, 1-5 = A, B, C, D, C'), ``is_sync``, ``is_false_pos``,
    ``is_resync``, ``positions``."""
    first = bool(st["first_block"])
    offset = int(np.argmax(rrc_i[:sps])) if first else int(st["offset"])
    return frame_symbols(rrc_i[offset::sps], st, resync, offset)


def frame_symbols(symbols: np.ndarray, st: dict, resync: bool,
                  offset: int):
    """The bit layer from one block's symbols on: Manchester phase (first
    block), bits, differential decoding, syndromes, the sync walk.  The
    same outputs and state as ``frame_block``."""
    symbols = np.asarray(symbols, np.float64)
    first = bool(st["first_block"])
    n_sym = len(symbols)
    if first:
        count0 = count1 = 0
        for m in range(n_sym // 4):
            a0, a1, a2 = symbols[2 * m], symbols[2 * m + 1], symbols[2 * m + 2]
            if (a0 > 0 and a1 > 0) or (a0 < 0 and a1 < 0):
                count0 += 1
            elif (a1 > 0 and a2 > 0) or (a1 < 0 and a2 < 0):
                count1 += 1
        start_pos = 1 if count0 > count1 else 0
    else:
        start_pos = int(st["start_pos"])
    n_pairs = n_sym // 2 - start_pos
    lo = symbols[start_pos:start_pos + 2 * n_pairs:2]
    hi = symbols[start_pos + 1:start_pos + 2 * n_pairs:2]
    bits = (lo > hi).astype(np.int64)
    lonely = float(st["lonely_bit"])
    if start_pos == 1:
        front = int(lonely > symbols[0]) if not first else 0
        bits = np.concatenate([[front], bits])
        lonely = float(symbols[-1])
    if first:
        prebit, body = int(bits[0]), bits[1:]
    else:
        prebit, body = int(st["prebit"]), bits
    diff = body ^ np.concatenate([[prebit], body[:-1]])
    prebit_new = int(bits[-1])
    ext = diff if first else np.concatenate([st["carry"], diff])
    n_windows = len(ext) - 26
    windows = np.lib.stride_tricks.sliding_window_view(ext, 26)[:n_windows]
    synd = (windows @ H_MATRIX) % 2
    match = (synd[:, None, :] == SYNDROMES[None]).all(-1)
    sid = np.where(match.any(-1), np.argmax(match, -1) + 1, 0)
    base = int(st["base_pos"])
    last, bad = int(st["last_position"]), int(st["bad_count"])
    is_sync = np.zeros(n_windows, bool)
    is_fp = np.zeros(n_windows, bool)
    is_resync = np.zeros(n_windows, bool)
    for w in range(n_windows):
        if sid[w]:
            if last < 0 or base + w - last == 26:
                is_sync[w] = True
                last, bad = base + w, 0
            else:
                is_fp[w] = True
                bad += 1
        if resync and bad > RESYNC_AFTER:
            is_resync[w] = True
            last, bad = -1, 0
    out = {"n_sym": n_sym, "symbols": symbols, "n_windows": n_windows,
           "syndrome_id": sid, "is_sync": is_sync, "is_false_pos": is_fp,
           "is_resync": is_resync, "positions": base + np.arange(n_windows)}
    new = {"offset": offset, "start_pos": start_pos, "lonely_bit": lonely,
           "prebit": prebit_new, "first_block": False,
           "carry": ext[n_windows - 1:n_windows - 1 + CARRY_BITS].copy(),
           "base_pos": base + n_windows - 1, "last_position": last,
           "bad_count": bad}
    return out, new


class Receiver:
    """The receiver of one configuration file from the RF low-pass on,
    over lanes: ``init`` and ``step(state, i_rf, q_rf)``, each lane's I and
    Q, (L, block_size // 2) float64 at ``rf.fs``."""

    def __init__(self, config: dict, precision: str = "float64"):
        self.cfg = config
        self.precision = precision
        rf, mono, st, r = (config["rf"], config["mono"], config["stereo"],
                           config["rds"])
        self.if_fs = rf["fs"] / rf["decim"]
        n_iq = config["block_size"] // 2
        n_if = n_iq // rf["decim"]
        p = precision
        self.rf = Resampler(lowpass(rf["fs"], rf["fc"], rf["taps"]), 1,
                            rf["decim"], n_iq, p)
        audio_h = lowpass(self.if_fs * mono["up"], mono["fc"],
                          mono["taps"] * mono["up"])
        self.audio = Resampler(audio_h, mono["up"], mono["down"], n_if, p)
        self.pilot = Resampler(bandpass(self.if_fs, st["pilot_lo"],
                                        st["pilot_hi"], st["taps"]),
                               1, 1, n_if, p)
        self.chan = Resampler(bandpass(self.if_fs, st["chan_lo"],
                                       st["chan_hi"], st["taps"]),
                              1, 1, n_if, p)
        self.extract = Resampler(bandpass(self.if_fs, r["extract_lo"],
                                          r["extract_hi"], r["taps"]),
                                 1, 1, n_if, p)
        self.squared = Resampler(bandpass(self.if_fs, r["squared_lo"],
                                          r["squared_hi"], r["taps"]),
                                 1, 1, n_if, p)
        self.lpf = Resampler(lowpass(self.if_fs, r["lpf_fc"], r["taps"]),
                             1, 1, n_if, p)
        self.anti = Resampler(
            lowpass(self.if_fs * r["up"], r["rrc_fs"] / 2,
                    r["anti_img_taps"]), r["up"], r["down"], n_if, p)
        self.rrc = Resampler(rrc_taps(r["rrc_fs"], r["rrc_taps"],
                                      r["rrc_beta"], r["symbol_rate"]),
                             1, 1, self.anti.n_out, p)
        self.resync = bool(config["receiver"]["resync"])

    def init(self, lanes: int) -> dict:
        z = np.zeros
        return {
            "rf_i": self.rf.zeros(lanes), "rf_q": self.rf.zeros(lanes),
            "prev_i": np.ones(lanes), "prev_q": z(lanes),
            "fm_audio": self.audio.zeros(lanes),
            "fm_if": self.pilot.zeros(lanes),
            "extract_sq": self.squared.zeros(lanes),
            "mixed": self.audio.zeros(lanes),
            "mix_i": self.lpf.zeros(lanes), "mix_q": self.lpf.zeros(lanes),
            "lpf_i": self.anti.zeros(lanes), "lpf_q": self.anti.zeros(lanes),
            "res_i": self.rrc.zeros(lanes), "res_q": self.rrc.zeros(lanes),
            "pll_pilot": pll_init(lanes), "pll_rds": pll_init(lanes),
            "frame": [frame_init() for _ in range(lanes)],
        }

    def step(self, state: dict, i_rf: np.ndarray, q_rf: np.ndarray,
             run: str = "full"):
        """One block of every lane from its I and Q.  ``run``: "full",
        "audio_rds" (all but the bit layer) or "histories" (the stages
        before the PLLs only: their histories for the next block).  Returns
        ``(state, outputs)``."""
        q = lambda x: to_precision(x, self.precision)  # noqa: E731
        s = dict(state)
        cfg = self.cfg
        i_if, s["rf_i"] = self.rf(state["rf_i"], i_rf)
        q_if, s["rf_q"] = self.rf(state["rf_q"], q_rf)
        ip = np.concatenate([state["prev_i"][:, None], i_if[:, :-1]], -1)
        qp = np.concatenate([state["prev_q"][:, None], q_if[:, :-1]], -1)
        fm = q(np.arctan2(q_if * ip - i_if * qp, i_if * ip + q_if * qp))
        s["prev_i"], s["prev_q"] = i_if[:, -1].copy(), q_if[:, -1].copy()
        mono, s["fm_audio"] = self.audio(state["fm_audio"], fm)
        pilot, _ = self.pilot(state["fm_if"], fm)
        chan, _ = self.chan(state["fm_if"], fm)
        extract, s["fm_if"] = self.extract(state["fm_if"], fm)
        pre_pll, s["extract_sq"] = self.squared(state["extract_sq"],
                                                q(extract * extract))
        if run == "histories":
            return s, None
        st, r = cfg["stereo"], cfg["rds"]
        nco, _, s["pll_pilot"] = pll(pilot, state["pll_pilot"],
                                     st["pll"]["freq"], self.if_fs,
                                     st["pll"], self.precision)
        stereo, s["mixed"] = self.audio(state["mixed"], q(2.0 * chan * nco))
        left = q(0.5 * (mono + stereo))
        right = q(0.5 * (mono - stereo))
        nco_i, nco_q, s["pll_rds"] = pll(pre_pll, state["pll_rds"],
                                         r["pll"]["freq"], self.if_fs,
                                         r["pll"], self.precision)
        lpf_i, s["mix_i"] = self.lpf(state["mix_i"], q(extract * nco_i * 2))
        lpf_q, s["mix_q"] = self.lpf(state["mix_q"], q(extract * nco_q * 2))
        res_i, s["lpf_i"] = self.anti(state["lpf_i"], lpf_i)
        res_q, s["lpf_q"] = self.anti(state["lpf_q"], lpf_q)
        rrc_i, s["res_i"] = self.rrc(state["res_i"], res_i)
        rrc_q, s["res_q"] = self.rrc(state["res_q"], res_q)
        out = {"left": left, "right": right, "rrc_i": rrc_i, "rrc_q": rrc_q}
        if run == "full":
            frames, new = [], []
            for lane in range(len(i_rf)):
                o, f = frame_block(rrc_i[lane], state["frame"][lane],
                                   r["sps"], self.resync)
                frames.append(o)
                new.append(f)
            s["frame"] = new
            out["frame"] = frames
        return s, out
