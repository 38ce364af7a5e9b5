"""The least work of one receiver step, counted from a configuration's
shapes: the operations and the device-memory bytes that any implementation
of the step needs, whichever kernels carry it out.

Copied from the arithmetic of ``chip_smoke.py``'s kernel bounds (PERF.md
section 6, "bound" column) and extended to the whole step:

* bytes: each input byte read once (the raw u8 block, the carried state),
  each output byte written once (L, R and mono audio, the bit layer's
  outputs) and each carried-state byte written once;
* operations: a multiply-add is 2; every FIR and rational resampler counts
  only the taps that meet an input for the outputs kept (its polyphase
  least), the 3 kHz RDS low-pass composed into the anti-image filter as
  one (the cheaper of the two forms); the FM discriminator 8 per IF sample,
  a PLL 20 per sample and loop (chip_smoke.py's PLL count, 12 + 8); the
  squaring and the mixers 1 and 2 per sample; the bit layer's integer
  work is not counted.

``least_seconds(work, peaks)`` is the larger of operations / peak float32
rate and bytes / peak memory rate.
"""

from __future__ import annotations

import json
import math
import os

F32 = 4
CARRY_BITS = 27


def _sizes(config: dict) -> dict:
    rf, mono, r = config["rf"], config["mono"], config["rds"]
    n_iq = config["block_size"] // 2
    n_if = n_iq // rf["decim"]
    n_audio = n_if * mono["up"] // mono["down"]
    n_rds = n_if * r["up"] // r["down"]
    return {"n_iq": n_iq, "n_if": n_if, "n_audio": n_audio, "n_rds": n_rds,
            "s_max": n_rds // r["sps"]}


def rf_fir_flop(channels: int, config: dict) -> int:
    """The RF low-pass and decimator over I and Q (K1's iq stage)."""
    return channels * _sizes(config)["n_if"] * 2 * 2 * config["rf"]["taps"]


def _per_output_taps(taps: int, up: int) -> int:
    return math.ceil(taps / up)


def step_flop(channels: int, config: dict) -> int:
    s = _sizes(config)
    mono, st, r = config["mono"], config["stereo"], config["rds"]
    n_if, n_audio, n_rds = s["n_if"], s["n_audio"], s["n_rds"]
    audio_taps = _per_output_taps(mono["taps"] * mono["up"], mono["up"])
    composed = (r["taps"] - 1) * r["up"] + r["anti_img_taps"]
    rds_resample = min(
        n_rds * _per_output_taps(composed, r["up"]),
        n_if * r["taps"] + n_rds * _per_output_taps(r["anti_img_taps"],
                                                    r["up"]))
    per_channel = (
        8 * n_if                                  # discriminator
        + 2 * n_audio * audio_taps * 2            # mono and stereo audio
        + 2 * n_if                                # stereo mixer
        + 2 * n_if * st["taps"] * 2               # pilot, stereo channel
        + 2 * n_if * r["taps"]                    # RDS extraction
        + n_if + 2 * n_if * r["taps"]             # squaring, 114 kHz BPF
        + 2 * 20 * n_if                           # two PLLs
        + 2 * 2 * n_if                            # RDS I and Q mixers
        + 2 * 2 * rds_resample                    # LPF + resampler, I and Q
        + 2 * 2 * n_rds * r["rrc_taps"])          # RRC, I and Q
    return rf_fir_flop(channels, config) + channels * per_channel


def step_bytes(channels: int, config: dict) -> int:
    s = _sizes(config)
    mono, st, r = config["mono"], config["stereo"], config["rds"]
    w_max = s["s_max"] // 2 + CARRY_BITS - 26
    # carried state per channel, floats: RF histories (I, Q), demod's last
    # sample, audio resampler histories (mono, stereo), the IF band-pass
    # history, the squared band-pass history, two PLLs of 7, the composed
    # RDS resampler history and the RRC history (I, Q), and the bit
    # layer's 11 scalars and 27-bit carry
    composed = (r["taps"] - 1) * r["up"] + r["anti_img_taps"]
    state = F32 * (
        2 * (config["rf"]["taps"] - 1) + 2
        + 2 * (math.ceil(mono["taps"] * mono["up"] / mono["up"]) - 1)
        + (st["taps"] - 1) + (r["taps"] - 1) + 2 * 7
        + 2 * (math.ceil(composed / r["up"]) - 1) + 2 * (r["rrc_taps"] - 1)
        + 11 + CARRY_BITS)
    outputs = (3 * s["n_audio"] * F32          # left, right, mono
               + 2 * s["s_max"] * F32          # symbols I and Q
               + 3 * F32                       # n_sym, n_windows, padding
               + w_max * (3 * F32 + 4))        # ids, positions, info; flags
    return channels * (config["block_size"] + 2 * state + outputs)


def load_peaks(kind: str) -> dict | None:
    """The published peaks of the card named ``kind`` (None when the table
    does not know it)."""
    with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as f:
        return json.load(f).get(kind)


def least_seconds(flop: float, nbytes: float, peaks: dict
                  ) -> tuple[float, str]:
    t_o = flop / peaks["f32_flop_per_s"]
    t_b = nbytes / peaks["hbm_bytes_per_s"]
    return max(t_o, t_b), ("operations" if t_o >= t_b else "bytes")
