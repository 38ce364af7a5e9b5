"""The least work of the wideband channelizer (K5) over S stations, several
a slot: each station's slot band-pass and its RF low-pass and decimation,
composed, counted from a configuration's ``wideband`` block (``slots_of``
and ``offsets_hz`` a station; without ``slots_of`` one station a slot)
and the number of captures.

Under the rules of ``roofline/channelizer.py``, the least over the roles
that give the same outputs, per output and capture:

* the slot bank once per capture and slot: the residue sums of the
  prototype's real taps (4 FLOP each) and a slot's K-point DFT row (8 K
  FLOP), both ``decim`` times an output, for each slot that carries a
  station; then each station's own complex RF FIR (8 FLOP a tap).  With
  every slot used that is ``decim (4 l_ch + 8 K^2) + 8 l_rf S``;
* or, as ``channelizer.py`` counts its mixed roles: the stations on their
  slot's centre (offset 0, at most one a slot) on the composed prototype
  (L real taps, 4 FLOP each, then a DFT row each at the output rate), and
  every other station either on its L dense complex taps (8 FLOP each) or
  through the slot bank as above.

Bytes: each capture byte read once and each station's I/Q sample at the
IF rate written once (float32).
"""

from __future__ import annotations

from collections import Counter

F32 = 4


def stations(config: dict) -> tuple[list, list]:
    """Each station's slot and offset (one a slot without ``slots_of``)."""
    wb = config["wideband"]
    offsets = list(wb["offsets_hz"])
    return list(wb.get("slots_of", range(len(offsets)))), offsets


def _lengths(config: dict) -> tuple[int, int, int, int, int]:
    """K, decim, the prototype's taps, the RF low-pass's taps and the
    composed taps' length."""
    k = config["wideband"]["slots"]
    l_ch = k * config["wideband"]["taps_per_branch"]
    l_rf = config["rf"]["taps"]
    return k, config["rf"]["decim"], l_ch, l_rf, (l_rf - 1) * k + l_ch


def least_flop_per_output(config: dict) -> int:
    k, decim, l_ch, l_rf, g_len = _lengths(config)
    slots, offsets = stations(config)
    slot_bank = decim * 4 * l_ch
    row = decim * 8 * k                    # a slot's DFT row
    two_stage = slot_bank + row * len(set(slots)) + 8 * l_rf * len(slots)
    own = [c for c, o in zip(slots, offsets) if o != 0]
    n_sh = len(slots) - len(own)
    shared = (4 * g_len + 8 * k * n_sh) if n_sh else 0
    own_part = (min(len(own) * 8 * g_len,
                    slot_bank + row * len(set(own)) + 8 * l_rf * len(own))
                if own else 0)
    return min(shared + own_part, two_stage)


def outputs_per_capture(config: dict) -> int:
    """IF samples a station a step."""
    return config["block_size"] // 2 // config["rf"]["decim"]


def least_flop(config: dict, captures: int) -> int:
    return captures * outputs_per_capture(config) * least_flop_per_output(
        config)


def least_bytes(config: dict, captures: int) -> int:
    k = config["wideband"]["slots"]
    s = len(stations(config)[0])
    return captures * (k * config["block_size"]
                       + s * 2 * outputs_per_capture(config) * F32)


def describe(config: dict, captures: int) -> dict:
    slots, _ = stations(config)
    return {"slots": config["wideband"]["slots"], "stations": len(slots),
            "per_slot": max(Counter(slots).values()),
            "taps": _lengths(config)[4],
            "flop": least_flop(config, captures),
            "bytes": least_bytes(config, captures),
            "outputs": captures * len(slots) * outputs_per_capture(config)}
