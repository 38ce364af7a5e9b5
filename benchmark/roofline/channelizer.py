"""The least work of the wideband channelizer (K5: the K slots' band-pass
and the stations' RF low-pass and decimation, composed), counted from a
configuration's ``wideband`` block and the number of captures.

Copied from ``chip_smoke.py::k5_least_flop`` (PERF.md section 6, row B8):
the composed taps ``g_k = up_K(h_rf rot_k) * (mod_k h_ch)`` factor into a
shared bank at the slot rate (the residue sums of the prototype's real
taps, 4 FLOP each, then one K-point DFT row a station, 8 K FLOP, both
``decim`` times an output) and each station's own complex RF FIR (8 FLOP
a tap); a station on the shared prototype may instead take the composed
prototype (L real taps, 4 FLOP each, then its DFT row at the output rate)
and an offset station its L dense complex taps (8 FLOP each).  Whichever
is least, per output and capture.

Bytes: each capture byte read once and each station's I/Q sample at the
IF rate written once (float32).

The routes: a station whose residual offset is 0 takes the shared
prototype, every other its own taps (``ops/channelizer.py::
composed_plan``'s rule, for distinct non-zero offsets).
"""

from __future__ import annotations

F32 = 4


def routes(config: dict) -> tuple[int, int]:
    """(stations on the shared prototype, stations with their own taps)."""
    offsets = config["wideband"]["offsets_hz"]
    n_sh = sum(1 for o in offsets if o == 0)
    return n_sh, len(offsets) - n_sh


def _lengths(config: dict) -> tuple[int, int, int, int, int]:
    """K, decim, the prototype's taps, the RF low-pass's taps and the
    composed taps' length."""
    k = config["wideband"]["slots"]
    l_ch = k * config["wideband"]["taps_per_branch"]
    l_rf = config["rf"]["taps"]
    return k, config["rf"]["decim"], l_ch, l_rf, (l_rf - 1) * k + l_ch


def least_flop_per_output(config: dict) -> int:
    """FLOP an output and capture of the least exact work
    (``chip_smoke.py::k5_least_flop``)."""
    k, decim, l_ch, l_rf, g_len = _lengths(config)
    n_sh, n_own = routes(config)
    slot_bank = decim * 4 * l_ch
    two_stage = decim * 8 * k + 8 * l_rf        # a station
    own = (min(n_own * 8 * g_len, slot_bank + n_own * two_stage)
           if n_own else 0)
    mixed = ((4 * g_len + 8 * k * n_sh) if n_sh else 0) + own
    return min(mixed, slot_bank + k * two_stage)


def outputs_per_capture(config: dict) -> int:
    """IF samples a station a step."""
    return config["block_size"] // 2 // config["rf"]["decim"]


def least_flop(config: dict, captures: int) -> int:
    return captures * outputs_per_capture(config) * least_flop_per_output(
        config)


def least_bytes(config: dict, captures: int) -> int:
    k = config["wideband"]["slots"]
    return captures * (k * config["block_size"]
                       + k * 2 * outputs_per_capture(config) * F32)


def describe(config: dict, captures: int) -> dict:
    n_sh, n_own = routes(config)
    return {"shared": n_sh, "own": n_own, "taps": _lengths(config)[4],
            "flop": least_flop(config, captures),
            "bytes": least_bytes(config, captures),
            "outputs": captures * config["wideband"]["slots"]
            * outputs_per_capture(config)}
