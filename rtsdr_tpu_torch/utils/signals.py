"""Test-signal generators (reference src/genfunc.cpp:13-41, used for kernel
bring-up in the labs) plus an FM multiplex synthesizer for end-to-end
self-test without recorded captures (own copy of
``rtsdr_tpu/utils/signals.py``), the same station under a real capture's
impairments (clock error, pilot detune and phase noise), an RDS encoder + pulse shaper so the
synthetic station can carry known groups, and a wideband-capture
synthesizer (K such stations side by side in one capture at K x the RF
rate) for the channelizer, the wideband receiver and the band scanner;
and random inputs of the frame layer's resync walk that reach every branch
(its kernel against its plain version)."""

from __future__ import annotations

import numpy as np

from rtsdr_tpu_torch.ops.coeffs import rrc_taps


def generate_sin(fs: float, freq: float, n: int, amplitude: float = 1.0,
                 phase: float = 0.0) -> np.ndarray:
    """Sine generator (reference generateSin, src/genfunc.cpp:13-21)."""
    t = np.arange(n) / fs
    return amplitude * np.sin(2 * np.pi * freq * t + phase)


def mix_sin(*signals: np.ndarray) -> np.ndarray:
    """Sum of equal-length sines, normalized by count (reference mixSin,
    src/genfunc.cpp:23-31)."""
    return np.sum(signals, axis=0) / len(signals)


def random_samples(n: int, max_value: float = 10.0, seed: int = 0) -> np.ndarray:
    """Uniform random test samples (reference generateRandomSamples,
    src/genfunc.cpp:33-41)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-max_value, max_value, n)


def _multiplex_phase(
    n_pairs: int,
    rf_fs: float,
    mono_hz: float = 1.1e3,
    stereo_hz: float = 2.3e3,
    pilot_amp: float = 0.1,
    mono_amp: float = 0.45,
    stereo_amp: float = 0.45,
    deviation: float = 75e3,
    pilot_phase: float = 0.0,
    rds_wave: np.ndarray | None = None,
    rds_amp: float = 0.25,
    pilot_hz: float = 19e3,
) -> np.ndarray:
    """Carrier phase (radians, float64) of a synthetic FM stereo station
    sampled at ``rf_fs``: the integral of the multiplex times the
    deviation."""
    t = np.arange(n_pairs) / rf_fs
    pilot_arg = 2 * np.pi * pilot_hz * t + pilot_phase
    m = (mono_amp * np.sin(2 * np.pi * mono_hz * t)
         + pilot_amp * np.cos(pilot_arg)
         + stereo_amp * np.sin(2 * np.pi * stereo_hz * t) * np.cos(2 * pilot_arg))
    if rds_wave is not None:
        # linear interpolation is fine for a test signal: band limiting
        # happens in the receiver
        t57 = np.arange(len(rds_wave)) / 57e3
        rds_rf = np.interp(t, t57, rds_wave, left=0.0, right=0.0)
        m = m + rds_amp * rds_rf * np.cos(3 * pilot_arg)
    return 2 * np.pi * deviation * np.cumsum(m) / rf_fs


def fm_multiplex_iq(n_pairs: int, rf_fs: float = 2.4e6, **station
                    ) -> np.ndarray:
    """Interleaved uint8 IQ of a synthetic FM stereo station.

    multiplex = mono tone + 19 kHz pilot + (L-R tone) DSB-SC on 38 kHz
                + optional RDS wave DSB-SC on 57 kHz (3rd pilot harmonic).
    ``station``: ``mono_hz`` (1.1e3), ``stereo_hz`` (2.3e3), ``pilot_amp``
    (0.1), ``mono_amp`` (0.45), ``stereo_amp`` (0.45), ``deviation`` (75e3),
    ``pilot_phase`` (0), ``pilot_hz`` (19e3), ``rds_wave`` (baseband at
    57 kS/s from ``rds_baseband``, resampled here to the RF-rate grid) and
    ``rds_amp`` (0.25).
    """
    phase = _multiplex_phase(n_pairs, rf_fs, **station)
    iq = np.empty(2 * n_pairs)
    iq[0::2] = np.cos(phase)
    iq[1::2] = np.sin(phase)
    return np.clip(np.round(iq * 100.0 + 128.0), 0, 255).astype(np.uint8)


def synth_multiplex_iq(n_samples: int, rf_fs: float = 2.4e6,
                       mono_hz: float = 1.1e3, stereo_hz: float = 2.3e3,
                       pilot_amp: float = 0.1, mono_amp: float = 0.45,
                       stereo_amp: float = 0.45, rds_wave=None,
                       rds_amp: float = 0.25, deviation: float = 75e3,
                       pilot_phase: float = 0.0, quantize: bool = True,
                       rng=None, pilot_hz: float = 19e3,
                       pilot_drift_hz_per_s: float = 0.0,
                       phase_noise_std: float = 0.0,
                       carrier_offset_hz: float = 0.0,
                       ppm: float = 0.0) -> np.ndarray:
    """Interleaved IQ of a synthetic FM stereo station under the
    impairments of a real capture: the same stream, value for value, as
    the multiplex synthesizer of ``tests/oracles.py`` (uint8, or float64
    in [-1, 1] without ``quantize``).

    ``pilot_hz`` detunes the pilot (the 38 and 57 kHz carriers stay
    coherent with it); ``pilot_drift_hz_per_s`` drifts it linearly;
    ``phase_noise_std`` adds a per-sample random-walk phase (radians,
    drawn from ``rng``) to the pilot and its harmonics;
    ``carrier_offset_hz`` detunes the RF carrier; ``ppm`` is a receiver
    sample-clock error, which scales the whole station.
    """
    clock = 1.0 + ppm * 1e-6
    t = np.arange(n_samples) / rf_fs * clock
    pilot_arg = (2 * np.pi * (pilot_hz * t
                              + 0.5 * pilot_drift_hz_per_s * t * t)
                 + pilot_phase)
    if phase_noise_std:
        if rng is None:
            raise ValueError("phase_noise_std needs rng")
        pilot_arg = pilot_arg + np.cumsum(
            phase_noise_std * rng.standard_normal(n_samples))
    m = (mono_amp * np.sin(2 * np.pi * mono_hz * t)
         + pilot_amp * np.cos(pilot_arg)
         + stereo_amp * np.sin(2 * np.pi * stereo_hz * t) * np.cos(2 * pilot_arg))
    if rds_wave is not None:
        t57 = np.arange(len(rds_wave)) / 57e3
        rds_rf = np.interp(t, t57, rds_wave, left=0.0, right=0.0)
        m = m + rds_amp * rds_rf * np.cos(3 * pilot_arg)
    phase = 2 * np.pi * deviation * np.cumsum(m) / rf_fs
    if carrier_offset_hz:
        phase = phase + (2 * np.pi * carrier_offset_hz
                         * np.arange(n_samples) / rf_fs)
    iq = np.empty(2 * n_samples)
    iq[0::2] = np.cos(phase)
    iq[1::2] = np.sin(phase)
    if not quantize:
        return iq
    return np.clip(np.round(iq * 100.0 + 128.0), 0, 255).astype(np.uint8)


def wideband_multiplex(n_pairs: int, n_channels: int, stations: dict,
                       rf_fs: float = 2.4e6, offsets_hz=None) -> np.ndarray:
    """Complex baseband (complex128, ``n_channels * n_pairs`` samples at
    ``fs_w = n_channels * rf_fs``) of one wideband capture: the sum of
    unit-amplitude FM stations, each synthesized directly at the wide rate
    with its carrier at its slot's center ``slot * fs_w / n_channels`` plus
    ``offsets_hz[slot]`` (a station off its slot's center, as on a real
    100 kHz raster).

    ``stations``: {slot: keyword arguments of ``fm_multiplex_iq``};
    ``n_pairs``: IQ pairs per station-rate stream (``blocks * cfg.iq_len``).
    """
    k = n_channels
    fs_w = k * rf_fs
    n = np.arange(k * n_pairs)
    wide = np.zeros(k * n_pairs, np.complex128)
    for slot, station in stations.items():
        off = 0.0 if offsets_hz is None else float(offsets_hz[slot])
        # the slot centers are whole cycles per K samples: reduce the
        # carrier's sample index mod K before scaling, so that its angle
        # keeps full precision over long captures
        carrier = (2 * np.pi * slot / k) * (n % k) + (2 * np.pi * off / fs_w) * n
        wide += np.exp(1j * (_multiplex_phase(k * n_pairs, fs_w, **station)
                             + carrier))
    return wide


def quantize_iq_u8(x: np.ndarray) -> np.ndarray:
    """Complex samples -> interleaved uint8 IQ: scaled down (never up) to a
    peak of 0.95 of full scale, then round(128 * x + 128)."""
    x = x / max(1.0, np.abs(x).max() / 0.95)
    raw = np.empty(2 * len(x))
    raw[0::2] = x.real
    raw[1::2] = x.imag
    return np.clip(np.round(raw * 128 + 128), 0, 255).astype(np.uint8)


def wideband_capture_iq(n_pairs: int, n_channels: int, stations: dict,
                        rf_fs: float = 2.4e6, offsets_hz=None) -> np.ndarray:
    """Interleaved uint8 IQ of a wideband capture (``2 * n_channels *
    n_pairs`` bytes): ``quantize_iq_u8(wideband_multiplex(...))``."""
    return quantize_iq_u8(wideband_multiplex(n_pairs, n_channels, stations,
                                             rf_fs, offsets_hz))


# standard RDS CRC generator g(x) = x^10+x^8+x^7+x^5+x^4+x^3+1 and the
# standard offset words (IEC 62106)
RDS_CRC_POLY = 0b10110111001
RDS_OFFSET_WORDS = {"A": 0b0011111100, "B": 0b0110011000,
                    "C": 0b0101101000, "D": 0b0110110100,
                    "C'": 0b1101010000}


def rds_crc10(info: int) -> int:
    """info(x) * x^10 mod g(x) over GF(2); info is a 16-bit MSB-first int."""
    r = info << 10
    for i in range(25, 9, -1):
        if (r >> i) & 1:
            r ^= RDS_CRC_POLY << (i - 10)
    return r & 0x3FF


def encode_rds_blocks(info_words, cprime: bool = True) -> np.ndarray:
    """A standards-layout RDS bit stream: 26-bit blocks
    [info(16, MSB first) | crc^offset(10)] with offsets cycling A,B,C,D.

    With ``cprime`` (the real transmitter behaviour per IEC 62106), block 3
    of a group whose block B carries version bit 1 is sent with offset word
    C' instead of C.  ``info_words``: iterable of 16-bit values — ints or
    16-element MSB-first bit vectors."""
    names = ["A", "B", "C", "D"]
    bits = []
    version_b = False
    for n, info in enumerate(info_words):
        if np.ndim(info) > 0:
            info = int("".join(str(int(b)) for b in np.asarray(info)), 2)
        info = int(info) & 0xFFFF
        name = names[n % 4]
        if n % 4 == 1:
            version_b = bool((info >> 11) & 1)
        elif n % 4 == 2 and version_b and cprime:
            name = "C'"
        check = rds_crc10(info) ^ RDS_OFFSET_WORDS[name]
        bits.extend((info >> (15 - k)) & 1 for k in range(16))
        bits.extend((check >> (9 - k)) & 1 for k in range(10))
    return np.array(bits, dtype=int)


def rds_baseband(bits, sps: int = 24) -> np.ndarray:
    """Differential-encode, Manchester map, RRC pulse-shape at 57 kS/s.

    Returns samples such that the receiver's matched RRC + ``sps``-spaced
    sampling recovers the symbols.
    """
    # differential encode: tx[t] = tx[t-1] ^ bits[t]
    tx = np.bitwise_xor.accumulate(np.asarray(bits, dtype=int))
    # Manchester: bit 1 -> (+,-), bit 0 -> (-,+)
    symbols = np.empty(2 * len(tx))
    symbols[0::2] = 2.0 * tx - 1.0
    symbols[1::2] = -(2.0 * tx - 1.0)
    # impulse train at symbol rate, RRC shaped
    x = np.zeros(len(symbols) * sps)
    x[::sps] = symbols
    return np.convolve(x, rrc_taps(57e3, 151), mode="full")[: len(x)]


def ps_station_words(n_groups: int, pi: int, ps: str, pty: int = 5) -> list:
    """Info words of ``n_groups`` type-0A groups that spell the 8-character
    program service name ``ps`` (two characters per group, segments
    cycling) for station ``pi``: TP 1, TA 1, music, block C = filler AF
    codes."""
    ps = (ps + " " * 8)[:8]
    words = []
    for g in range(n_groups):
        seg = g % 4
        b = (0 << 12) | (1 << 10) | (pty << 5) | (1 << 4) | (1 << 3) | seg
        d = (ord(ps[2 * seg]) << 8) | ord(ps[2 * seg + 1])
        words.extend([pi, b, (205 << 8) | 205, d])
    return words


def sync_walk_inputs(rng: np.random.Generator, lanes: int, w_max: int,
                     base_pos=None, last_position=None, bad_count=None
                     ) -> dict:
    """Random inputs of the frame layer's resync walk (``pipeline/frame.py::
    resolve_sync``) over ``lanes`` lanes of ``w_max`` windows that reach
    every branch: entry anchors unsynced (-1), on the 26-spaced lattice
    inside the block and behind it; bad counts near the resync threshold
    (10); exact matches at densities from sparse to dense; repairs on the
    lattice and off it; valid tails cut at a random window.  The entry
    integers may be given (a later block of a chained run).  Returns numpy
    arrays: ``sid`` (L, W) int32, ``w_valid`` and ``corr`` (L, W) bool,
    ``base_pos``, ``last_position``, ``bad_count`` (L,) int32."""
    w = np.arange(w_max)
    if base_pos is None:
        base_pos = rng.integers(0, 100_000, lanes)
    if last_position is None:
        kind = np.arange(lanes) % 3
        last_position = np.select(
            [kind == 0, kind == 1],
            [np.full(lanes, -1),
             base_pos - 26 + rng.integers(0, w_max, lanes)],
            base_pos - 26 - rng.integers(1, 200, lanes))
    if bad_count is None:
        bad_count = rng.choice([0, 5, 8, 9, 10], lanes)
    density = rng.choice([0.05, 0.2, 0.5, 0.9], lanes)[:, None]
    sid = (rng.random((lanes, w_max)) < density) * rng.integers(
        1, 6, (lanes, w_max))
    # the lattice of the entry anchor, or of the first match where the lane
    # enters unsynced: mostly matched, else often repaired
    first = np.argmax(sid > 0, axis=-1)
    anchor = np.where(last_position >= 0, last_position, base_pos + first)
    lattice = ((base_pos[:, None] + w - anchor[:, None]) % 26 == 0) & (
        base_pos[:, None] + w > anchor[:, None])
    hit = rng.random((lanes, w_max))
    sid = np.where(lattice & (hit < 0.6), rng.integers(1, 6, (lanes, w_max)),
                   np.where(lattice, 0, sid))
    corr = (lattice & (hit >= 0.6) & (hit < 0.85)) | (
        (rng.random((lanes, w_max)) < 0.15) & (sid == 0))
    n_windows = np.where(rng.random(lanes) < 0.5, w_max,
                         rng.integers(1, w_max + 1, lanes))
    return dict(sid=sid.astype(np.int32), w_valid=w < n_windows[:, None],
                corr=corr & (sid == 0), base_pos=base_pos.astype(np.int32),
                last_position=last_position.astype(np.int32),
                bad_count=bad_count.astype(np.int32))
