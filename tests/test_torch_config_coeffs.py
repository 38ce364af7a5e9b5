"""The port's own copies of the mode tables and tap designs equal the JAX
package's: configs field for field, taps bitwise in float64."""

import dataclasses

import numpy as np
import pytest

from rtsdr_tpu import config as jcfg
from rtsdr_tpu.ops import coeffs as jcoeffs
from rtsdr_tpu_torch import config as tcfg
from rtsdr_tpu_torch.ops import coeffs as tcoeffs


@pytest.mark.parametrize("name", ["MODE0", "MODE1", "MODE1_RDS"])
def test_mode_tables_equal(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for prop in ("iq_len", "if_len", "audio_len", "audio_fs"):
        assert getattr(j, prop) == getattr(t, prop)
    if j.rds is not None:
        assert j.rds_len == t.rds_len
        assert j.max_symbols == t.max_symbols


def test_modes_dict():
    assert set(jcfg.MODES) == set(tcfg.MODES)
    for k in jcfg.MODES:
        assert dataclasses.asdict(jcfg.MODES[k]) == \
            dataclasses.asdict(tcfg.MODES[k])


@pytest.mark.parametrize("fs,fc,taps", [(2.4e6, 100e3, 151), (240e3, 16e3, 151),
                                        (6e6, 16e3, 3624), (57e3, 3e3, 1)])
def test_lowpass_taps_bitwise(fs, fc, taps):
    a, b = jcoeffs.lowpass_taps(fs, fc, taps), tcoeffs.lowpass_taps(fs, fc, taps)
    assert a.dtype == b.dtype == np.float64
    assert np.array_equal(a, b)


@pytest.mark.parametrize("lo,hi", [(18.5e3, 19.5e3), (22e3, 54e3),
                                   (54e3, 60e3), (113.5e3, 114.5e3)])
def test_bandpass_taps_bitwise(lo, hi):
    a = jcoeffs.bandpass_taps(240e3, lo, hi, 151)
    b = tcoeffs.bandpass_taps(240e3, lo, hi, 151)
    assert a.dtype == b.dtype == np.float64
    assert np.array_equal(a, b)


@pytest.mark.parametrize("taps", [151, 150])
def test_rrc_taps_bitwise(taps):
    a, b = jcoeffs.rrc_taps(57e3, taps), tcoeffs.rrc_taps(57e3, taps)
    assert np.array_equal(a, b)


def test_signal_copies_equal(rng):
    """The port's test-signal generators equal the JAX package's, and its
    RDS encoder / pulse shaper / RDS-bearing multiplex equal the test
    oracle's byte for byte."""
    import oracles
    from rtsdr_tpu.utils import signals as jsig
    from rtsdr_tpu_torch.utils import signals as tsig

    assert np.array_equal(tsig.fm_multiplex_iq(5000), jsig.fm_multiplex_iq(5000))
    assert np.array_equal(tsig.generate_sin(48e3, 1e3, 100, 0.5, 0.1),
                          jsig.generate_sin(48e3, 1e3, 100, 0.5, 0.1))
    info = rng.integers(0, 2, (24, 16))
    words = tsig.ps_station_words(12, 0x1B2C, "CPRIME 8")
    words[5] |= 1 << 11                      # one version-B group: C'
    for w in (info, words):
        for cprime in (True, False):
            assert np.array_equal(tsig.encode_rds_blocks(w, cprime=cprime),
                                  oracles.encode_rds_blocks(w, cprime=cprime))
    for v in (0, 1, 0x3A5C, 0xFFFF):
        assert tsig.rds_crc10(v) == oracles.rds_crc10(v)
    assert tsig.RDS_OFFSET_WORDS == oracles.RDS_OFFSET_WORDS
    bits = tsig.encode_rds_blocks(info)
    wave = tsig.rds_baseband(bits)
    assert np.array_equal(wave, oracles.rds_baseband(bits))
    n = 2 * 153600
    assert np.array_equal(
        tsig.fm_multiplex_iq(n, rds_wave=wave),
        oracles.synth_multiplex_iq(n, rds_wave=wave))
    assert np.array_equal(
        tsig.fm_multiplex_iq(n, rds_wave=wave, rds_amp=0.1, pilot_phase=0.5),
        oracles.synth_multiplex_iq(n, rds_wave=wave, rds_amp=0.1,
                                   pilot_phase=0.5))


def test_ps_station_words_decode_to_their_name():
    from rtsdr_tpu.pipeline.groups import GroupDecoder
    from rtsdr_tpu_torch.utils.signals import ps_station_words

    from test_groups import _push_group

    dec = GroupDecoder()
    words = ps_station_words(8, 0x3A5C, "H100 FM ")
    for g in range(8):
        _push_group(dec, *words[4 * g:4 * g + 4], 104 * g)
    assert dec.pi == 0x3A5C and dec.ps_name == "H100 FM "
    assert dec.ta == 1 and dec.ms == 1


def test_wideband_synthesizer_places_stations(rng):
    """``wideband_multiplex``: each station is its narrow-band multiplex at
    its slot's center plus its offset.  Mixed back down and decimated by K,
    slot 1's stream equals the station synthesized alone at the station
    rate (same formula sampled K times finer: equal where the grids meet,
    up to the finer rectangle rule of the phase integral)."""
    from rtsdr_tpu_torch.utils import signals as tsig

    k, n = 4, 6000
    off = [0.0, 150e3, 0.0, 0.0]
    wide = tsig.wideband_multiplex(n, k, {1: dict(mono_hz=900.0)}, 2.4e6, off)
    assert wide.shape == (k * n,) and wide.dtype == np.complex128
    np.testing.assert_allclose(np.abs(wide), 1.0, atol=1e-12)
    idx = np.arange(k * n)
    base = wide * np.exp(-2j * np.pi * (2.4e6 + 150e3) * idx / (k * 2.4e6))
    alone = tsig._multiplex_phase(n, 2.4e6, mono_hz=900.0)
    err = np.angle(base[::k] * np.exp(-1j * alone))
    # a constant lag of part of a sample, no drift
    assert np.ptp(err) < 0.2 and abs(err[-1] - err[n // 2]) < 0.2
    two = tsig.wideband_multiplex(n, k, {1: {}, 3: dict(mono_hz=700.0)})
    assert 1.5 < np.abs(two).max() <= 2.0
    raw = tsig.quantize_iq_u8(two)
    assert raw.dtype == np.uint8 and raw.shape == (2 * k * n,)
    assert 0.9 * 128 < raw.astype(int).max() - 128 <= 0.95 * 128 + 1
    assert np.array_equal(raw, tsig.wideband_capture_iq(
        n, k, {1: {}, 3: dict(mono_hz=700.0)}))
    # scaled down only, never up
    quiet = tsig.quantize_iq_u8(0.25 * two[:100] / np.abs(two[:100]).max())
    assert np.abs(quiet.astype(int) - 128).max() <= 33


def test_multiplex_pilot_hz_equals_oracle():
    import oracles
    from rtsdr_tpu_torch.utils import signals as tsig

    assert np.array_equal(
        tsig.fm_multiplex_iq(4000, 2.5e6, pilot_hz=19.3e3, mono_amp=0.9),
        oracles.synth_multiplex_iq(4000, rf_fs=2.5e6, pilot_hz=19.3e3,
                                   mono_amp=0.9))
