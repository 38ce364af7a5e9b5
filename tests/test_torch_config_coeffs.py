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
