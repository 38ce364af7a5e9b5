"""Quality gate of the PLL loop-rate division through the port's PLL
(CPU): the stereo pilot over div x SNR and the RDS carrier at div 2 and 4.

Port counterpart of ``tests/test_pll_envelope.py``: the same tones, noise
draws, band-passes, detunes, block count and thresholds, with
``rtsdr_tpu_torch.ops.fir.fir_block`` + ``rtsdr_tpu_torch.ops.pll.pll`` in
place of the JAX functions.  The JAX test calls its PLL once per
(detune set, SNR, div); here the signal sets that share a loop
configuration run as rows of ONE batched call (each row is its own loop,
computed exactly as it would be alone), and each (set, div) is computed
once per module — the plain loop costs about a second per block on the
CPU whatever the number of rows.
"""

import numpy as np
import pytest
import torch

from rtsdr_tpu_torch.config import MODE0
from rtsdr_tpu_torch.ops import coeffs
from rtsdr_tpu_torch.ops.fir import fir_block, fir_zi
from rtsdr_tpu_torch.ops.pll import pll, pll_init

torch.set_num_threads(1)

FS = MODE0.rf.if_fs
N = MODE0.if_len
BLOCKS = 6


def _loop(name):
    if name == "stereo":
        s = MODE0.stereo
        return (s.pll.freq, s.pilot_lo, s.pilot_hi, s.taps, s.pll.nco_scale,
                s.pll.norm_bandwidth)
    r = MODE0.rds
    return (r.pll.freq, r.squared_lo, r.squared_hi, r.taps, r.pll.nco_scale,
            r.pll.norm_bandwidth)


def _signals(name, detunes_hz, snr_db, seed):
    """The JAX test's input rows for one (detunes, SNR, seed) set."""
    f0, lo, hi, _, _, _ = _loop(name)
    rng = np.random.default_rng(seed)
    t = np.arange(BLOCKS * N) / FS
    sig = np.zeros((len(detunes_hz), BLOCKS * N), np.float32)
    for k, d in enumerate(detunes_hz):
        x = np.cos(2 * np.pi * (f0 + d) * t)
        if snr_db is not None:
            sigma = np.sqrt(0.5 / 10 ** (snr_db / 10) * (FS / 2)
                            / (hi - lo))
            x = x + sigma * rng.standard_normal(len(t))
        sig[k] = x.astype(np.float32)
    return sig


def _lock_amps(name, div, sets):
    """Last-block lock amplitude of every row of every set in ``sets``
    (tuples (detunes, snr_db, seed)), all rows in one PLL call."""
    f0, lo, hi, taps, scale, bw = _loop(name)
    h = coeffs.bandpass_taps(FS, lo, hi, taps)
    sig = np.concatenate([_signals(name, d, s, seed) for d, s, seed in sets])
    detunes = np.concatenate([d for d, _, _ in sets])
    c = len(sig)
    zi = fir_zi(taps, (c,), torch.float32, "cpu")
    st = pll_init((c,), torch.float32, "cpu")
    for b in range(BLOCKS):
        f, zi = fir_block(torch.as_tensor(sig[:, b * N:(b + 1) * N]), h, zi)
        ni, nq, st = pll(f, st, freq=f0, fs=FS, nco_scale=scale,
                         norm_bandwidth=bw, impl="auto", loop_div=div)
    ni = ni.numpy().astype(np.float64)
    nq = nq.numpy().astype(np.float64)
    tb = np.arange((BLOCKS - 1) * N, BLOCKS * N) / FS
    amps = np.array([
        np.abs(((ni[k] + 1j * nq[k])
                * np.exp(-2j * np.pi * (f0 + d) * scale * tb)).mean())
        for k, d in enumerate(detunes)])
    out, k = [], 0
    for d, _, _ in sets:
        out.append(amps[k:k + len(d)])
        k += len(d)
    return out


STEREO_DETUNES = np.array([-200.0, 0.0, 200.0])
SNRS = (None, 10.0)


@pytest.fixture(scope="module")
def stereo_amps():
    """{(div, snr): amplitudes}: seed 11, clean and 10 dB, div 1 / 2 / 4."""
    out = {}
    for div in (1, 2, 4):
        sets = [(STEREO_DETUNES, snr, 11) for snr in SNRS]
        for snr, amps in zip(SNRS, _lock_amps("stereo", div, sets)):
            out[div, snr] = amps
    return out


@pytest.mark.parametrize("div", [2, 4])
@pytest.mark.parametrize("snr_db", [None, 10.0])
def test_stereo_pilot_envelope(stereo_amps, div, snr_db):
    """Stereo pilot loop: div 2/4 within 0.05 lock amplitude of div=1
    across +/-200 Hz, clean and at 10 dB in-band SNR (same noise)."""
    base = stereo_amps[1, snr_db]
    amps = stereo_amps[div, snr_db]
    assert np.all(base > 0.7), base       # div=1 itself locked
    assert np.all(amps > base - 0.05), (amps, base)


def test_rds_carrier_envelope_div2():
    """RDS carrier loop at div=2 acquires to +/-500 Hz on a clean signal."""
    (amps,) = _lock_amps("rds", 2, [(np.array([-500.0, 0.0, 500.0]),
                                     None, 12)])
    assert np.all(amps > 0.95), amps


def test_rds_carrier_envelope_div4():
    """RDS carrier loop at div=4: +/-200 Hz holds; the -1000 Hz clean
    corner does NOT acquire (why div=4 stays opt-in for RDS)."""
    amps, wide = _lock_amps("rds", 4, [
        (np.array([-200.0, 0.0, 200.0]), None, 13),
        (np.array([-1000.0]), None, 13)])
    assert np.all(amps > 0.95), amps
    assert wide[0] < 0.5, "div=4 acquired at -1000 Hz: the envelope " \
        "documented in PERF.md is stale, consider widening it"
