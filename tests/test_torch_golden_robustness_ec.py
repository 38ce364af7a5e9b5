"""Burst error correction under impulsive interference and the divided
PLL loop on a detuned station, through the port's receiver (CPU, float32).

Port counterparts of ``tests/test_robustness.py::
test_error_correction_raises_yield_under_clicks`` and
``::test_pll_loop_div_full_chain_quality`` (same streams and thresholds;
the full-rate receiver's run, which the JAX test repeats for each div, is
made once per module).
"""

import numpy as np
import pytest
import torch

from oracles import encode_rds_blocks, rds_baseband, synth_multiplex_iq
from rtsdr_tpu_torch.config import MODE0
from rtsdr_tpu_torch.pipeline.receiver import make_receiver
from test_torch_golden_robustness import _blocks, _run

torch.set_num_threads(1)


def test_error_correction_raises_yield_under_clicks():
    """Strong ~0.6 ms clicks make 1-2 bit bursts; error_correct repairs
    them and raises the sync yield by at least 5."""
    n_blocks = 10
    rng = np.random.default_rng(0x404)
    bits = encode_rds_blocks(rng.integers(0, 2, (40 * n_blocks, 16)))
    wave = rds_baseband(bits)
    n = n_blocks * MODE0.block_size // 2
    iq = synth_multiplex_iq(n, rds_wave=wave, quantize=False)
    click = 1500
    starts = rng.integers(MODE0.block_size, len(iq) // 2 - click, 8) * 2
    for s in starts:
        iq[s:s + 2 * click] += 2.5 * rng.standard_normal(2 * click)
    u8 = np.clip(np.round(iq * 100.0 + 128.0), 0, 255).astype(np.uint8)

    def run(ec):
        init_fn, step = make_receiver(MODE0, dtype=torch.float32,
                                      use_abs_clock=True, resync=True,
                                      error_correct=ec, device="cpu")
        state = init_fn()
        syncs = corrected = 0
        for raw in _blocks(u8, n_blocks):
            state, out = step(state, raw)
            syncs += int(out.rds.is_sync.sum())
            corrected += int(out.rds.corrected.sum())
        return syncs, corrected

    syncs_off, corr_off = run(False)
    syncs_on, corr_on = run(True)
    assert corr_off == 0
    assert corr_on >= 1, f"EC never fired: {corr_on}"
    assert syncs_on >= syncs_off + 5, (
        f"EC did not raise yield: {syncs_on} vs {syncs_off}")


N_DIV_BLOCKS = 6


@pytest.fixture(scope="module")
def detuned_full_rate():
    rng = np.random.default_rng(0x517)
    bits = encode_rds_blocks(rng.integers(0, 2, (40 * N_DIV_BLOCKS, 16)))
    wave = rds_baseband(bits)
    n = N_DIV_BLOCKS * MODE0.block_size // 2
    iq = synth_multiplex_iq(n, rds_wave=wave, pilot_hz=19e3 + 40.0,
                            phase_noise_std=5e-4, rng=rng)
    return iq, _run(iq, N_DIV_BLOCKS)


@pytest.mark.parametrize("div", [2, 4])
def test_pll_loop_div_full_chain_quality(detuned_full_rate, div):
    """The divided-loop receiver keeps RDS sync and its post-lock audio is
    within 30 dB SNR of the full-rate receiver's."""
    iq, (_, audio_full) = detuned_full_rate
    syncs_div, audio_div = _run(iq, N_DIV_BLOCKS, pll_loop_div=div)
    assert all(s >= 1 for s in syncs_div[2:]), (
        f"div={div} RDS lost sync: {syncs_div}")
    a = audio_full[2 * MODE0.audio_len:]
    b = audio_div[2 * MODE0.audio_len:]
    err = np.sqrt(np.mean((a - b) ** 2))
    sig = np.sqrt(np.mean(a ** 2))
    snr_db = 20 * np.log10(sig / max(err, 1e-30))
    assert snr_db > 30, f"div={div}: audio SNR vs full-rate {snr_db:.1f} dB"
