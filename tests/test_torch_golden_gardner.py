"""The Gardner timing loop under combined impairments through the port's
full receiver (CPU, float32), MODE0 and MODE1_RDS.

Port counterpart of ``tests/test_robustness.py::
test_gardner_survives_combined_impairments``: 250 ppm clock skew, IQ
noise, +40 Hz pilot detune and phase noise over 16 blocks; 'gardner' keeps
frame sync to the end (>= 10 syncs in the last 5 blocks), 'hold' has slid
off the symbol peaks (<= 3).
"""

import numpy as np
import pytest
import torch

import rtsdr_tpu_torch.config as C
from oracles import encode_rds_blocks, rds_baseband, synth_multiplex_iq
from test_torch_golden_robustness import _run

torch.set_num_threads(1)


@pytest.mark.parametrize("cfg_name", ["MODE0", "MODE1_RDS"])
def test_gardner_survives_combined_impairments(cfg_name):
    cfg = getattr(C, cfg_name)
    n_blocks = 16
    rng = np.random.default_rng(0x914)
    bits = encode_rds_blocks(rng.integers(0, 2, (40 * n_blocks, 16)))
    wave = rds_baseband(bits)
    n = n_blocks * cfg.block_size // 2
    iq = synth_multiplex_iq(n, rf_fs=cfg.rf.fs, rds_wave=wave, ppm=250.0,
                            pilot_hz=19e3 + 40.0, phase_noise_std=3e-4,
                            rng=rng, quantize=False)
    iq = iq + 0.10 * rng.standard_normal(len(iq))
    iq = np.clip(np.round(iq * 100.0 + 128.0), 0, 255).astype(np.uint8)

    gard, _ = _run(iq, n_blocks, cfg, resync=True, offset_mode="gardner")
    hold, _ = _run(iq, n_blocks, cfg, resync=True, offset_mode="hold")
    assert sum(gard[-5:]) >= 10, f"gardner lost sync: {gard}"
    assert sum(hold[-5:]) <= 3, f"hold unexpectedly survived: {hold}"
