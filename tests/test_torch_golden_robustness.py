"""Receiver robustness through the port's receiver (CPU, float32): long
streams, noise, a detuned station, garbage input, the stereo blend.

Port counterparts of the first tests of ``tests/test_robustness.py`` (the
JAX test's stations and thresholds; ``_noisy_station`` is the JAX test's
own builder).  The rest of that file is in
``test_torch_golden_robustness_ec.py`` (error correction, the divided PLL
loop), ``test_torch_golden_gardner.py`` (Gardner under combined
impairments) and ``test_torch_golden_campaign.py`` (the decode-campaign
tier); ``test_gardner_gain_is_derived`` is in
``test_torch_golden_frame.py``.
"""

import numpy as np
import torch

from oracles import encode_rds_blocks, rds_baseband, synth_multiplex_iq
from rtsdr_tpu_torch.config import MODE0
from rtsdr_tpu_torch.pipeline.receiver import make_receiver
from test_robustness import _noisy_station

torch.set_num_threads(1)

STEREO_TONE = 2 * np.pi * 75e3 * 0.45 / 240e3


def _blocks(iq_u8, n_blocks, cfg=MODE0):
    """(n_blocks, ..., block_size) of one stream (n,) or of rows (C, n)."""
    bs = cfg.block_size
    return [torch.as_tensor(np.ascontiguousarray(
        iq_u8[..., b * bs:(b + 1) * bs])) for b in range(n_blocks)]


def _run(iq_u8, n_blocks, cfg=MODE0, **kw):
    """The port's receiver (float32, absolute clock, as the JAX test's
    ``_run``) -> (syncs per block, concatenated left audio)."""
    init_fn, step = make_receiver(cfg, dtype=torch.float32,
                                  use_abs_clock=True, device="cpu", **kw)
    state = init_fn()
    syncs, audio = [], []
    for raw in _blocks(iq_u8, n_blocks, cfg):
        state, out = step(state, raw)
        syncs.append(int(out.rds.is_sync.sum()))
        audio.append(out.left.numpy())
    return syncs, np.concatenate(audio, axis=-1)


def _tone_amp(x, f_tone, fs=48e3):
    t = np.arange(x.shape[-1]) / fs
    return np.hypot(2 * np.mean(x * np.sin(2 * np.pi * f_tone * t), -1),
                    2 * np.mean(x * np.cos(2 * np.pi * f_tone * t), -1))


def test_long_stream_sync_holds():
    """12 blocks: after lock every block keeps producing 26-spaced syncs."""
    n_blocks = 12
    iq = _noisy_station(n_blocks, noise_rms=0.0)
    syncs, audio = _run(iq, n_blocks)
    assert all(s >= 2 for s in syncs[2:]), syncs
    assert not np.any(np.isnan(audio))


def test_noisy_station_still_decodes():
    """IQ AWGN at ~14 dB carrier SNR: RDS keeps syncing, mono tone
    dominant."""
    n_blocks = 8
    iq = _noisy_station(n_blocks, noise_rms=0.2)
    syncs, audio = _run(iq, n_blocks)
    assert sum(syncs[2:]) >= (n_blocks - 2), syncs
    assert not np.any(np.isnan(audio))
    assert _tone_amp(audio[2 * MODE0.audio_len:], 1.1e3) > 0.3


def test_detuned_station_decodes():
    """Pilot +40 Hz, 50 ppm clock error, 5 kHz tuner offset, phase noise:
    RDS keeps syncing (with resync) and stereo separation survives."""
    n_blocks = 8
    rng = np.random.default_rng(0x515)
    bits = encode_rds_blocks(rng.integers(0, 2, (40 * n_blocks, 16)))
    wave = rds_baseband(bits)
    n = n_blocks * MODE0.block_size // 2
    iq = synth_multiplex_iq(n, rds_wave=wave, pilot_hz=19e3 + 40.0, ppm=50.0,
                            carrier_offset_hz=5e3, phase_noise_std=5e-4,
                            rng=rng)
    syncs, audio = _run(iq, n_blocks, resync=True)
    assert all(s >= 1 for s in syncs[5:]), f"RDS lost sync: {syncs}"
    assert sum(syncs[4:]) >= 8, f"RDS did not recover: {syncs}"
    assert not np.any(np.isnan(audio))

    init_fn, step = make_receiver(MODE0, dtype=torch.float32,
                                  enable_rds=False, device="cpu")
    state = init_fn()
    l_all, r_all = [], []
    for raw in _blocks(iq, n_blocks):
        state, out = step(state, raw)
        l_all.append(out.left.numpy())
        r_all.append(out.right.numpy())
    diff = (np.concatenate(l_all) - np.concatenate(r_all))[2 * MODE0.audio_len:]
    amp = _tone_amp(diff, 2.3e3 * (1 + 50e-6))
    assert amp > 0.8 * STEREO_TONE, (
        f"stereo separation lost under detuning: {amp} vs {STEREO_TONE}")


def test_heavy_noise_no_crash():
    """Garbage-dominated input: no NaNs, no exceptions, bounded audio."""
    n_blocks = 3
    iq = _noisy_station(n_blocks, noise_rms=1.5)
    syncs, audio = _run(iq, n_blocks, resync=True)
    assert not np.any(np.isnan(audio))
    assert np.all(np.abs(audio) < 1e3)


def test_stereo_blend_fades_weak_pilot():
    """stereo_blend: full separation on a nominal pilot, mono when the
    pilot is absent.  The two stations (pilot 0.1 and 0.0) are the two rows
    of one batched receiver."""
    n_blocks = 3
    pilots = (0.1, 0.0)
    rows = []
    for pilot_amp in pilots:
        iq = synth_multiplex_iq(n_blocks * MODE0.block_size // 2,
                                pilot_amp=pilot_amp, quantize=False)
        rows.append(np.clip(np.round(iq * 100.0 + 128.0), 0, 255
                            ).astype(np.uint8))
    init_fn, step = make_receiver(MODE0, (2,), torch.float32,
                                  enable_rds=False, stereo_blend=True,
                                  device="cpu")
    state = init_fn()
    l_all, r_all = [], []
    for raw in _blocks(np.stack(rows), n_blocks):
        state, out = step(state, raw)
        l_all.append(out.left.numpy())
        r_all.append(out.right.numpy())
    diff = (np.concatenate(l_all, -1)
            - np.concatenate(r_all, -1))[:, MODE0.audio_len:]
    amps = dict(zip(pilots, _tone_amp(diff, 2.3e3)))
    assert amps[0.1] > 0.9 * STEREO_TONE, f"blend hurt a good station: {amps}"
    assert amps[0.0] < 0.05 * STEREO_TONE, f"weak-pilot stereo leaked: {amps}"
