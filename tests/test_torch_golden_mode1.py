"""Mode 1 (2.5 MS/s, ↑24/↓125 audio) and MODE1_RDS through the port's
receiver, against the golden chain at mode-1 rates and the RDS payload
(CPU).

Port counterparts of ``tests/test_mode1_parity.py`` (float64, the JAX
test's golden chain ``golden_mode1`` and its 1e-7) and
``tests/test_mode1_rds.py`` (float32, 14 blocks, the same group / PI / PS
/ clock-time assertions).
"""

import numpy as np
import torch

from oracles import encode_rds_blocks, rds_baseband, synth_multiplex_iq
from rtsdr_tpu_torch.config import MODE1, MODE1_RDS
from rtsdr_tpu_torch.pipeline.groups import GroupDecoder
from rtsdr_tpu_torch.pipeline.receiver import make_receiver
from test_groups import _CT_DATE, _make_station_groups
from test_mode1_parity import golden_mode1

torch.set_num_threads(1)


def _blocks(iq, cfg, n_blocks):
    bs = cfg.block_size
    return [torch.as_tensor(np.ascontiguousarray(iq[b * bs:(b + 1) * bs]))
            for b in range(n_blocks)]


def test_mode1_matches_golden_chain():
    n_blocks = 2
    iq_u8 = synth_multiplex_iq(n_blocks * MODE1.block_size // 2, rf_fs=2.5e6)
    ref = golden_mode1(iq_u8, n_blocks)
    init_fn, step = make_receiver(MODE1, dtype=torch.float64, device="cpu")
    state = init_fn()
    outs = []
    for raw in _blocks(iq_u8, MODE1, n_blocks):
        state, out = step(state, raw)
        outs.append(out.left.numpy())
    ours = np.concatenate(outs)
    # skip the start-of-stream unwrap-boundary warm-up, as the JAX test
    np.testing.assert_allclose(ours[500:], ref[500:], rtol=0, atol=1e-7)


def test_mode1_rds_decodes_groups():
    assert MODE1_RDS.rds_len == 3648           # exact 57 kS/s grid
    assert MODE1_RDS.rds_len % MODE1_RDS.rds.sps == 0

    n_blocks = 14
    words = _make_station_groups(40 * n_blocks)
    wave = rds_baseband(encode_rds_blocks(words))
    iq = synth_multiplex_iq(n_blocks * MODE1_RDS.block_size // 2,
                            rf_fs=2.5e6, rds_wave=wave,
                            rng=np.random.default_rng(0x6A))
    init_fn, step = make_receiver(MODE1_RDS, dtype=torch.float32,
                                  use_abs_clock=True, device="cpu")
    state = init_fn()
    dec = GroupDecoder()
    for raw in _blocks(iq, MODE1_RDS, n_blocks):
        state, out = step(state, raw)
        dec.feed(type(out.rds)(*(x.numpy() for x in out.rds)))

    assert len(dec.groups) >= 7, f"only {len(dec.groups)} groups assembled"
    assert dec.pi == 0x3A5C
    assert dec.ps_name == "TPU RDIO"
    assert dec.clock is not None
    assert (dec.clock.year, dec.clock.month, dec.clock.day) == _CT_DATE[:3]
    positions = [g.position for g in dec.groups]
    assert np.all(np.diff(positions) % 26 == 0)
