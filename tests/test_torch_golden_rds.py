"""The port's RDS DSP chain and bit layer against the golden oracles,
end-to-end RDS decode, and de-emphasis through the port's receiver (CPU,
float64 as in the JAX tests).

Port counterparts of ``tests/test_pipeline_rds.py`` and
``tests/test_deemphasis_pipeline.py``: the same synthetic multiplex and
golden chains (``tests/oracles.py``), the same thresholds.
"""

import numpy as np
import pytest
import torch
from scipy import signal

from oracles import (
    GoldenFrameDecoder,
    encode_rds_blocks,
    golden_mono_stereo,
    golden_rds_dsp,
    rds_baseband,
    synth_multiplex_iq,
)
from rtsdr_tpu_torch.config import MODE0
from rtsdr_tpu_torch.ops.iir import deemphasis_coeffs
from rtsdr_tpu_torch.pipeline.frame import frame_init, frame_sizes, make_frame
from rtsdr_tpu_torch.pipeline.rds import make_rds, rds_init
from rtsdr_tpu_torch.pipeline.receiver import make_receiver

torch.set_num_threads(1)
F64 = torch.float64


def _u8(x):
    return torch.as_tensor(np.ascontiguousarray(x))


# ------------------------------------------ tests/test_pipeline_rds.py

@pytest.fixture(scope="module")
def rds_setup():
    rng = np.random.default_rng(0x5757)
    n_blocks = 4
    info = rng.integers(0, 2, size=(40, 16))
    wave = rds_baseband(encode_rds_blocks(info))
    iq_u8 = synth_multiplex_iq(n_blocks * 307200 // 2, rds_wave=wave)
    fm = golden_mono_stereo(iq_u8, n_blocks)["fm"]
    fm_blocks = [fm[b * 15360:(b + 1) * 15360] for b in range(n_blocks)]
    return iq_u8, fm_blocks, golden_rds_dsp(fm_blocks), n_blocks


# the first sample of block 0 held to the golden chain: past the zero-input
# detector kick's transient (its last sample above 2e-7 is 1,397 in I and
# 2,250 in Q), with a margin; the JAX test starts at sample 600
BLOCK0_FROM = 2560


def test_rds_dsp_matches_golden_chain(rds_setup):
    """The port's RDS DSP chain against the golden one at the JAX test's
    2e-7: blocks 1.. whole, block 0 from sample ``BLOCK0_FROM``.  (From the
    zero state the carrier loop is fed samples of exactly 0, where the
    golden model's literal atan2 detector kicks by pi and the port, like
    the kernels, does not — ROADMAP Queue C, known reference faults; block
    0 then parts by ~3e-5 in I and ~2e-3 in Q from sample 600, by ~2e-8
    from ``BLOCK0_FROM``.)"""
    _, fm_blocks, rrc_ref, n_blocks = rds_setup
    rds = make_rds(MODE0)
    state = rds_init(MODE0, dtype=F64, device="cpu")
    for b in range(n_blocks):
        (rrc_i, rrc_q), state = rds(state, torch.as_tensor(fm_blocks[b]))
        ref_i, ref_q = rrc_ref[b]
        lo = BLOCK0_FROM if b == 0 else 0
        assert len(ref_i) > lo
        np.testing.assert_allclose(rrc_i.numpy()[lo:], ref_i[lo:],
                                   atol=2e-7, err_msg=f"block {b} I")
        np.testing.assert_allclose(rrc_q.numpy()[lo:], ref_q[lo:],
                                   atol=2e-7, err_msg=f"block {b} Q")


@pytest.mark.parametrize("offset_mode", ["track", "hold"])
def test_frame_layer_matches_golden(rds_setup, offset_mode):
    """The golden chain's RRC blocks into the golden bit layer and into the
    port's: symbol streams and syndrome events agree exactly."""
    _, _, rrc_ref, n_blocks = rds_setup
    golden = GoldenFrameDecoder(offset_mode=offset_mode)
    frame_fn = make_frame(MODE0, offset_mode=offset_mode)
    state = frame_init(MODE0, dtype=F64, device="cpu")
    names = {1: "A", 2: "B", 3: "C", 4: "D", 5: "C'"}
    for b in range(n_blocks):
        ri, rq = rrc_ref[b]
        ref_symbols, ref_events = golden.step(ri, rq)
        out, state = frame_fn(state, torch.as_tensor(ri),
                              torch.as_tensor(rq))
        n_sym = int(out.n_sym)
        assert n_sym == len(ref_symbols), f"block {b} symbol count"
        np.testing.assert_allclose(out.symbols_i.numpy()[:n_sym],
                                   ref_symbols, atol=0,
                                   err_msg=f"block {b} symbols")
        ours = [(names[int(out.syndrome_id[w])], int(out.positions[w]),
                 bool(out.is_sync[w]))
                for w in range(int(out.n_windows)) if int(out.syndrome_id[w])]
        assert ours == ref_events, f"block {b} events"


def test_end_to_end_rds_decode(rds_setup):
    """The port's full receiver on the synthetic multiplex: after the
    carrier-lock block, frame sync finds a run of 26-bit-spaced syndromes."""
    iq_u8, _, _, n_blocks = rds_setup
    init_fn, step = make_receiver(MODE0, dtype=F64, offset_mode="hold",
                                  use_abs_clock=True, device="cpu")
    state = init_fn()
    bs = MODE0.block_size
    state, _ = step(state, _u8(iq_u8[:bs]))
    state = state._replace(frame=frame_init(MODE0, dtype=F64, device="cpu"))
    syncs = []
    for b in range(1, n_blocks):
        state, out = step(state, _u8(iq_u8[b * bs:(b + 1) * bs]))
        fo = out.rds
        for w in range(int(fo.n_windows)):
            if int(fo.syndrome_id[w]) and bool(fo.is_sync[w]):
                syncs.append(int(fo.positions[w]))
    assert len(syncs) >= 5, f"too few syncs: {syncs}"
    spacings = np.diff(syncs)
    assert np.all(spacings % 26 == 0), f"bad spacing: {spacings}"
    assert np.mean(spacings == 26) > 0.6, f"sparse syncs: {spacings}"


def test_frame_sizes():
    s_max, b_max, e_max, w_max = frame_sizes(MODE0)
    assert s_max == MODE0.rds_len // 24 == 152
    assert b_max == 76 and e_max == 103 and w_max == 77


# ------------------------------------ tests/test_deemphasis_pipeline.py

def test_receiver_deemphasis_equals_post_filter():
    """deemphasis=tau inside the receiver == lfilter on the plain output."""
    iq = synth_multiplex_iq(2 * MODE0.block_size // 2)
    bs = MODE0.block_size

    def run(**kw):
        init_fn, step = make_receiver(MODE0, dtype=F64, enable_rds=False,
                                      device="cpu", **kw)
        state = init_fn()
        left = []
        for b in range(2):
            state, out = step(state, _u8(iq[b * bs:(b + 1) * bs]))
            left.append(out.left.numpy())
        return np.concatenate(left)

    plain = run()
    de = run(deemphasis=75e-6)
    b, a = deemphasis_coeffs(48e3, 75e-6)
    ref = signal.lfilter([b], [1.0, -a], plain)
    np.testing.assert_allclose(de, ref, rtol=1e-9, atol=1e-10)
