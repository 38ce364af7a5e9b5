"""The port's RDS bit layer against the golden decoder on crafted symbol
streams, and its clock-recovery modes under sample-clock skew (CPU).

Port counterparts of ``tests/test_frame_edges.py`` and
``tests/test_clock_recovery.py``: the same crafted / skewed streams (the
JAX tests' own builders), ``rtsdr_tpu_torch.pipeline.frame`` in place of
the JAX frame layer, every threshold as in the JAX test.  No PLL runs
here: the inputs are RRC-domain blocks.
"""

import numpy as np
import pytest
import torch

from oracles import GoldenFrameDecoder, encode_rds_blocks
from rtsdr_tpu_torch.config import MODE0
from rtsdr_tpu_torch.pipeline.frame import (
    frame_init,
    gardner_gain,
    make_frame,
    resolve_sync,
)
from test_clock_recovery import N_BLOCKS, _skewed_stream
from test_frame_edges import (
    _blocks_from_symbols,
    _sequential_sync_walk,
    _symbols_for_bits,
)

torch.set_num_threads(1)

R = MODE0.rds_len
NAMES = {1: "A", 2: "B", 3: "C", 4: "D", 5: "C'"}


def _frame(**kw):
    return make_frame(MODE0, **kw)


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ------------------------------------------- tests/test_frame_edges.py

@pytest.mark.parametrize("offset", [0, 5, 23])
@pytest.mark.parametrize("start_pad", [0, 1])
@pytest.mark.parametrize("offset_mode", ["hold", "track"])
@pytest.mark.parametrize("cprime", [True, False])
def test_crafted_streams_match_golden(offset, start_pad, offset_mode, cprime):
    """Symbols and syndrome events equal the golden decoder's, block by
    block; 'hold' decodes (>= 3 syncs), 'track' keeps the golden model's
    offset -> 24 - offset quirk (pipeline/frame.py)."""
    rng = np.random.default_rng(offset * 7 + start_pad)
    info = rng.integers(0, 2, (40, 16))
    bits = encode_rds_blocks(info, cprime=cprime)
    symbols = _symbols_for_bits(bits, start_pad)
    blocks = _blocks_from_symbols(symbols, offset, 4)

    golden = GoldenFrameDecoder(offset_mode=offset_mode, with_cprime=cprime)
    frame_fn = _frame(offset_mode=offset_mode, with_cprime=cprime)
    state = frame_init(MODE0, dtype=torch.float64, device="cpu")
    total_syncs = 0
    for b, blk in enumerate(blocks):
        j = _t(blk)
        ref_symbols, ref_events = golden.step(blk, blk)
        out, state = frame_fn(state, j, j)
        n_sym = int(out.n_sym)
        assert n_sym == len(ref_symbols), f"block {b}"
        np.testing.assert_allclose(out.symbols_i.numpy()[:n_sym],
                                   ref_symbols, err_msg=f"block {b}")
        ours = [(NAMES[int(out.syndrome_id[w])], int(out.positions[w]),
                 bool(out.is_sync[w]))
                for w in range(int(out.n_windows)) if int(out.syndrome_id[w])]
        assert ours == ref_events, f"block {b}"
        total_syncs += sum(1 for e in ours if e[2])
    if offset_mode == "hold":
        assert total_syncs >= 3, f"no syncs ({offset=})"


def test_resync_reacquires_after_phase_jump():
    """A decoy codeword 5 bits off the true lattice: with resync the
    anchor resets and steady decoding resumes."""
    rng = np.random.default_rng(7)
    decoy = encode_rds_blocks([0x5A5A])[:26]
    junk = np.array([0, 1, 1, 0, 1])
    bits = np.concatenate(
        [[0], decoy, junk, encode_rds_blocks(rng.integers(0, 2, (400, 16)))])
    blocks = _blocks_from_symbols(_symbols_for_bits(bits), 6, 14)

    def run(resync):
        frame_fn = _frame(resync=resync)
        state = frame_init(MODE0, dtype=torch.float64, device="cpu")
        per_block, fired = [], 0
        for blk in blocks:
            j = _t(blk)
            out, state = frame_fn(state, j, j)
            per_block.append(int(out.is_sync.sum()))
            fired += int(out.is_resync.sum())
        return per_block, fired

    with_resync, fired = run(True)
    without, fired_off = run(False)
    assert fired_off == 0
    assert fired >= 1, "resync never fired"
    assert sum(with_resync[6:]) >= 2 * max(1, sum(without[6:])), (
        with_resync, without)


def test_track_mode_offset_12_survives():
    """offset=12 is the golden update's fixed point: track mode decodes."""
    rng = np.random.default_rng(100)
    bits = encode_rds_blocks(rng.integers(0, 2, (40, 16)))
    blocks = _blocks_from_symbols(_symbols_for_bits(bits), 12, 4)
    frame_fn = _frame(offset_mode="track")
    state = frame_init(MODE0, dtype=torch.float64, device="cpu")
    syncs = 0
    for blk in blocks:
        j = _t(blk)
        out, state = frame_fn(state, j, j)
        syncs += int(out.is_sync.sum())
    assert syncs >= 3


def test_burst_error_correction_repairs_info_word():
    """A 5-bit burst inside one 26-bit block: error_correct repairs it
    (true offset word, sync held, `corrected` set, info word restored);
    without correction the chain breaks there for good."""
    rng = np.random.default_rng(0xEC)
    infos = [int(x) for x in rng.integers(0, 1 << 16, 40)]
    bits = encode_rds_blocks(infos)
    victim = 9
    burst_at = victim * 26 + 7
    bits_bad = bits.copy()
    bits_bad[burst_at:burst_at + 5] ^= np.array([1, 0, 1, 1, 1])

    def run(stream_bits, error_correct):
        blocks = _blocks_from_symbols(_symbols_for_bits(stream_bits), 6, 4)
        frame_fn = _frame(error_correct=error_correct)
        state = frame_init(MODE0, dtype=torch.float64, device="cpu")
        events = []
        for blk in blocks:
            j = _t(blk)
            out, state = frame_fn(state, j, j)
            for w in range(int(out.n_windows)):
                if bool(out.is_sync[w]):
                    events.append((int(out.positions[w]),
                                   int(out.syndrome_id[w]),
                                   int(out.info_word[w]),
                                   bool(out.corrected[w])))
        return events

    clean = run(bits, False)
    fixed = run(bits_bad, True)
    broken = run(bits_bad, False)
    clean_pos = [p for p, *_ in clean]
    broken_pos = {p for p, *_ in broken}
    missing = [p for p in clean_pos if p not in broken_pos]
    pos_victim = missing[0]
    assert missing == [p for p in clean_pos if p >= pos_victim], (
        clean_pos, broken_pos)
    assert len(missing) >= 2
    assert [(p, s, i) for p, s, i, _ in fixed] \
        == [(p, s, i) for p, s, i, _ in clean]
    assert sum(c for *_, c in fixed) == 1
    ((pos_fixed, sid_fixed, info_fixed, _),) = [e for e in fixed if e[3]]
    assert pos_fixed == pos_victim
    assert sid_fixed == 2
    assert info_fixed == infos[victim]


@pytest.mark.parametrize("with_corr", [False, True])
@pytest.mark.parametrize("resync", [False, True])
def test_resolve_sync_matches_sequential_walk(resync, with_corr):
    """The port's resolve_sync equals the reference's sequential walk over
    random match patterns and entry states (200 trials)."""
    rng = np.random.default_rng(0xF00)
    w_max = 77
    for trial in range(200):
        density = rng.choice([0.02, 0.1, 0.5, 0.95])
        sid = (rng.random(w_max) < density) * rng.integers(1, 5, w_max)
        corr = None
        if with_corr:
            corr = (rng.random(w_max) < rng.choice([0.05, 0.3])) & (sid == 0)
        n_windows = int(rng.integers(1, w_max + 1))
        w_valid = np.arange(w_max) < n_windows
        base = int(rng.integers(0, 500))
        last = int(rng.choice([-1,
                               base - 26 + int(rng.integers(0, 30)),
                               base - int(rng.integers(27, 80))]))
        bad = int(rng.integers(0, 12))
        ref = _sequential_sync_walk(sid, w_valid, base, last, bad, resync,
                                    corr)
        i32 = torch.int32
        got = resolve_sync(torch.as_tensor(sid, dtype=i32),
                           torch.as_tensor(w_valid),
                           torch.tensor(base, dtype=i32),
                           torch.tensor(last, dtype=i32),
                           torch.tensor(bad, dtype=i32), resync=resync,
                           corr=None if corr is None else torch.as_tensor(corr))
        for k, (r, g) in enumerate(zip(ref, got)):
            np.testing.assert_array_equal(
                g.numpy(), r,
                err_msg=f"trial {trial} field {k}: sid={sid.tolist()} "
                        f"base={base} last={last} bad={bad} nw={n_windows}")


# ---------------------------------------- tests/test_clock_recovery.py

def _syncs_per_block(stream, mode):
    frame = _frame(offset_mode=mode, use_abs_clock=True, resync=True)
    state = frame_init(MODE0, device="cpu")
    per_block = []
    for b in range(N_BLOCKS):
        chunk = torch.as_tensor(stream[b * R:(b + 1) * R])
        out, state = frame(state, chunk, chunk * 0.1)
        nw = int(out.n_windows)
        sid = out.syndrome_id.numpy()[:nw]
        ok = out.is_sync.numpy()[:nw]
        per_block.append(int(((sid > 0) & ok).sum()))
    return per_block


@pytest.fixture(scope="module")
def skewed():
    return _skewed_stream(250.0)


@pytest.fixture(scope="module")
def hold_skewed(skewed):
    return _syncs_per_block(skewed, "hold")


def test_hold_loses_sync_under_clock_skew(hold_skewed):
    per_block = hold_skewed
    assert sum(per_block[4:9]) >= 12, per_block    # locks after resync
    assert sum(per_block[-4:]) <= 2, per_block     # dead once slid off


def test_gardner_tracks_clock_skew(skewed):
    per_block = _syncs_per_block(skewed, "gardner")
    assert all(n >= 2 for n in per_block[4:]), per_block


def test_argmax_outlives_hold(skewed, hold_skewed):
    argmax = _syncs_per_block(skewed, "argmax")
    hold = hold_skewed
    assert sum(argmax[13:16]) >= 7, argmax
    assert sum(argmax[13:16]) > sum(hold[13:16]), (argmax, hold)


def test_gardner_clean_clock_parity():
    stream = _skewed_stream(0.0)
    hold = _syncs_per_block(stream, "hold")
    gard = _syncs_per_block(stream, "gardner")
    assert sum(gard) >= sum(hold) - 1, (hold, gard)


def test_gardner_gain_is_derived():
    """tests/test_robustness.py::test_gardner_gain_is_derived: the loop
    gain comes from the pulse shape (1/slope ~= 5.87 for MODE0)."""
    g = gardner_gain(MODE0)
    assert 5.5 < g < 6.3, g
