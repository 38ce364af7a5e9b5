"""``tests/torch_oracles.py``, the jax-free copy of the golden decoder,
against ``tests/oracles.py`` (CPU).

The copy reads its two tables from the port (``ops/coeffs.py::rrc_taps``,
``pipeline/frame.py::H_MATRIX``); every output must equal the original's
exactly (``np.array_equal``) on one 3-block synthetic station, and the
decode campaign's golden column through the copy must equal the column
``campaign_r5.json`` records for the same scenarios at 12 blocks.
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import oracles
import torch_oracles

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import torch_decode_campaign as dc  # noqa: E402

torch.set_num_threads(1)

N_BLOCKS = 3
CAMPAIGN_BLOCKS = 12
CAMPAIGN_SCENARIOS = ("clean", "snr15", "detune+200")


@pytest.fixture(scope="module")
def station():
    wave = oracles.rds_baseband(oracles.encode_rds_blocks(
        np.random.default_rng(42).integers(0, 2, (40, 16))))
    return oracles.synth_multiplex_iq(N_BLOCKS * 307200 // 2, rds_wave=wave)


@pytest.fixture(scope="module")
def chains(station):
    """module -> (golden_mono_stereo outputs, golden_rds_dsp blocks)."""
    out = {}
    for mod in (oracles, torch_oracles):
        ms = mod.golden_mono_stereo(station, N_BLOCKS)
        out[mod.__name__] = (ms, mod.golden_rds_dsp(
            list(ms["fm"].reshape(N_BLOCKS, -1))))
    return out


def test_tables_equal():
    assert np.array_equal(oracles._build_h(), torch_oracles._build_h())
    assert oracles.SYNDROME_LIST == torch_oracles.SYNDROME_LIST
    for n in (0, 1, 0x3A5C, 0xFFFF):
        assert oracles.rds_crc10(n) == torch_oracles.rds_crc10(n)


def test_golden_mono_stereo_equal(chains):
    a, b = chains["oracles"][0], chains["torch_oracles"][0]
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_golden_rds_dsp_equal(chains):
    a, b = chains["oracles"][1], chains["torch_oracles"][1]
    assert len(a) == len(b) == N_BLOCKS
    for (ai, aq), (bi, bq) in zip(a, b):
        assert np.array_equal(ai, bi) and np.array_equal(aq, bq)


@pytest.mark.parametrize("offset_mode", ["track", "hold"])
def test_golden_frame_decoder_equal(chains, offset_mode):
    rrc = chains["oracles"][1]
    dec_a = oracles.GoldenFrameDecoder(offset_mode=offset_mode)
    dec_b = torch_oracles.GoldenFrameDecoder(offset_mode=offset_mode)
    n_events = 0
    for ri, rq in rrc:
        sym_a, ev_a = dec_a.step(ri, rq)
        sym_b, ev_b = dec_b.step(ri, rq)
        assert np.array_equal(sym_a, sym_b)
        assert ev_a == ev_b
        n_events += len(ev_a)
    assert n_events > 0


def test_golden_column_equals_campaign_record():
    """The campaign's golden column through the copy, against the record:
    syncs and groups per scenario at 12 blocks."""
    rec = {r["scenario"]: (r["golden_syncs"], r["golden_groups"])
           for r in json.loads((ROOT / "campaign_r5.json").read_text())
           if r["blocks"] == CAMPAIGN_BLOCKS and "golden_syncs" in r}
    got = {n: dc.golden_yield(dc.synth_impaired(
        CAMPAIGN_BLOCKS, dc.SCENARIOS[n])[0], CAMPAIGN_BLOCKS)
        for n in CAMPAIGN_SCENARIOS}
    assert got == {n: rec[n] for n in CAMPAIGN_SCENARIOS}
