"""The decode-campaign regression tier through the port
(``tools/torch_decode_campaign.py``, CPU).

Port counterparts of the three ``test_decode_campaign_*`` functions of
``tests/test_robustness.py``: the campaign synthesizer's streams at 12
blocks, the port's receiver at CLI defaults ('hold', resync on) and with
the robust options ('gardner' + derotate), the JAX tests' thresholds.  The
scenarios that share a configuration run as rows of one batched receiver
(the tool's ``campaign``; each row is its own station).  At
``combined_harsh`` the decode sits on a cliff (ROADMAP Queue C, known
reference faults): sync counts are the stable property, and the JAX test's
weak group floor (>= 1) is kept.
"""

import pathlib
import sys

import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "tools"))
import torch_decode_campaign as dc  # noqa: E402

torch.set_num_threads(1)

N_BLOCKS = 12
HOLD = ("clean", "snr15", "detune+200", "combined_harsh")
ROBUST = ("detune+200", "combined_harsh")


@pytest.fixture(scope="module")
def yields():
    """scenario name (+ '/robust') -> (syncs, groups, transmitted groups)."""
    streams = {n: dc.synth_impaired(N_BLOCKS, dc.SCENARIOS[n]) for n in HOLD}
    rows = dc.campaign(list(HOLD), N_BLOCKS, device="cpu", streams=streams)
    rows += dc.campaign(list(ROBUST), N_BLOCKS, clock="gardner",
                        derotate=True, device="cpu", streams=streams)
    dc._RX.clear()
    return {r["scenario"]: (r["rx_syncs"], r["rx_groups"], r["tx_groups"])
            for r in rows}


def test_decode_campaign_clean_and_noise_yield(yields):
    """CLI-default receiver: full group yield (minus acquisition) on clean
    air and at 15 dB RF SNR."""
    for name in ("clean", "snr15"):
        syncs, groups, n_g = yields[name]
        assert groups >= n_g - 2, (name, syncs, groups, n_g)


def test_decode_campaign_detune_needs_robust_clock(yields):
    """+200 Hz pilot detune blinds the reference's I-only clock peek
    (hold: ~0 groups); the robust clock + derotator decode most groups."""
    _, groups_hold, _ = yields["detune+200"]
    assert groups_hold <= 1, groups_hold
    _, groups_rob, _ = yields["detune+200/robust"]
    assert groups_rob >= 3, groups_rob


def test_decode_campaign_combined_harsh_robust_regains_sync(yields):
    """The robust configuration re-acquires block sync where the
    reference-parity one stays dark."""
    syncs_hold, _, _ = yields["combined_harsh"]
    syncs_rob, groups, _ = yields["combined_harsh/robust"]
    assert syncs_hold <= 2, syncs_hold
    assert syncs_rob >= syncs_hold + 4, (syncs_hold, syncs_rob)
    assert groups >= 1, (syncs_rob, groups)


def test_batched_rows_equal_single_station_runs():
    """A scenario decoded as a row of the batched receiver yields what it
    yields alone (the campaign's batching changes nothing per station)."""
    u8, _ = dc.synth_impaired(3, dc.SCENARIOS["snr15"])
    alone = dc.receiver_yield(u8, 3, device="cpu")
    import numpy as np

    rows = dc.receiver_yield(np.stack([u8, u8]), 3, device="cpu")
    dc._RX.clear()
    assert rows == ([alone[0]] * 2, [alone[1]] * 2)
