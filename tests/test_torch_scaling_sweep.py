"""``tools/torch_scaling_sweep.py`` on the CPU: the records of a sweep at
C = 1 and 2 (one step per timed run), the choice of the knee, and the
stream-latency record of the compiled ``StreamRunner`` (the plain
versions; no time here is a device time)."""

import pathlib
import sys

import pytest
import torch

from rtsdr_tpu_torch.config import MODE0

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "tools"))
import torch_scaling_sweep as ss  # noqa: E402

torch.set_num_threads(1)

FIELDS = {"chain", "channels", "ms_per_step", "realtime_multiple",
          "iq_msamples_per_sec", "max_memory_allocated_bytes", "fits",
          "card"}


@pytest.mark.parametrize("chain,counts", [("mono", [1, 2]), ("full", [1])])
def test_sweep_records(chain, counts):
    recs = ss.sweep_chain(chain, counts, "cpu", k1=1, k2=2, repeats=1)
    assert [r["channels"] for r in recs] == counts
    for r in recs:
        assert set(r) == FIELDS
        assert r["chain"] == chain and r["fits"] is True
        assert r["ms_per_step"] > 0
        sec = r["ms_per_step"] / 1e3
        assert r["realtime_multiple"] == pytest.approx(
            r["channels"] * 0.064 / sec)
        assert r["iq_msamples_per_sec"] == pytest.approx(
            r["channels"] * MODE0.iq_len / sec / 1e6)
        assert r["max_memory_allocated_bytes"] is None   # no card


def test_knee_is_the_best_count_that_ran():
    recs = [{"channels": 1, "realtime_multiple": 100.0, "fits": True},
            {"channels": 1024, "realtime_multiple": 21000.0, "fits": True},
            {"channels": 2048, "realtime_multiple": 25000.0, "fits": True},
            {"channels": 4096, "realtime_multiple": 24000.0, "fits": True},
            {"channels": 8192, "fits": False}]
    assert ss.knee(recs)["channels"] == 2048
    assert ss.knee(recs[:2])["channels"] == 1024


def test_slope_writes_the_block_into_the_input_buffer():
    from rtsdr_tpu_torch.pipeline.receiver import Receiver

    rx = Receiver(MODE0, (1,), device="cpu", enable_rds=False,
                  enable_stereo=False)
    raw = torch.randint(0, 256, (1, MODE0.block_size), dtype=torch.uint8)
    assert ss.slope_seconds(rx.step, rx.init, raw, 1, 2, 1) > 0
    assert torch.equal(rx.step.input_buffer(raw.shape), raw)


def test_stream_latency_record():
    rep = ss.stream_latency("cpu", runs=2, blocks=3, pace_s=0.0,
                            enable_rds=False, enable_stereo=False)
    r = rep["stream_latency"]
    assert r["channels"] == 1 and r["runs"] == 2 and r["blocks_per_run"] == 3
    assert len(r["last_block_ms"]) == 2 and len(r["capture_run_ms"]) == 3
    assert r["int16_bytes_out"] == r["int16_bytes_expected"] == \
        2 * 3 * MODE0.audio_len * 4
    assert r["last_block_ms_median"] > 0 and r["held_back_ms_max"] > 0
    assert r["receiver"] == {"resync": True, "enable_rds": False,
                             "enable_stereo": False}
