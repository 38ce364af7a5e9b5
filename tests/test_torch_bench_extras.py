"""``tools/torch_bench_extras.py`` on the CPU at a tiny width: the records
of mode 1 (one channel) and the wideband receiver (2 slots, 1 capture),
each timed through the shared slope helper (the plain versions; no time
here is a device time)."""

import pathlib
import sys

import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "tools"))
import torch_bench_extras as be  # noqa: E402

torch.set_num_threads(1)


def _check(r, metric, stations):
    assert r["metric"] == metric and r["unit"] == "x_realtime"
    assert r["stations"] == stations and r["ms_per_step"] > 0
    assert r["value"] == pytest.approx(stations * 0.064
                                       / (r["ms_per_step"] / 1e3))


def test_mode1_record():
    r = be.bench_mode1(1, rds=False, device="cpu", k1=1, k2=2, repeats=1)
    _check(r, "mode1_chain_realtime_multiple_per_card", 1)
    assert r["channels"] == 1


def test_wideband_record():
    r = be.bench_wideband(2, 1, device="cpu", k1=1, k2=2, repeats=1)
    _check(r, "wideband_realtime_multiple_per_card", 2)
    assert (r["rf_channels"], r["captures"]) == (2, 1)
