"""The end-to-end arithmetic: rates over all the work and the whole
window, percentiles over every block due, a missing block as a failure;
and the K1 roofline bound of PERF.md section 6 from the frozen counts."""

import math

import pytest

from benchmark.harness import core
from benchmark.roofline import work


def _run(**kw):
    base = dict(setup_s=12.5, window_s=20.0, channels=1024, blocks_done=0,
                attempted=0, failed=0, items=[], block_of=None,
                memory_peak_bytes=0)
    return core.Run(**{**base, **kw})


def _read(name, run):
    return core.load_module("metrics", name).read(run, None)


def test_rates_count_all_work_over_the_whole_window():
    run = _run(blocks_done=5000)
    assert _read("stations_rt", run) == pytest.approx(5000 * 1024 * 0.064
                                                      / 20.0)
    assert _read("setup_s", run) == 12.5


def test_latency_percentiles_over_every_block():
    lat = [0.065 + 0.0001 * k for k in range(100)]      # 65.0 .. 74.9 ms
    run = _run(latencies_s=lat, channels=1)
    assert _read("block_latency_p50_ms", run) == pytest.approx(69.95)
    # a block never emitted is infinitely late: 3 of 103 move the median
    run = _run(latencies_s=lat, failed=3, channels=1)
    assert _read("block_latency_p50_ms", run) == pytest.approx(70.1)
    # more than half never came: the median has no reading
    assert _read("block_latency_p50_ms",
                 _run(latencies_s=lat[:40], failed=60, channels=1)) is None


def test_trace_readers_and_their_silence():
    trace = {"steps": 10, "window_s": 0.05, "busy_s": 0.04,
             "seconds_by_kind": {"kernel": 0.028, "DtoH": 0.006,
                                 "HtoD": 0.004, "DtoD": 0.002}}
    run = _run(trace=trace)
    assert _read("step_busy_ms.resident", run) == pytest.approx(2.8)
    assert _read("d2h_ms_per_step.resident", run) == pytest.approx(0.6)
    assert _read("device_idle_share.resident", run) == pytest.approx(20.0)
    for name in ("step_busy_ms.resident", "d2h_ms_per_step.resident",
                 "device_idle_share.resident", "step_busy_ms.live",
                 "step_roofline_share.resident"):
        assert _read(name, _run()) is None


def test_k1_bound_of_perf_md():
    """PERF.md section 6, B1: (1,024, 307,200), 0.1418 ms by operations."""
    cfg = core.load_json(core.BENCH_DIR, "configs", "mode0.json")
    peaks = work.load_peaks("NVIDIA H100 80GB HBM3")
    ms = work.rf_fir_flop(1024, cfg) / peaks["f32_flop_per_s"] * 1e3
    assert round(ms, 4) == 0.1418


def test_step_least_time_is_bound_by_operations():
    peaks = work.load_peaks("NVIDIA H100 80GB HBM3")
    for name in ("mode0", "mode1_rds"):
        cfg = core.load_json(core.BENCH_DIR, "configs", name + ".json")
        least, by = work.least_seconds(work.step_flop(1024, cfg),
                                       work.step_bytes(1024, cfg), peaks)
        assert by == "operations"
        assert 0.4e-3 < least < 0.7e-3
        assert work.step_flop(1024, cfg) > 3 * work.rf_fir_flop(1024, cfg)
    assert work.load_peaks("some other card") is None
    assert math.isfinite(least)
