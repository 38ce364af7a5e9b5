"""The traffic generator: the same seed gives the same bytes, and the
writer process keeps the air-rate schedule."""

import json
import os
import subprocess
import sys
import time

import numpy as np

from benchmark.harness import core
from benchmark.traffic import synth
from conftest import SMALL


def _ring(seed, traffic="ring1024", config="mode0"):
    tr = {**core.load_json(core.BENCH_DIR, "traffic", traffic + ".json"),
          **SMALL}
    cfg = core.load_json(core.BENCH_DIR, "configs", config + ".json")
    return synth.make_ring(tr, cfg, seed)


def test_same_seed_same_bytes():
    seed = 2**31 + 77                  # wider than 32 signed bits
    a, sa, oa, pa, _ = _ring(seed)
    b, sb, ob, pb, _ = _ring(seed)
    assert a.shape == (2, 4, 307200) and a.dtype == np.uint8
    assert np.array_equal(a, b)
    assert np.array_equal(sa, sb) and np.array_equal(oa, ob)
    assert [p["cnr_db"] for p in pa] == [p["cnr_db"] for p in pb]
    c, *_ = _ring(seed + 1)
    assert not np.array_equal(a, c)


def test_station_parameters_in_their_ranges():
    ring, station, offset, params, _ = _ring(5, config="mode1_rds")
    assert ring.shape[2] == 320000
    for p in params:
        assert 15.0 <= p["cnr_db"] <= 40.0
        assert abs(p["detune_hz"]) <= 200.0
    assert set(station.tolist()) <= {0, 1} and offset.max() < 4
    # the bytes are a carrier near full scale, not clipped flat
    assert 20 < ring.std() < 90


def test_rds_words_carry_ps_and_radiotext():
    words = synth.station_words(8, 0x1234, "BENCH 00", "hello", 3)
    groups = [words[4 * g + 1] >> 12 for g in range(8)]
    assert groups == [0, 0, 0, 2, 0, 0, 0, 2]      # 0A, 0A, 0A, 2A
    bits = synth.encode_rds_blocks(words)
    assert len(bits) == 8 * 104


def test_live_schedule_due_times():
    """Block b is written when its last byte is due: t0 + (b + 1) T."""
    ring = np.arange(2 * 3 * 1000, dtype=np.uint8).reshape(1, 6, 1000)
    r, w = os.pipe()
    feeder = os.path.join(core.BENCH_DIR, "traffic", "feeder.py")
    proc = subprocess.Popen([sys.executable, feeder], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, pass_fds=[w])
    period = 0.05
    head = {"mode": "air", "fds": [w], "shape": list(ring.shape),
            "station": [0], "offset": [2], "period": period, "n_blocks": 5}
    proc.stdin.write((json.dumps(head) + "\n").encode() + ring.tobytes())
    proc.stdin.flush()
    assert proc.stdout.readline().strip() == b"ready"
    t0 = time.monotonic() + 0.1
    proc.stdin.write(f"{t0!r}\n".encode())
    proc.stdin.close()
    os.close(w)
    arrivals, data = [], b""
    with os.fdopen(r, "rb", buffering=0) as f:
        while True:
            chunk = f.read(1000)
            if not chunk:
                break
            data += chunk
            if len(data) % 1000 == 0:
                arrivals.append(time.monotonic())
    out = json.loads(proc.stdout.read())
    proc.wait(timeout=10)
    assert len(data) == 5000
    got = np.frombuffer(data, np.uint8).reshape(5, 1000)
    for b in range(5):
        assert np.array_equal(got[b], ring[0, (b + 2) % 6])
    late = np.asarray(out["late_s"])
    assert len(late) == 5 and late.min() >= 0 and np.median(late) < 0.002
    for b, t in enumerate(arrivals):
        assert t >= t0 + (b + 1) * period - 1e-3
