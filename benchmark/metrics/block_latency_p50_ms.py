"""block_latency_p50_ms: the median (numpy's linear interpolation), over
every block due in the window, of the time from when its last byte was due
at the generator to the runner's emit of its int16 audio.  A block never
emitted counts as infinitely late.  Host clock (CLOCK_MONOTONIC)."""

import math

import numpy as np


def read(run, ctx):
    lat = list(run.latencies_s) + [math.inf] * run.failed
    if not lat:
        return None
    v = float(np.percentile(np.asarray(lat), 50)) * 1e3
    return v if math.isfinite(v) else None
