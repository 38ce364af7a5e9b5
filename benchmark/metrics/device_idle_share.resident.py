"""device_idle_share: the device's idle share of the traced slice, in %
(profiler: 1 - the union of the streams' busy intervals / the slice's wall
time)."""


def read(run, ctx):
    t = run.trace
    if not t or not t["busy_s"] or not t["window_s"]:
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0
