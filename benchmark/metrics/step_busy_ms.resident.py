"""step_busy_ms.resident: device milliseconds of kernels per step in the
traced slice, every copy and memset left out (profiler)."""


def read(run, ctx):
    t = run.trace
    if not t or not t["seconds_by_kind"].get("kernel"):
        return None
    return t["seconds_by_kind"]["kernel"] / t["steps"] * 1e3
