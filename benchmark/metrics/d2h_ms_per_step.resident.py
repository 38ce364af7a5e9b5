"""d2h_ms_per_step.resident: device milliseconds of device-to-host copies
per step in the traced slice (the outputs' fetch; profiler)."""


def read(run, ctx):
    t = run.trace
    if not t or not t["seconds_by_kind"].get("DtoH"):
        return None
    return t["seconds_by_kind"]["DtoH"] / t["steps"] * 1e3
