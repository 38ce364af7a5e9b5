"""channelizer_ms_per_step.wideband: device milliseconds a step of the
wideband channelizer's kernel (K5, ``csrc/channelizer.cu``'s
``composed_kernel``) in the traced slice (profiler; the driver keeps the
slice's kernels by name).  None where no such kernel ran (the ``pfb``
route, or no trace)."""

KERNEL = "composed_kernel"


def seconds_per_step(run):
    t = run.trace
    if not t or not t.get("kernels") or not t.get("steps"):
        return None
    s = sum(v for name, v in t["kernels"].items() if KERNEL in name)
    return s / t["steps"] if s else None


def read(run, ctx):
    s = seconds_per_step(run)
    return None if s is None else s * 1e3
