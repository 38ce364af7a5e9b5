"""channelizer_ms_per_step.band: device milliseconds a step of the
wideband channelizer's kernel (K5, ``csrc/channelizer.cu``'s kernels, each
with ``composed_kernel`` in its name) in the traced slice of the dense
band's cell (profiler; the driver keeps the slice's kernels by name).
None where no such kernel ran (the ``pfb`` route, or no trace)."""

from benchmark.harness import core


def seconds_per_step(run):
    return core.load_module(
        "metrics", "channelizer_ms_per_step.wideband").seconds_per_step(run)


def read(run, ctx):
    s = seconds_per_step(run)
    return None if s is None else s * 1e3
