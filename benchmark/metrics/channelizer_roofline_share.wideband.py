"""channelizer_roofline_share.wideband: the least time of the wideband
channelizer's exact work on this card (``benchmark/roofline/
channelizer.py``: the larger of its operations over the float32 peak and
its bytes over the memory peak) over its kernel's device time a step
(``channelizer_ms_per_step.wideband``), in %.  Notes the least, what
bounds it and the routes the configuration's offsets give.  No reading on
a card the peak table does not know."""

from benchmark.harness import core
from benchmark.roofline import channelizer, work


def read(run, ctx):
    import torch

    busy = core.load_module(
        "metrics", "channelizer_ms_per_step.wideband").seconds_per_step(run)
    if busy is None:
        return None
    peaks = work.load_peaks(torch.cuda.get_device_name(0))
    if peaks is None:
        return None
    captures = run.channels // ctx.config["wideband"]["slots"]
    least, by = work.least_seconds(
        channelizer.least_flop(ctx.config, captures),
        channelizer.least_bytes(ctx.config, captures), peaks)
    ctx.note(channelizer_roofline={
        "least_ms": least * 1e3, "bound_by": by, "busy_ms": busy * 1e3,
        **channelizer.describe(ctx.config, captures)})
    return least / busy * 100.0
