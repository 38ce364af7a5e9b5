"""channelizer_roofline_share.band: the least time of the wideband
channelizer's exact work over S stations, several a slot, on this card
(``benchmark/roofline/band.py``: the larger of its operations over the
float32 peak and its bytes over the memory peak) over its kernel's device
time a step (``channelizer_ms_per_step.band``), in %.  Notes the least,
what bounds it, and the slots, stations and most stations a slot.  No
reading on a card the peak table does not know."""

from benchmark.harness import core
from benchmark.roofline import band, work


def read(run, ctx):
    import torch

    busy = core.load_module(
        "metrics", "channelizer_ms_per_step.band").seconds_per_step(run)
    if busy is None:
        return None
    peaks = work.load_peaks(torch.cuda.get_device_name(0))
    if peaks is None:
        return None
    captures = run.channels // len(band.stations(ctx.config)[0])
    least, by = work.least_seconds(band.least_flop(ctx.config, captures),
                                   band.least_bytes(ctx.config, captures),
                                   peaks)
    ctx.note(channelizer_roofline_band={
        "least_ms": least * 1e3, "bound_by": by, "busy_ms": busy * 1e3,
        **band.describe(ctx.config, captures)})
    return least / busy * 100.0
