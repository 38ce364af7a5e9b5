"""step_roofline_share.resident: the least time the step's required work
needs on this card (``benchmark/roofline/work.py``: the larger of its
operations over the float32 peak and its bytes over the memory peak), over
the step's device kernel time per step in the traced slice, in %.  No
reading on a card the peak table does not know."""

from benchmark.roofline import work


def read(run, ctx):
    import torch

    t = run.trace
    if not t or not t["seconds_by_kind"].get("kernel"):
        return None
    peaks = work.load_peaks(torch.cuda.get_device_name(0))
    if peaks is None:
        return None
    least, by = work.least_seconds(work.step_flop(run.channels, ctx.config),
                                   work.step_bytes(run.channels, ctx.config),
                                   peaks)
    busy = t["seconds_by_kind"]["kernel"] / t["steps"]
    ctx.note(roofline={"least_ms": least * 1e3, "bound_by": by,
                       "busy_ms": busy * 1e3})
    return least / busy * 100.0
