"""step_roofline_share.wideband: the least time of the wideband step's
work on this card over the step's device kernel time a step in the
traced slice, in %.  The work: the channelizer's least
(``benchmark/roofline/channelizer.py``) plus the receivers' from the IF
on (``benchmark/roofline/work.py``'s step less its RF low-pass,
``rf_fir_flop``, and its u8 input bytes, which the channelizer reads in
their place).  Notes the least and what bounds it.  No reading on a card
the peak table does not know."""

from benchmark.roofline import channelizer, work


def read(run, ctx):
    import torch

    t = run.trace
    if not t or not t["seconds_by_kind"].get("kernel"):
        return None
    peaks = work.load_peaks(torch.cuda.get_device_name(0))
    if peaks is None:
        return None
    cfg, n = ctx.config, run.channels
    captures = n // cfg["wideband"]["slots"]
    flop = (channelizer.least_flop(cfg, captures) + work.step_flop(n, cfg)
            - work.rf_fir_flop(n, cfg))
    nbytes = (channelizer.least_bytes(cfg, captures)
              + work.step_bytes(n, cfg) - n * cfg["block_size"])
    least, by = work.least_seconds(flop, nbytes, peaks)
    busy = t["seconds_by_kind"]["kernel"] / t["steps"]
    ctx.note(roofline={"least_ms": least * 1e3, "bound_by": by,
                       "busy_ms": busy * 1e3})
    return least / busy * 100.0
