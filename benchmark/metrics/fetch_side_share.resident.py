"""fetch_side_share.resident: the share, in %, of the traced slice's
output fetches whose copy to the host was queued on a side stream behind
a snapshot on the device: the program's ``rtsdr.fetch_start`` spans whose
``side`` attribute is 1, over those that carry it.  Host clock: the spans
of ``rtsdr_tpu_torch/utils/trace.py``, which record while the slice's
profiler session records; None for a program whose fetches carry no
``side`` (one that copies to the host on the step's own stream)."""


def _records() -> list:
    from rtsdr_tpu_torch.utils import trace

    recorded = getattr(trace, "recorded", None)
    return recorded() if recorded is not None else []


def read(run, ctx):
    flags = [r["attrs"]["side"] for r in _records()
             if r["name"] == "rtsdr.fetch_start" and "side" in r["attrs"]]
    if not flags:
        return None
    if ctx is not None:
        ctx.note(fetch_side={"fetches": len(flags),
                             "side": sum(1 for f in flags if f)})
    return 100.0 * sum(1 for f in flags if f) / len(flags)
