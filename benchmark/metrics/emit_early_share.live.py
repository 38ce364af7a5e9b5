"""emit_early_share.live: the share, in %, of the traced slice's drains
that ``StreamRunner`` made before reading the next block: the program's
``rtsdr.emit`` spans whose ``early`` attribute is 1, over those that carry
it.  The runner drains a block early when the next one has not arrived
yet (a live source), and holds it for one block when the next is already
waiting.  Host clock: the spans of ``rtsdr_tpu_torch/utils/trace.py``,
which record while the slice's profiler session records; None for a
program whose drains carry no ``early`` (one that always holds)."""


def _records() -> list:
    from rtsdr_tpu_torch.utils import trace

    recorded = getattr(trace, "recorded", None)
    return recorded() if recorded is not None else []


def read(run, ctx):
    flags = [r["attrs"]["early"] for r in _records()
             if r["name"] == "rtsdr.emit" and "early" in r["attrs"]]
    if not flags:
        return None
    if ctx is not None:
        ctx.note(emit_early={"drains": len(flags),
                             "early": sum(1 for f in flags if f)})
    return 100.0 * sum(1 for f in flags if f) / len(flags)
