"""hold_ms_per_block.live: how long a block's outputs wait on the host
before the runner drains them, in ms: the median, over the traced slice's
blocks that have both spans, of the program's ``rtsdr.emit`` start minus
its ``rtsdr.fetch_start`` end for the same block (``StreamRunner`` holds
block b until block b + 1 has been read).  Host clock: the spans of
``rtsdr_tpu_torch/utils/trace.py``, which record while the slice's
profiler session records and are absent from a program without them.

Notes the median ``rtsdr.read`` ms a block, the median of ``rtsdr.push``
+ ``rtsdr.replay`` + ``rtsdr.fetch_start`` ms a block, and the share of
the slice's wall time the host spent in ``rtsdr.read``."""

import statistics


def _records() -> list:
    from rtsdr_tpu_torch.utils import trace

    recorded = getattr(trace, "recorded", None)
    return recorded() if recorded is not None else []


def _ms(r) -> float:
    return (r["t1_ns"] - r["t0_ns"]) / 1e6


def read(run, ctx):
    by_block: dict = {}
    reads = []
    for r in _records():
        if r["name"] == "rtsdr.read":
            reads.append(r)
        if r["block"] is not None:
            by_block.setdefault(r["block"], {})[r["name"]] = r
    holds, read_ms, host_ms = [], [], []
    for spans in by_block.values():
        if "rtsdr.emit" in spans and "rtsdr.fetch_start" in spans:
            holds.append((spans["rtsdr.emit"]["t0_ns"]
                          - spans["rtsdr.fetch_start"]["t1_ns"]) / 1e6)
        if "rtsdr.read" in spans:
            read_ms.append(_ms(spans["rtsdr.read"]))
        host = ("rtsdr.push", "rtsdr.replay", "rtsdr.fetch_start")
        if all(n in spans for n in host):
            host_ms.append(sum(_ms(spans[n]) for n in host))
    if not holds:
        return None
    if ctx is not None:
        window_s = (run.trace or {}).get("window_s")
        ctx.note(program_spans={
            "blocks": len(holds),
            "read_ms_per_block": (statistics.median(read_ms)
                                  if read_ms else None),
            "push_replay_fetch_start_ms_per_block": (
                statistics.median(host_ms) if host_ms else None),
            "read_share_of_window": (sum(map(_ms, reads)) / 1e3 / window_s
                                     if window_s else None)})
    return statistics.median(holds)
