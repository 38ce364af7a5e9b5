"""host_ms_per_step.resident: the host's own time a step, in ms: the
program's ``rtsdr.replay`` (the CUDA graph's replay) and
``rtsdr.fetch_start`` (the outputs' copies queued) spans in the traced
slice, summed, over the slice's steps.  Host clock: the spans of
``rtsdr_tpu_torch/utils/trace.py``, which record while the slice's
profiler session records and are absent from a program without them.

Notes the ``rtsdr.capture`` spans in the slice (a step built again inside
the window; 0 expected), the kernel launches a replay makes, and the
device-to-host copies and MB a step."""

import statistics


def _records() -> list:
    from rtsdr_tpu_torch.utils import trace

    recorded = getattr(trace, "recorded", None)
    return recorded() if recorded is not None else []


def read(run, ctx):
    t = run.trace
    if not t or not t.get("steps"):
        return None
    recs = _records()
    replays = [r for r in recs if r["name"] == "rtsdr.replay"]
    fetches = [r for r in recs if r["name"] == "rtsdr.fetch_start"]
    if not replays and not fetches:
        return None
    steps = t["steps"]
    host_ns = sum(r["t1_ns"] - r["t0_ns"] for r in replays + fetches)
    if ctx is not None:
        launches = [r["attrs"]["launches"] for r in replays
                    if "launches" in r["attrs"]]
        ctx.note(program_spans={
            "captures": sum(r["name"] == "rtsdr.capture" for r in recs),
            "replays": len(replays),
            "replay_ms_per_step": sum(r["t1_ns"] - r["t0_ns"]
                                      for r in replays) / 1e6 / steps,
            "launches_per_replay": (statistics.median(launches)
                                    if launches else None),
            "d2h_copies_per_step": sum(r["attrs"].get("copies", 0)
                                       for r in fetches) / steps,
            "d2h_mb_per_step": sum(r["attrs"].get("bytes", 0)
                                   for r in fetches) / 1e6 / steps})
    return host_ns / 1e6 / steps
