#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card at the cell's
own size:

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \
        [--seconds 4] [--window-items N] [--start-blocks B] \
        [--fault KIND ...] [--dump FILE]

For each seed, one process runs the cell (set-up and a short window, the
benchmark's own driver), then compares what the timed path produced with
the float64 reference (the program's reading; ``check.reference``: the
configuration's reference front, then the golden receiver); compares the
control, the reference in bfloat16 put in the program's place from the
same starting states, with it (the control's reading); and the reference
in float32 likewise (a witness of what rounding at the program's
precision does).
With ``--fault``, each seed also runs once for each planted fault
(``benchmark/harness/faults.py``) and gives that run's reading and
``correct``.  ``--window-items`` and ``--start-blocks`` compare more
items than a run does (more samples of the same timed path); ``--dump``
writes every compared block's symbols (program, float64, float32,
bfloat16) to a ``.npz``.  One JSON line per seed and fault.  The
benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark.harness import check, core, drive, faults  # noqa: E402


def _as_program(items, outputs):
    return [dict(it, outputs=o) for it, o in zip(items, outputs)]


def _symbols(block):
    f = block["frame"]
    return np.asarray(f["symbols"][:f["n_sym"]], np.float64)


def readings(ctx, run, dump: list | None) -> dict:
    """The program's, the float32 witness's and the control's numbers."""
    pull_in = ctx.workload["check"]["pull_in_blocks"]
    resync = bool(ctx.config["receiver"]["resync"])
    refs = check.reference(ctx.config, "float64", run.block_of, run.items)
    out = {"program": check.compare(run.items, refs, pull_in)}
    others = {}
    for name, precision in (("reference_float32", "float32"),
                            ("control_bfloat16", "bfloat16")):
        # in the program's place: its own bit layer is judged on its own
        # symbols, as the program's is
        others[name] = check.reference(ctx.config, precision, run.block_of,
                                       run.items)
        items = _as_program(run.items, others[name])
        out[name] = check.compare(items, check.on_outputs(items, refs,
                                                          resync), pull_in)
    if dump is not None:
        # a station's carrier-to-noise ratio where the driver's blocks come
        # from a ring of stations (``drive.Traffic``)
        traffic = getattr(run.block_of, "__self__", None)
        for k, it in enumerate(run.items):
            cnr_db = (traffic.params[int(traffic.station[it["stream"]])][
                "cnr_db"] if isinstance(traffic, drive.Traffic) else None)
            for n_b, b in enumerate(it["blocks"][:len(it["outputs"])]):
                dump.append({
                    "seed": ctx.seed, "kind": it["kind"],
                    "stream": it["stream"], "block": b, "n_b": n_b,
                    "cnr_db": cnr_db,
                    "program": _symbols(it["outputs"][n_b]),
                    "float64": _symbols(refs[k][n_b]),
                    "float32": _symbols(others["reference_float32"][k][n_b]),
                    "bfloat16": _symbols(others["control_bfloat16"][k][n_b])})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--window-items", type=int)
    ap.add_argument("--start-blocks", type=int)
    ap.add_argument("--fault", nargs="*", default=[], choices=faults.KINDS)
    ap.add_argument("--no-readings", action="store_true",
                    help="only the planted faults")
    ap.add_argument("--dump")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(json.dumps({"card": core.power_limit()}), flush=True)
    workload = core.load_json(core.BENCH_DIR, "workloads",
                              args.workload + ".json")
    for key, val in (("window_items", args.window_items),
                     ("start_blocks", args.start_blocks)):
        if val is not None:
            workload["check"][key] = val
    core.load_json = with_workload(core.load_json, args.workload, workload)
    dump: list | None = [] if args.dump else None
    for seed in args.seeds:
        if not args.no_readings:
            ctx, run = core.measure(args.workload, seed, args.seconds, False)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "items": len(run.items),
                              **readings(ctx, run, dump)}), flush=True)
            del run
            torch.cuda.empty_cache()
        for kind in args.fault:
            undo = []
            faults.install(kind, lambda m, n, v: (
                undo.append((m, n, getattr(m, n))), setattr(m, n, v)))
            try:
                result = core.execute(args.workload, seed, args.seconds,
                                      False)
            finally:
                for m, n, v in reversed(undo):
                    setattr(m, n, v)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "fault": kind, "correct": result["correct"],
                              "checks": result["checks"]}), flush=True)
            torch.cuda.empty_cache()
    if dump is not None:
        keys = ("program", "float64", "float32", "bfloat16")
        np.savez_compressed(
            args.dump,
            meta=json.dumps([{k: v for k, v in d.items() if k not in keys}
                             for d in dump]),
            **{f"{k}_{i}": d[k] for i, d in enumerate(dump) for k in keys})
    found = core.forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    return 0


def with_workload(load_json, name: str, workload: dict):
    """``core.load_json`` that gives ``workload`` for the cell's workload
    file (the calibration's larger samples) and reads the rest."""
    def load(*parts):
        if parts[-2:] == ("workloads", name + ".json"):
            return json.loads(json.dumps(workload))
        return load_json(*parts)
    return load


if __name__ == "__main__":
    sys.exit(main())
