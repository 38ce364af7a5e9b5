"""The harness: one run of one cell.

Everything a cell is made of is found by name: its workload file
``benchmark/workloads/<cell>.json`` names its configuration
(``benchmark/configs/<config>.json``, as the cell in ``BENCHMARK.json``
does), its traffic mix (``benchmark/traffic/<traffic>.json``), its entry
driver (``benchmark/drivers/<entry>.py``) and what its check samples and
allows;
each metric that ``BENCHMARK.json`` gives the cell is read by
``benchmark/metrics/<metric>.py``; the check's reference takes a station's
input through the front that the configuration file names
(``reference_front``: ``benchmark/reference/front_<name>.py``, "u8" where
it names none; ``harness/check.py``).  A later cell, metric or
configuration's reference front is a new file, not an edit.

A run: set-up (the traffic from the seed, the receiver built and its step
captured, the cell's shapes warmed up), the measured window, then, once
the window has closed and the device's peak memory has been read, the
reference over the items the run kept, the comparison, the metrics, and
one JSON line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "rtsdr_tpu")
AIR_SECONDS_PER_BLOCK = 0.064


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Ctx:
    """What a driver gets: the cell's files, the run's arguments, the
    port's configuration and receiver options."""
    cell: dict
    config: dict
    traffic: dict
    workload: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    info: list = dataclasses.field(default_factory=list)

    def span(self, name: str):
        if not self.trace:
            return contextlib.nullcontext()
        from benchmark.harness.trace import span
        return span(name)

    def note(self, **kv) -> None:
        """An information line for standard error (set-up parts, the
        generator's lateness)."""
        self.info.append(kv)


@dataclasses.dataclass
class Run:
    """What a driver returns."""
    setup_s: float
    window_s: float
    channels: int
    blocks_done: int          # blocks completed inside the window
    attempted: int
    failed: int
    items: list
    block_of: object          # (stream, block) -> what the stream carries
    #                           there, as the configuration's reference
    #                           front takes it (u8: the station's block)
    memory_peak_bytes: int
    latencies_s: list | None = None
    trace: dict | None = None


def port_config(config: dict):
    """The port's configuration object named by the file, held equal to
    every number the file states."""
    from rtsdr_tpu_torch import config as port

    obj = getattr(port, config["port_config"])

    def same(file_part: dict, o, where: str) -> None:
        for key, val in file_part.items():
            got = getattr(o, key)
            if isinstance(val, dict):
                same(val, got, f"{where}.{key}")
            elif got != val:
                raise ValueError(f"{config['name']}: {where}.{key} is {got!r}"
                                 f" in the port, {val!r} in the file")

    for key in ("block_size", "audio_scale", "rf", "mono", "stereo", "rds"):
        if isinstance(config[key], dict):
            same(config[key], getattr(obj, key), key)
        elif getattr(obj, key) != config[key]:
            raise ValueError(f"{config['name']}: {key} differs")
    return obj


def receiver_kwargs(config: dict) -> dict:
    """The receiver options of the configuration file, as the port's
    ``Receiver`` takes them (the C' offset word is the port's fixed
    behaviour and no option)."""
    opts = dict(config["receiver"])
    if opts.pop("dtype") != "float32" or not opts.pop("with_cprime"):
        raise ValueError("the port runs float32 with the C' offset word")
    return opts


def measure(cell_name: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", overrides: dict | None = None):
    """Set-up and the measured window of one cell: ``(ctx, run)``.
    ``overrides`` replace traffic keys (a test's small sizes)."""
    workload = load_json(BENCH_DIR, "workloads", cell_name + ".json")
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == cell_name),
                None)
    if cell is None:
        raise ValueError(f"no cell {cell_name!r} in BENCHMARK.json")
    for key in ("config", "traffic"):
        if cell[key] != workload[key]:
            raise ValueError(f"{cell_name}: {key} differs between "
                             "BENCHMARK.json and its workload file")
    ctx = Ctx(cell=cell,
              config=load_json(BENCH_DIR, "configs", cell["config"] + ".json"),
              traffic={**load_json(BENCH_DIR, "traffic",
                                   cell["traffic"] + ".json"),
                       **(overrides or {})},
              workload=workload, seed=seed, seconds=seconds, trace=trace,
              device=device)
    ctx.note(setup_part="process_start_and_imports_s",
             seconds=process_age_s())
    if device == "cuda":
        from rtsdr_tpu_torch.ops import _cuda

        t0 = time.perf_counter()
        _cuda.load()
        ctx.note(setup_part="kernel_library_load_s",
                 seconds=time.perf_counter() - t0,
                 nvcc_build_s=_cuda.build_seconds)
    return ctx, load_module("drivers", ctx.workload["entry"]).run(ctx)


def finish(ctx: Ctx, run: Run) -> dict:
    """The reference, the comparison and the metrics of a measured run:
    the result line's fields, the checks last."""
    from benchmark.harness import check

    t0 = time.perf_counter()
    refs = check.reference(ctx.config, "float64", run.block_of, run.items)
    where: dict = {}
    numbers = check.compare(run.items, refs,
                            ctx.workload["check"]["pull_in_blocks"], where)
    correct, checks = check.judge(numbers, ctx.workload["limits"])
    ctx.note(reference_s=time.perf_counter() - t0, items=len(run.items),
             worst_blocks=where)

    bench = load_json(ROOT, "BENCHMARK.json")
    name = ctx.cell["name"]
    metrics = {}
    for m in (bench["per_layer"] if ctx.trace else bench["end_to_end"]):
        if "workloads" in m and name not in m["workloads"]:
            continue
        value = load_module("metrics", m["name"]).read(run, ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics,
              "device": device_record(ctx.device, run, ctx)}
    if ctx.trace and run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = checks
    result["_info"] = ctx.info
    return result


def execute(cell_name: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", overrides: dict | None = None) -> dict:
    """One run of a cell (``measure`` then ``finish``)."""
    return finish(*measure(cell_name, seed, seconds, trace, device,
                           overrides))


def device_record(device: str, run: Run, ctx: Ctx) -> dict:
    import torch

    if device == "cuda":
        rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": int(ctx.cell.get("chips", 1)),
               "memory_peak_bytes": int(run.memory_peak_bytes)}
    else:
        rec = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if ctx.trace and run.trace is not None:
        rec["busy_s"] = run.trace["busy_s"]
        rec["window_s"] = run.trace["window_s"]
    return rec


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def main(argv: list[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    bench = load_json(ROOT, "BENCHMARK.json")
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    print(json.dumps({"card": power_limit()}), file=sys.stderr)
    result = execute(args.workload, args.seed, args.seconds,
                     bool(args.trace))
    for line in result.pop("_info"):
        print(json.dumps(line), file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
