"""Every file of a cell is found by name, and BENCHMARK.json keeps to the
benchmark's contract."""

import json
import os
import re

from benchmark.harness import check, core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _bench():
    return core.load_json(core.ROOT, "BENCHMARK.json")


def test_each_file_is_found_by_name():
    bench = _bench()
    for cell in bench["workloads"]:
        wl = core.load_json(core.BENCH_DIR, "workloads",
                            cell["name"] + ".json")
        assert hasattr(core.load_module("drivers", wl["entry"]), "run")
        assert set(wl["limits"]) == {"mono_err", "stereo_err",
                                     "symbol_err", "symbol_miss",
                                     "frame_mismatch"}
        assert 0 <= wl["check"]["pull_in_blocks"] < wl["check"][
            "start_blocks"]
        assert core.load_json(core.BENCH_DIR, "traffic",
                              cell["traffic"] + ".json")["name"] \
            == cell["traffic"]
        assert (wl["config"], wl["traffic"]) == (cell["config"],
                                                 cell["traffic"])
    for cfg in bench["configs"]:
        data = core.load_json(core.ROOT, cfg["file"])
        assert data["name"] == cfg["name"]
        assert data["reduced"] == cfg["reduced"]
        # every departure from the source is stated with its reason
        assumed = {a["key"].split(".")[0] for a in data["assumed"]}
        assert set(cfg["reduced"]) <= assumed
        core.port_config(data)                 # the port runs these numbers
        core.receiver_kwargs(data)
        # the check's reference front that the file names (u8 by default)
        front = check.load_front(data, "float64")
        assert callable(front.init) and callable(front.step)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert hasattr(core.load_module("metrics", m["name"]), "read")


def test_contract_shape():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert os.path.getsize(os.path.join(core.ROOT, "BENCHMARK.json")) < 65536
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"]: w for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    configs = {c["name"] for c in bench["configs"]}
    assert {w["config"] for w in bench["workloads"]} == configs
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and all(map(NAME.match, names))
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for cell in cells:
        reported = [m["name"] for m in bench["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m["workloads"] for m in bench["per_layer"])
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        # every cell that reports a per-layer metric reports what it moves
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    json.dumps(bench)
