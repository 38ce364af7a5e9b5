"""Each driver end to end on the CPU at a small size, on the kernels' plain
versions (the rehearsal of a chip run): ``correct`` holds and no device
metric is printed.  The control, the reference in bfloat16 put in the
program's place, comes out not correct; so does a run whose timed path is
broken underneath, once for each fault the cell can have
(``benchmark/harness/faults.py``)."""

import pytest
import torch

from benchmark import control
from benchmark.harness import check, core, faults
from conftest import SMALL

CELLS = {"mode0.resident1024": 3.0, "mode1_rds.resident1024": 3.0,
         "mode0.live1": 0.5}
SEED = 2**31 + 4242


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _small(cell):
    return {**SMALL, "streams": 1 if cell.endswith("live1") else 2}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_rehearsal_and_control(cell):
    ctx, run = core.measure(cell, SEED, CELLS[cell], False, device="cpu",
                            overrides=_small(cell))
    assert any(it["kind"] == "window" for it in run.items)
    control = check.reference(ctx.config, "bfloat16", run.block_of,
                              run.items)
    result = core.finish(ctx, run)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "cpu"
    assert set(result["metrics"]) <= {"stations_rt", "block_latency_p50_ms",
                                      "setup_s"}
    as_program = [dict(it, outputs=r) for it, r in zip(run.items, control)]
    numbers = check.compare(as_program, check.reference(
        ctx.config, "float64", run.block_of, as_program),
        ctx.workload["check"]["pull_in_blocks"])
    correct, checks = check.judge(numbers, ctx.workload["limits"])
    assert not correct, checks


FAULTS = [(cell, kind) for cell in sorted(CELLS) for kind in faults.KINDS
          if not (kind == "half_batch" and cell.endswith("live1"))]


@pytest.mark.parametrize("cell,kind", FAULTS)
def test_broken_timed_path_is_not_correct(cell, kind, monkeypatch):
    """At the small size a run compares fewer blocks than on the card, so
    the start items run 6 blocks (4 held) to compare about as many."""
    workload = core.load_json(core.BENCH_DIR, "workloads", cell + ".json")
    workload["check"]["start_blocks"] = 6
    monkeypatch.setattr(core, "load_json", control.with_workload(
        core.load_json, cell, workload))
    faults.install(kind, monkeypatch.setattr)
    result = core.execute(cell, SEED + 1, CELLS[cell], False, device="cpu",
                          overrides=_small(cell))
    assert not result["correct"], result["checks"]


def test_no_card_no_result(capsys):
    """Without a CUDA device the benchmark exits 2 and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = core.main(["--workload", "mode0.live1", "--seed", "1",
                    "--seconds", "1", "--trace", "0"])
    assert rc == 2 and capsys.readouterr().out == ""


@pytest.mark.gpu
def test_one_run_on_the_card(need_gpu):
    """On the card: a short run of the resident cell is correct."""
    result = core.execute("mode0.resident1024", SEED, 3.0, False)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
