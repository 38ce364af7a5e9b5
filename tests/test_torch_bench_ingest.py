"""``tools/torch_bench_ingest.py`` on the CPU: 2 pipes x 3 blocks of 4,096
bytes through the port's ``BlockReader``s into the rows of a ``Feeder``'s
staging array; the blocks and bytes counted and every staging row, every
step, equal to what its pipe wrote."""

import pathlib
import sys

import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "tools"))
import torch_bench_ingest as bi  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("pipes,blocks", [(2, 3), (5, 4)])
def test_run_one_counts_and_rows(pipes, blocks):
    r = bi.run_one(pipes, blocks, 4096, device=None, check_every=True)
    assert r["pipes"] == pipes
    assert r["blocks"] == r["blocks_written"] == blocks
    assert r["bytes"] == r["bytes_written"] == pipes * blocks * 4096
    assert r["wrong_rows"] == 0 and r["last_rows_equal_written"]
    assert r["writer_threads_alive_after"] == 0
    assert r["threads"]["writers"] == pipes
    assert r["gb_per_s"] > 0
    assert r["stations_equiv"] == pytest.approx(
        r["gb_per_s"] * 1e9 / bi.STATION_BYTES_PER_S)
    assert r["device"] is None and r["device_sum_equal"] is None


def test_main_reports_scaling_against_the_first_count(tmp_path, capsys):
    out = tmp_path / "ingest.jsonl"
    assert bi.main(["--cpu", "--pipes", "1", "2", "--blocks", "3",
                    "--block-size", "4096", "--out", str(out)]) == 0
    lines = out.read_text().splitlines()
    assert len(lines) == 2
    import json

    first, second = map(json.loads, lines)
    assert first["scaling_eff"] == 1.0
    assert second["scaling_eff"] == pytest.approx(
        (second["gb_per_s"] / 2) / first["gb_per_s"])
