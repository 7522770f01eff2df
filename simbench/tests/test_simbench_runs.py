"""Whole runs of each cell at a CPU test's size (the result line's keys,
the checks last), and the command's refusal without a card."""
import json
import os
import subprocess
import sys

import pytest

from simbench import cells, run
from simbench.conftest import small_cell

CELLS = [w["name"] for w in cells.load_benchmark()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_last_line_keys(workload):
    cell = small_cell(workload)
    out = run.run_cell(cell, 2**31 + 7, 0.5, False, device="cpu")
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for name, ch in out["checks"].items():
        assert set(ch) == {"value", "limit"}
    json.dumps(out)


def _cli(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    env["PYTHONPATH"] = cwd
    return subprocess.run(
        [sys.executable, "-m", "simbench.run", "--workload", CELLS[0],
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    r = _cli(cells.ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_only_the_benchmark_files(tmp_path):
    """A directory with BENCHMARK.json and simbench/ alone has no program:
    the run fails and prints no result."""
    import shutil

    shutil.copy(os.path.join(cells.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(cells.HERE, tmp_path / "simbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _cli(str(tmp_path))
    assert r.returncode != 0
    assert r.stdout.strip() == ""


@pytest.mark.card
def test_cli_on_card(card):
    r = subprocess.run(
        [sys.executable, "-m", "simbench.run", "--workload", CELLS[0],
         "--seed", str(2**31 + 11), "--seconds", "3", "--trace", "0"],
        cwd=cells.ROOT, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    assert r.stderr.strip().splitlines()[-1].startswith("check ")
