"""BENCHMARK.json against the contract's shape, and every cell found by
name from its configuration, traffic and metric files."""
import json
import os
import re

import pytest

from simbench import cells

BENCH = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["simbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [
        c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_found_by_name(workload):
    cell = cells.find(BENCH, workload)
    assert cell.chips in (1, 4)
    assert os.path.exists(os.path.join(cells.HERE, "loops",
                                       cell.traffic["loop"] + ".py"))
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m, reader in cell.per_layer:
        # each metric moves an end-to-end metric that the cell reports
        assert callable(reader.read) and m["moves"] in e2e
    assert set(cell.traffic["limits"]) and cell.traffic["why"]


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_file(config):
    with open(os.path.join(cells.ROOT, config["file"])) as f:
        data = json.load(f)
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert os.path.exists(os.path.join(cells.HERE, "reference", "maps",
                                       data["map"] + ".yaml"))


def test_metric_with_dots_loads_by_path():
    """A name with a suffix and no file of its own is read by the module of
    its first part."""
    reader = cells.metric_reader("idle_share.train")
    assert reader.__file__.endswith(os.path.join("metrics", "idle_share.py"))
    assert reader.read({"window_ms": 10.0, "busy_ms": 4.0,
                        "kernels": {"k": (4.0, 1)}}) == pytest.approx(60.0)
    assert reader.read({}) is None


def test_unknown_workload():
    with pytest.raises(KeyError):
        cells.find(BENCH, "no_such.cell")


def test_layer_readers_on_a_record():
    """Each per-layer reader on a synthetic traced record, and None on an
    empty one (a share of a roofline is never 0 for lack of a trace)."""
    rec = {"kernels": {"void blob_render_kernel<false>": (10.0, 4),
                       "void state_step_kernel<0>": (0.4, 4),
                       "elementwise": (0.6, 8)},
           "bounds": {"blob_render_kernel": 1.0, "state_step_kernel": 0.02},
           "busy_ms": 11.0, "window_ms": 20.0, "flops": 989e9,
           "update_ms": 5.0, "steps": 4}
    want = {"k2_roofline": 40.0, "k1_roofline": 20.0,
            "step_roofline": 100.0 * (1.0 + 0.02) * 4 / 20.0,
            "idle_share": 45.0, "idle_share.train": 45.0, "train_mfu": 5.0,
            "update_ms": 5.0}
    for m in BENCH["per_layer"]:
        reader = cells.metric_reader(m["name"])
        assert reader.read(rec) == pytest.approx(want[m["name"]]), m["name"]
        assert reader.read({}) is None, m["name"]


def test_step_roofline_reads_steps_not_launches():
    """The whole step's share holds when the bounded kernels are fused away
    or renamed: it counts steps, not the kernels that launched."""
    reader = cells.metric_reader("step_roofline")
    rec = {"kernels": {"fused_step_kernel": (9.0, 4)},
           "bounds": {"blob_render_kernel": 1.0, "state_step_kernel": 0.02},
           "steps": 4, "window_ms": 20.0}
    assert reader.read(rec) == pytest.approx(100.0 * 1.02 * 4 / 20.0)
