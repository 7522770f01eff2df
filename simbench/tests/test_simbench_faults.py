"""``correct`` comes out false with a fault planted under the timed path
(the harness's look for a card skipped, the rest of a run driven at a CPU
test's size), and the control (the reference in the next precision below,
in the program's place) fails a limit of every cell."""
import pytest

from simbench import cells, faults, run
from simbench.conftest import small_cell

CASES = [(w["name"], f) for w in cells.load_benchmark()["workloads"]
         for f in faults.FAULTS[cells.find(cells.load_benchmark(),
                                           w["name"]).traffic["loop"]][1]]


def _run(workload, fault=None):
    cell = small_cell(workload)
    with faults.plant(cell.traffic["loop"], fault):
        c = cell.loop.Cell(cell.config, cell.traffic, 2**31 + 3, "cpu")
        c.window(0.3, False)
    c.free()
    return cell, c


def _fails(cell, readings):
    return [k for k, lim in cell.traffic["limits"].items()
            if not readings[k] <= lim]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_reads_incorrect(workload, fault):
    cell, c = _run(workload, fault)
    assert _fails(cell, c.check()), f"{fault} passed every limit"


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_through_run_cell(workload, fault, monkeypatch):
    cell = small_cell(workload)
    orig = cell.loop.Cell

    class Faulty(orig):
        def __init__(self, *a, **k):
            self._fault = faults.plant(cell.traffic["loop"], fault)
            self._fault.__enter__()
            super().__init__(*a, **k)

        def free(self):
            self._fault.__exit__(None, None, None)
            super().free()

    monkeypatch.setattr(cell.loop, "Cell", Faulty)
    out = run.run_cell(cell, 2**31 + 9, 0.3, False, device="cpu")
    assert out["correct"] is False


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      cells.load_benchmark()["workloads"]])
def test_control_reads_incorrect(workload):
    cell = small_cell(workload)
    c = cell.loop.Cell(cell.config, cell.traffic, 2**31 + 4, "cpu")
    c.window(0.3, False)
    c.free()
    assert not _fails(cell, c.check())
    assert _fails(cell, c.check(control=True))
