"""pytest settings of the benchmark's own tests (simbench/tests): the
``card`` marker, and each cell cut to a size a CPU test run holds."""
import pytest

from simbench import cells

# per loop: the overrides that cut a cell to a CPU test's size
SMALL = {
    "fused_rollout": {"config": {"num_envs": 16, "env": {
        "camera_width": 32, "camera_height": 32}},
        "traffic": {"chunk_steps": 4, "action_bank_steps": 8,
                    "check_frames": 2}},
    "ppo": {"config": {"num_envs": 16, "env": {
        "camera_width": 32, "camera_height": 32}},
        "traffic": {"ppo": {"rollout_len": 4, "epochs": 2,
                            "minibatches": 2}, "setup_iters": 1}},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one (run on "
        "the card with `python -m pytest simbench/tests -m card`)")


def small_cell(workload):
    """The cell named ``workload`` at a CPU test's size."""
    bench = cells.load_benchmark()
    traffic = {w["name"]: w["traffic"] for w in bench["workloads"]}
    loop = cells.find(bench, workload).traffic["loop"]
    assert traffic[workload]
    return cells.find(bench, workload, overrides=SMALL[loop])


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
