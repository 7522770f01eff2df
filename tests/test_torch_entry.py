"""dtown_torch.entry, the counterpart of __graft_entry__.py: entry()'s
step -> policy -> step on the CPU (the row-fed render's plain version at
the entry's 32 envs 64x64) and dryrun_multichip over two gloo ranks (the
step path, the fused rollout, the recurrent learner and the (2, 1)
hierarchical split, one sharded train step each). Also the package's
top-level surface that mirrors dtown/__init__.py (MapArrays,
register_gymnasium)."""
import json

import pytest
import torch

import dtown_torch
from dtown_torch import entry


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_step_policy_step():
    fn, (net, states) = entry.entry("cpu")
    value, pos = fn(net, states)
    assert value.shape == () and torch.isfinite(value)
    assert pos.shape == (32, 3) and torch.isfinite(pos).all()
    assert not torch.equal(pos, states.pos)


def test_dryrun_multichip_two_ranks(capsys):
    out = entry.dryrun_multichip(2)
    lines = out.strip().splitlines()
    tags = [x.split(":")[0] for x in lines]
    assert tags == ["dryrun_multichip(2)", "dryrun_multichip(2) fused",
                    "dryrun_multichip(2) rnn",
                    "dryrun_multichip(2) hier(2x1)"]
    for x in lines:
        metrics = json.loads(x.split("metrics=", 1)[1])
        assert all(abs(v) < float("inf") for v in metrics.values())
    assert "mean_ratio" in json.loads(lines[2].split("metrics=", 1)[1])


def test_top_level_surface():
    assert dtown_torch.MapArrays is dtown_torch.types.MapArrays
    assert isinstance(dtown_torch.load_map("small_loop"),
                      dtown_torch.MapArrays)
    assert callable(dtown_torch.register_gymnasium)
    assert "register_gymnasium" in dtown_torch.__all__
    gymnasium = pytest.importorskip("gymnasium")
    ids = dtown_torch.register_gymnasium()
    assert "dtown_torch/Duckietown-small_loop-v0" in ids
    assert "dtown_torch/Duckietown-small_loop-v0" in gymnasium.registry


def test_new_modules_import_no_optional_packages():
    """Importing every module of the port, the sharded learner, the
    checkpoints, the viewer and the scripts among them, loads neither PIL
    nor orbax nor gymnasium (the card machine has none of them): they are
    imported inside the functions that need them."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import importlib, pkgutil, sys\n"
        "import dtown_torch\n"
        "for m in pkgutil.walk_packages(dtown_torch.__path__,"
        " 'dtown_torch.'):\n"
        "    if m.name != 'dtown_torch.gymnasium_compat':\n"
        "        importlib.import_module(m.name)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'PIL', 'orbax', 'gymnasium', 'jax', 'curses'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
