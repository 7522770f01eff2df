"""The trainer's entry point, python -m dtown_torch.train_ppo (the
counterpart of scripts/train_ppo.py), on the CPU at a tiny size: its
per-iteration metric lines, each learner it selects, and its refusals."""
import json
import os
import subprocess
import sys

import pytest

from dtown_torch import train_ppo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--cpu", "--envs", "16", "--size", "32", "--rollout", "4",
        "--iters", "2", "--epochs", "2", "--minibatches", "2"]


@pytest.mark.parametrize("flags,keys", [
    (["--fused"], {"loss", "mean_reward", "done_frac"}),
    (["--fused", "--nav", "--goal-in-obs", "--map", "zigzag_dists", "4way",
      "udem1"], {"loss", "mean_reward", "done_frac", "goal_frac"}),
    (["--obs", "state"], {"loss", "mean_reward", "done_frac"}),
    (["--rnn", "--obs", "state", "--rnn-hidden", "32"],
     {"loss", "mean_reward", "done_frac", "mean_ratio"})])
def test_trainer_prints_metric_lines(flags, keys, capsys):
    train_ppo.main(TINY + ["--log-every", "1"] + flags)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "devices: 1 x cpu"
    its = [json.loads(x) for x in lines[1:-1]]
    assert [d["iter"] for d in its] == [0, 1]
    assert all(set(d) == {"iter"} | keys for d in its)
    report = json.loads(lines[-1])
    assert report["train"]["steps_per_s"] > 0


@pytest.mark.parametrize("flags,err", [
    (["--ckpt", "ck"], NotImplementedError),
    (["--resume", "ck"], NotImplementedError),
    (["--nav"], ValueError),
    (["--rnn", "--fused"], ValueError)])
def test_trainer_refusals(flags, err):
    with pytest.raises(err):
        train_ppo.main(TINY + flags)


def test_trainer_runs_as_a_module():
    out = subprocess.run(
        [sys.executable, "-m", "dtown_torch.train_ppo"] + TINY
        + ["--fused", "--obs", "state"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert '"iter": 1' in out.stdout
