"""The port's scripts on the CPU at a tiny size: eval_policy (its episode
tally against scripts/eval_policy.py's on the same arrays, then a
checkpoint of python -m dtown_torch.train_ppo evaluated, GIF included),
gen_data (its .npz read by scripts/train_torch_bc.py), train_imitation
and manual_control's recorded drive."""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dtown_torch import eval_policy, gen_data, manual_control, \
    train_imitation, train_ppo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_eval():
    spec = importlib.util.spec_from_file_location(
        "ref_eval_policy", os.path.join(REPO, "scripts", "eval_policy.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_episode_tally_matches_reference():
    rng = np.random.default_rng(0)
    rew = rng.standard_normal((40, 6)).astype(np.float32)
    done = rng.random((40, 6)) < 0.1
    done[:, 0] = False
    rew[done & (rng.random((40, 6)) < 0.5)] = -1000.0
    ref = _reference_eval()
    assert eval_policy.episode_records(rew, done) == \
        ref.episode_records(rew, done)
    assert eval_policy.episode_stats(rew, done) == \
        ref.episode_stats(rew, done)


def test_eval_policy_loads_trainer_checkpoint(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    train_ppo.main(["--cpu", "--obs", "state", "--envs", "8", "--rollout",
                    "4", "--iters", "1", "--epochs", "1", "--minibatches",
                    "2", "--ckpt", ck])
    capsys.readouterr()
    gif = str(tmp_path / "drive.gif")
    stats = eval_policy.main(["--cpu", "--ckpt", ck, "--obs", "state",
                              "--envs", "8", "--steps", "12", "--gif", gif,
                              "--gif-steps", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[0]) == stats
    assert stats["envs"] == 8 and stats["steps"] == 12
    assert np.isfinite(stats["mean_step_reward"])
    assert os.path.exists(gif) or os.path.exists(gif + ".npy")


def test_gen_data_feeds_torch_bc(tmp_path):
    out = str(tmp_path / "demos.npz")
    summary = gen_data.main(["--cpu", "--envs", "8", "--steps", "6",
                             "--obs", "state", "--out", out])
    d = np.load(out, allow_pickle=True)
    assert d["obs"].shape == (48, 11) and d["act"].shape == (48, 2)
    assert d["obs"].dtype == np.float32 and d["act"].dtype == np.float32
    assert list(d["step_idx"][:9]) == [0] * 8 + [1]
    assert list(d["env_idx"][:9]) == list(range(8)) + [0]
    assert json.loads(str(d["meta"]))["obs_type"] == "state"
    assert summary["samples"] == 48
    r = subprocess.run([sys.executable,
                        os.path.join(REPO, "scripts", "train_torch_bc.py"),
                        "--data", out, "--epochs", "1"], capture_output=True,
                       text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert np.isfinite(json.loads(r.stdout.splitlines()[-1])
                       ["final_val_mse"])


def test_gen_data_rgb_frames(tmp_path):
    out = str(tmp_path / "demos.npz")
    gen_data.main(["--cpu", "--envs", "4", "--steps", "2", "--size", "32",
                   "--out", out])
    d = np.load(out, allow_pickle=True)
    assert d["obs"].shape == (8, 32, 32, 3) and d["obs"].dtype == np.uint8


def test_train_imitation_runs(tmp_path, capsys):
    ck = str(tmp_path / "bc")
    res = train_imitation.main(["--cpu", "--obs", "state", "--envs", "16",
                                "--demo-steps", "8", "--epochs", "2",
                                "--batch", "32", "--eval-steps", "8",
                                "--dagger-rounds", "1", "--ckpt", ck])
    assert 0.0 <= res["closed_loop_survival"] <= 1.0
    assert np.isfinite(res["mean_reward"])
    out = capsys.readouterr().out
    assert '"dagger_round": 0' in out and os.path.isdir(ck)


def test_manual_control_records(tmp_path):
    out = str(tmp_path / "drive.gif")
    frames, ret = manual_control.main(
        ["--cpu", "--record", "--steps", "4", "--width", "64", "--height",
         "64", "--map-name", "small_loop", "--out", out])
    assert len(frames) == 5 and frames[0].shape == (64, 64, 3)
    assert np.isfinite(ret)
    assert manual_control.ascii_view(frames[0], 4, 8)[0].__len__() == 8
