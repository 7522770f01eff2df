"""Elastic training through python -m dtown_torch.train_ppo on the CPU:
a run killed after a periodic snapshot and resumed ends bit for bit where
an uninterrupted run ends (tests/test_train_resume.py's claim: the
snapshot holds everything that evolves: parameters, optimizer, env
state, every rank's generator, the LSTM carry), and a snapshot written by
two ranks restores into one (tests/test_checkpoint_reshard.py's claim)."""
import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from dtown_torch import train_ppo
from dtown_torch.parallel.mesh import spawn_ranks
from dtown_torch.utils import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--cpu", "--map", "small_loop", "--obs", "state", "--envs", "16",
        "--rollout", "4", "--epochs", "1", "--minibatches", "2", "--seed",
        "3", "--log-every", "1"]
ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(args, timeout=300):
    r = subprocess.run([sys.executable, "-m", "dtown_torch.train_ppo",
                        *BASE, *args], capture_output=True, text=True,
                       timeout=timeout, env=ENV, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    return r


def _iters_logged(stdout):
    return [json.loads(x)["iter"] for x in stdout.splitlines()
            if x.startswith('{"iter"')]


def _equal(a, b, path="state"):
    """Bit equality of two snapshots in checkpoint form."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.mark.parametrize("flags", [["--fused"],
                                   ["--rnn", "--rnn-hidden", "16"]],
                         ids=["fused", "rnn"])
def test_kill_resume_matches_uninterrupted(tmp_path, flags):
    ck_a, ck_c = str(tmp_path / "ck_a"), str(tmp_path / "ck_c")
    # A: periodic snapshots, SIGKILL as soon as one is reported (no grace
    # period: the next save may already be under way)
    proc = subprocess.Popen(
        [sys.executable, "-m", "dtown_torch.train_ppo", *BASE, *flags,
         "--iters", "99", "--ckpt", ck_a, "--ckpt-every", "2"],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env=ENV, cwd=REPO)
    killed = False
    # a run that hangs without reporting a snapshot is killed at 300 s
    watchdog = threading.Timer(300, proc.kill)
    watchdog.start()
    try:
        for line in proc.stderr:
            if "saved full train state" in line:
                proc.send_signal(signal.SIGKILL)
                killed = True
                break
    finally:
        watchdog.cancel()
        if proc.poll() is None and not killed:
            proc.kill()
        proc.wait(timeout=60)
    assert killed, "never saw a periodic snapshot"
    k = int(checkpoint.restore_any(ck_a)["it"])
    assert 0 < k < 99 and k % 2 == 0
    # B: resume the killed run to the horizon; C: the same horizon alone
    total = max(6, k + 2)
    r_b = _run(flags + ["--iters", str(total), "--ckpt", ck_a, "--resume",
                        ck_a])
    assert f"resumed from {ck_a} at iter {k}" in r_b.stdout
    its = _iters_logged(r_b.stdout)
    assert its[0] == k and its[-1] == total - 1, its
    _run(flags + ["--iters", str(total), "--ckpt", ck_c])
    fa, fc = checkpoint.restore_any(ck_a), checkpoint.restore_any(ck_c)
    assert fa["it"] == fc["it"] == total
    _equal(fa, fc)


def _ranks(args):
    spawn_ranks(2, ["-m", "dtown_torch.train_ppo", *BASE, *args],
                timeout=300, env=ENV, cwd=REPO)


@pytest.fixture(scope="module")
def world2_ckpt(tmp_path_factory):
    """A snapshot of two gloo ranks after 2 step-path iterations."""
    ck = str(tmp_path_factory.mktemp("w2") / "ck")
    _ranks(["--iters", "2", "--ckpt", ck, "--ckpt-every", "2"])
    return ck


def test_world2_resume_matches_uninterrupted(world2_ckpt, tmp_path):
    """Resumed on two ranks, each rank continues its own stream: the run
    ends bit for bit where 3 uninterrupted iterations on two ranks end."""
    ck_b, ck_c = str(tmp_path / "ck_b"), str(tmp_path / "ck_c")
    _ranks(["--iters", "3", "--ckpt", ck_b, "--resume", world2_ckpt])
    _ranks(["--iters", "3", "--ckpt", ck_c])
    fb, fc = checkpoint.restore_any(ck_b), checkpoint.restore_any(ck_c)
    assert fb["it"] == fc["it"] == 3 and fb["world"] == 2
    _equal(fb, fc)


def test_world2_checkpoint_restores_into_world1(world2_ckpt, capsys):
    """Two gloo ranks train 2 iterations of the step path and rank 0
    writes the snapshot; one process restores it: its parameters,
    optimizer and env state are the saved ones (the env state is the
    global batch in rank order), and one more iteration from it is
    finite. A resume at --iters 2 has nothing to do."""
    ck = world2_ckpt
    saved = checkpoint.restore_any(ck)
    assert saved["it"] == 2 and saved["world"] == 2
    assert len(saved["generators"]) == 2
    args = train_ppo.parse_args(BASE + ["--iters", "3", "--resume", ck])
    init, train, _ = train_ppo.build(args)
    ts, it = train_ppo.restore_state(init(args.seed), ck, args,
                                     train_ppo.Ranks(None))
    assert it == 2
    for k, v in ts.net.state_dict().items():
        assert torch.equal(v, saved["net"][k]), k
    _equal(checkpoint.to_saved(ts.opt), saved["opt"], "opt")
    _equal(checkpoint.to_saved(ts.env_states), saved["env_states"], "env")
    ts, metrics = train(ts)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert all(torch.isfinite(p).all() for p in ts.net.parameters())
    capsys.readouterr()
    train_ppo.main(BASE + ["--iters", "2", "--resume", ck])
    out = capsys.readouterr().out
    assert "nothing to do" in out and _iters_logged(out) == []
