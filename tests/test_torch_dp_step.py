"""The first data-parallel optimizer step of fused PPO with the IMPALA
trunk on a stack of maps, on two gloo ranks, against the benchmark's plain
reference (simbench/reference/ppo_dp.py): stack3 (zigzag_dists, 4way,
udem1), 8 envs a rank, 32x32 RGB, rollout 4. Each rank runs
``make_sharded_ppo(fused=True)``'s first iteration under a torch profiler;
the reference replays every rank's draws, rollout and first minibatch,
averages the two gradients, clips and takes the Adam step. With
``pmean_grads_`` made a no-op (each rank steps on its own gradient) the
same comparison must fail. The same run holds the exchange's trace: a
``ppo.allreduce`` span and an ``allreduce_calls`` count a minibatch, and
``allreduce_bytes`` = 4 x the gradient's elements a call.

The ranks are processes running this file (``python test_torch_dp_step.py
<dir>``), started by parallel.mesh.spawn_ranks with a time limit.
"""
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TIMEOUT = 300.0
WORLD = 2
SEED = 2**31 + 21
CONFIG = {"maps": ["zigzag_dists", "4way", "udem1"], "num_envs": 8 * WORLD,
          "env": dict(obs_type="rgb", camera_width=32, camera_height=32,
                      grayscale=False, marking_aa=True, obj_lod_px=2.0,
                      domain_rand=False, auto_reset=True,
                      collision_termination=True)}
HP = dict(rollout_len=4, lr=1e-3, gamma=0.99, gae_lambda=0.95, clip_eps=0.2,
          vf_coef=0.5, ent_coef=0.01, epochs=2, minibatches=2,
          max_grad_norm=0.5, reward_scale=0.02, trunk="impala")
# the gaps of a sound step (the ranks' gloo sum in rank order, as the
# reference sums) are 0 on the CPU; a rank stepping on its own gradient
# reads order 1e-2 and more
TOL = 1e-6


def _first_step(mesh, seed):
    """This rank's first iteration: (first minibatch's loss, the gradient as
    Adam got it, the parameters before and after the first step)."""
    from dtown_torch import EnvConfig, stack_maps
    from dtown_torch.learn.ppo import PPOConfig
    from dtown_torch.parallel.shard import make_sharded_ppo

    _, init, train = make_sharded_ppo(
        EnvConfig(**CONFIG["env"]), stack_maps(CONFIG["maps"]),
        CONFIG["num_envs"], PPOConfig(**HP), mesh, fused=True)
    ts = init(seed)
    net = ts.net
    theta0 = {k: v.detach().clone() for k, v in net.named_parameters()}
    names = {id(p): k for k, p in net.named_parameters()}
    got = {}

    def grab(opt, args, kwargs):
        if "after1" not in got:
            got["first"] = {names[id(p)]: s["exp_avg"] / 0.1
                            for p, s in opt.state.items()}
            got["after1"] = {k: v.detach().clone()
                             for k, v in net.named_parameters()}

    ts.opt.register_step_post_hook(grab)
    train(ts)
    return dict(theta0=theta0, n_params=sum(v.numel()
                                            for v in theta0.values()), **got)


def _rank(tmp):
    """Each rank: the sound first step under a profiler (spans and
    counters read), then the first step with pmean_grads_ a no-op."""
    import torch.distributed as dist

    from dtown_torch.learn import ppo as P
    from dtown_torch.parallel.mesh import make_mesh
    from dtown_torch.utils import profiling

    mesh = make_mesh("cpu")
    profiling.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        sound = _first_step(mesh, SEED)
    sound["spans"] = sum(s.name == "ppo.allreduce" for s in profiling.spans())
    sound["counters"] = profiling.counters()
    pmean = P.pmean_grads_
    P.pmean_grads_ = lambda params, group: None
    try:
        alone = _first_step(mesh, SEED)
    finally:
        P.pmean_grads_ = pmean
    torch.save(dict(sound=sound, alone=alone),
               os.path.join(tmp, f"out{mesh.rank}.pt"))
    dist.destroy_process_group()


def _gaps(run, first, after1, theta0):
    from simbench.reference import ppo as rppo

    return dict(grad=rppo.leaf_gaps(run["first"], first),
                change=rppo.leaf_gaps(
                    {k: run["after1"][k] - run["theta0"][k] for k in first},
                    {k: after1[k] - theta0[k] for k in first}))


def test_dp_first_step_matches_reference(tmp_path):
    from dtown_torch.parallel.mesh import spawn_ranks
    from simbench.reference import ppo_dp

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, HERE]))
    spawn_ranks(WORLD, [os.path.abspath(__file__), str(tmp_path)],
                timeout=TIMEOUT, env=env)
    outs = [torch.load(tmp_path / f"out{r}.pt", weights_only=True)
            for r in range(WORLD)]
    shares, first, after1 = ppo_dp.first_step(CONFIG, HP, SEED, WORLD,
                                              "cpu")
    theta0 = shares[0]["theta0"]
    sound = outs[0]["sound"]
    for k, v in theta0.items():
        assert torch.equal(sound["theta0"][k], v), k
    gaps = _gaps(sound, first, after1, theta0)
    assert max(gaps.values()) <= TOL, gaps
    for out in outs[1:]:
        for k, v in sound["after1"].items():
            assert torch.equal(out["sound"]["after1"][k], v), k
    # each rank alone: its parameters part, and rank 0's step is not the
    # averaged one
    alone = outs[0]["alone"]
    assert any(not torch.equal(outs[1]["alone"]["after1"][k], v)
               for k, v in alone["after1"].items())
    assert max(_gaps(alone, first, after1, theta0).values()) > TOL
    # the exchange's trace: one span and one call a minibatch, the
    # flattened float32 gradient's bytes a call
    calls = HP["epochs"] * HP["minibatches"]
    for out in outs:
        c = out["sound"]["counters"]
        assert out["sound"]["spans"] == c["allreduce_calls"] == calls
        assert c["allreduce_bytes"] == 4 * out["sound"]["n_params"] * calls


if __name__ == "__main__":
    _rank(sys.argv[1])
