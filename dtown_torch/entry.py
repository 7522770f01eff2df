"""Entry points: the one-card step check and the multi-rank dry run.

Counterpart of the reference's ``__graft_entry__.py``.

    python -m dtown_torch.entry            # entry() once on the card
    python -m dtown_torch.entry --dryrun 2 # dryrun_multichip(2) on the CPU
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

DRYRUN_TIMEOUT = 600.0


def entry(device="cuda"):
    """(fn, example_args): the flagship step as one function. fn(net,
    states) steps the batch, renders the camera frames on the device (the
    row-fed render kernel, renderer="pallas"), runs the actor-critic on
    them and steps again with its actions: loop_obstacles, 32 envs, 64x64
    RGB. Returns (reward sum + value sum, the final positions [32, 3])."""
    from dtown_torch import EnvConfig, load_map
    from dtown_torch.device import resolve_device
    from dtown_torch.env import make_vec_env
    from dtown_torch.learn.networks import ActorCritic
    from dtown_torch.learn.ppo import obs_shape

    dev = resolve_device(device)
    cfg = EnvConfig(obs_type="rgb", camera_width=64, camera_height=64,
                    renderer="pallas")
    num_envs = 32
    v_reset, v_step = make_vec_env(cfg, load_map("loop_obstacles"),
                                   num_envs, device=dev)
    states = v_reset(torch.Generator(device=dev).manual_seed(0))
    zeros = torch.zeros((num_envs, 2), device=dev)
    _, out0 = v_step(states, zeros)
    net = ActorCritic(obs_shape(out0.obs), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(1))

    def fn(net, states):
        with torch.no_grad():
            states2, out = v_step(states, zeros)
            mean, _, value = net(out.obs)
            states3, out2 = v_step(states2, torch.tanh(mean))
        return out2.reward.sum() + value.sum(), states3.pos

    return fn, (net, states)


def _dryrun_rank():
    """One rank of dryrun_multichip: one sharded train step of each
    variant, on the CPU over gloo; rank 0 prints the averaged metrics."""
    import torch.distributed as dist

    from dtown_torch import EnvConfig, load_map
    from dtown_torch.learn.ppo import PPOConfig
    from dtown_torch.parallel.mesh import make_mesh, make_mesh_hier
    from dtown_torch.parallel.shard import make_sharded_ppo

    torch.set_num_threads(1)
    mesh = make_mesh("cpu")
    n = mesh.world
    cfg = EnvConfig(obs_type="rgb", camera_width=16, camera_height=16,
                    max_visible_objects=2)
    maps = load_map("small_loop")
    ppo = PPOConfig(rollout_len=4, epochs=1, minibatches=2)
    variants = [("", dict(num_envs=2 * n), mesh, 0),
                # the fused rollout's blob carried per rank, 8 envs a rank
                ("fused", dict(num_envs=8 * n, fused=True), mesh, 1),
                # the LSTM carry sharded on the env axis with the states
                ("rnn", dict(num_envs=2 * n, rnn=True, rnn_hidden=16),
                 mesh, 3)]
    if n % 2 == 0:
        variants.append((f"hier(2x{n // 2})", dict(num_envs=2 * n),
                         make_mesh_hier(2, "cpu"), 2))
    try:
        for tag, kw, m, seed in variants:
            num_envs = kw.pop("num_envs")
            _, init, train = make_sharded_ppo(cfg, maps, num_envs, ppo, m,
                                              **kw)
            ts, metrics = train(init(seed))
            metrics = {k: float(v) for k, v in metrics.items()}
            if mesh.rank == 0:
                print(f"dryrun_multichip({n}){' ' + tag if tag else ''}: ok,"
                      f" metrics={json.dumps(metrics)}", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, timeout: float = DRYRUN_TIMEOUT):
    """Run one sharded PPO train step of each variant over ``n_devices``
    gloo ranks on the CPU (one process each): the step path, the fused
    rollout (8 envs a rank), the recurrent learner and, for an even count,
    the (2, n/2) hierarchical split. Prints rank 0's averaged metrics;
    raises if a rank fails or does not finish within ``timeout`` s."""
    import os

    from dtown_torch.parallel.mesh import spawn_ranks

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    outs = spawn_ranks(n_devices, ["-m", "dtown_torch.entry",
                                   "--dryrun-rank"], timeout=timeout,
                       env=env)
    print(outs[0][0], end="")
    return outs[0][0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dryrun", type=int, default=0,
                    help="dryrun_multichip over this many CPU ranks")
    ap.add_argument("--dryrun-rank", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.dryrun_rank:
        _dryrun_rank()
    elif args.dryrun:
        dryrun_multichip(args.dryrun)
    else:
        fn, example = entry()
        value, pos = fn(*example)
        print(f"entry: value {float(value):.6g}, positions "
              f"{tuple(pos.shape)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
