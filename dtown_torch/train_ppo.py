"""Train a PPO lane-following (or Nav) policy on one device.

Counterpart of scripts/train_ppo.py, with its flags and defaults.
Observations never leave the device; the host reads the scalar metrics
once an iteration. Runs on the card unless ``--cpu`` is given (the
kernels' plain versions then run on the CPU).

    python -m dtown_torch.train_ppo --fused --map loop_obstacles --envs 4096
    python -m dtown_torch.train_ppo --cpu --fused --envs 16 --size 32 \
        --rollout 4 --iters 2

Not ported yet, and refused: checkpoints (--ckpt, --ckpt-every, --resume)
and training sharded over several devices.
"""
from __future__ import annotations

import argparse
import json
import time

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--map", default="small_loop", nargs="+")
    ap.add_argument("--envs", type=int, default=256)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--rollout", type=int, default=64)
    ap.add_argument("--domain-rand", action="store_true")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint path (not ported yet: refused)")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-keep", type=int, default=2)
    ap.add_argument("--resume", default=None,
                    help="restore a checkpoint (not ported yet: refused)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--renderer", default="pallas", choices=["xla", "pallas"])
    ap.add_argument("--fused", action="store_true",
                    help="blob-carried rollouts through the fused kernels")
    ap.add_argument("--obs", default="rgb", choices=["rgb", "state"])
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ent-coef", type=float, default=0.01)
    ap.add_argument("--gamma", type=float, default=0.99)
    ap.add_argument("--gae-lambda", type=float, default=0.95)
    ap.add_argument("--clip-eps", type=float, default=0.2)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--minibatches", type=int, default=8)
    ap.add_argument("--reward-scale", type=float, default=0.02)
    ap.add_argument("--trunk", default="nature", choices=["nature", "impala"])
    ap.add_argument("--nav", action="store_true",
                    help="the Nav task (goal tiles); fused only")
    ap.add_argument("--nav-shaping", type=float, default=0.0,
                    help="Nav goal-distance shaping coefficient")
    ap.add_argument("--goal-in-obs", action="store_true",
                    help="add the agent-frame goal to the observations")
    ap.add_argument("--rnn", action="store_true",
                    help="recurrent (LSTM) policy on the step path")
    ap.add_argument("--rnn-hidden", type=int, default=128)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.ckpt or args.resume or args.ckpt_every:
        raise NotImplementedError(
            "checkpoints (--ckpt, --ckpt-every, --resume) are not ported "
            "yet")
    return args


def build(args):
    """(init, train_step, device) of the learner the flags select."""
    from dtown_torch import EnvConfig, load_map, stack_maps
    from dtown_torch.learn.ppo import PPOConfig, make_ppo

    cfg = EnvConfig(obs_type=args.obs, camera_width=args.size,
                    camera_height=args.size, domain_rand=args.domain_rand,
                    renderer=args.renderer,
                    nav_shaping_coef=args.nav_shaping)
    names = [args.map] if isinstance(args.map, str) else args.map
    maps = stack_maps(names) if len(names) > 1 else load_map(names[0])
    ppo = PPOConfig(
        rollout_len=args.rollout, lr=args.lr, ent_coef=args.ent_coef,
        gamma=args.gamma, gae_lambda=args.gae_lambda,
        clip_eps=args.clip_eps, epochs=args.epochs,
        minibatches=args.minibatches, reward_scale=args.reward_scale,
        trunk=args.trunk)
    device = "cpu" if args.cpu else "cuda"
    if args.rnn:
        if args.fused or args.nav:
            raise ValueError("--rnn runs on the step path: no --fused or "
                             "--nav")
        from dtown_torch.learn.ppo_rnn import make_ppo_rnn

        init, train = make_ppo_rnn(cfg, maps, args.envs, ppo,
                                   hidden=args.rnn_hidden, device=device)
    else:
        if args.nav and not args.fused:
            raise ValueError("--nav requires --fused")
        init, train = make_ppo(cfg, maps, args.envs, ppo, fused=args.fused,
                               nav=args.nav, goal_in_obs=args.goal_in_obs,
                               device=device)
    return init, train, torch.device(device)


def main(argv=None):
    args = parse_args(argv)
    init, train, dev = build(args)
    print(f"devices: 1 x {dev.type}")
    totals = {}
    t0 = time.perf_counter()
    ts = init(torch.Generator(device=dev).manual_seed(args.seed))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    totals["init"] = time.perf_counter() - t0
    totals["train"] = 0.0
    for it in range(args.iters):
        t0 = time.perf_counter()
        ts, metrics = train(ts)
        metrics = {k: float(v) for k, v in metrics.items()}  # waits
        totals["train"] += time.perf_counter() - t0
        if it % args.log_every == 0 or it == args.iters - 1:
            print(json.dumps({"iter": it, **{k: round(v, 4)
                                             for k, v in metrics.items()}}))
    steps = args.envs * args.rollout * args.iters
    report = {k: {"seconds": round(v, 3)} for k, v in totals.items()}
    if totals["train"] > 0:
        report["train"]["steps_per_s"] = round(steps / totals["train"], 1)
    print(json.dumps(report))
    return ts


if __name__ == "__main__":
    main()
