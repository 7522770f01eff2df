"""Small PPO hyperparameter sweep on the fused state-obs path.

Counterpart of scripts/sweep_ppo.py over learn.ppo.make_ppo(fused=True):
a grid of short training runs, one after another on one device (the
card unless ``--cpu``), one JSON line per run with the mean reward and
done fraction over the last quarter of the iterations (and, with
``--seeds``, one more line per grid point averaged over the seeds).

    python -m dtown_torch.sweep_ppo --map small_loop --envs 1024 --iters 40
"""
from __future__ import annotations

import argparse
import itertools
import json
import time

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--map", default="small_loop")
    ap.add_argument("--envs", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--rollout", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--lrs", default="3e-4,1e-3")
    ap.add_argument("--ents", default="0.01,0.003")
    ap.add_argument("--epochs", default="2,4")
    ap.add_argument("--minibatches", default="4")
    ap.add_argument("--seeds", default=None,
                    help="comma list of seeds (overrides --seed; results "
                         "are printed per seed AND averaged)")
    return ap.parse_args(argv)


def run_one(cfg, maps, envs, iters, rollout, seed, dev, **ppo_kw):
    """One training run; returns its summary dict."""
    from dtown_torch.learn.ppo import PPOConfig, make_ppo

    ppo = PPOConfig(rollout_len=rollout, **ppo_kw)
    init, train = make_ppo(cfg, maps, envs, ppo, fused=True, device=dev)
    ts = init(torch.Generator(device=dev).manual_seed(seed))
    hist = []
    t0 = time.perf_counter()
    for _ in range(iters):
        ts, metrics = train(ts)
        hist.append({k: float(v) for k, v in metrics.items()})  # waits
    dt = time.perf_counter() - t0
    tail = hist[-max(1, len(hist) // 4):]
    return dict(
        mean_reward_tail=float(np.mean([h["mean_reward"] for h in tail])),
        done_frac_tail=float(np.mean([h["done_frac"] for h in tail])),
        mean_reward_first=hist[0]["mean_reward"],
        seconds=dt,
    )


def main(argv=None):
    from dtown_torch import EnvConfig, load_map
    from dtown_torch.device import resolve_device

    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    cfg = EnvConfig(obs_type="state")
    maps = load_map(args.map)
    grid = list(itertools.product(
        [float(x) for x in args.lrs.split(",")],
        [float(x) for x in args.ents.split(",")],
        [int(x) for x in args.epochs.split(",")],
        [int(x) for x in args.minibatches.split(",")],
    ))
    seeds = ([int(x) for x in args.seeds.split(",")] if args.seeds
             else [args.seed])
    lines = []
    for lr, ent, ep, mb in grid:
        point = {"lr": lr, "ent_coef": ent, "epochs": ep, "minibatches": mb}
        tails = []
        for sd in seeds:
            res = run_one(cfg, maps, args.envs, args.iters, args.rollout,
                          sd, dev, lr=lr, ent_coef=ent, epochs=ep,
                          minibatches=mb)
            tails.append(res["mean_reward_tail"])
            lines.append({**point, "seed": sd, **res})
            print(json.dumps(lines[-1]), flush=True)
        if len(seeds) > 1:
            lines.append({**point,
                          "mean_reward_tail_avg": float(np.mean(tails))})
            print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main()
