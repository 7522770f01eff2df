"""Imitation learning (steering prediction) on the device.

Counterpart of scripts/train_imitation.py over learn.imitation: the
privileged lane-PD expert collects demos, a behavior-cloned student
(state vectors or camera frames) regresses its actions, optional DAgger
rounds let the student drive while the expert labels, and the student's
closed-loop survival is measured. Runs on the card unless ``--cpu``.

    python -m dtown_torch.train_imitation --map small_loop --envs 512 \\
        --demo-steps 128 --epochs 10 --obs rgb
"""
from __future__ import annotations

import argparse
import json
import time

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--map", default="small_loop")
    ap.add_argument("--envs", type=int, default=512)
    ap.add_argument("--demo-steps", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--obs", default="rgb", choices=["rgb", "state"])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--eval-steps", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dagger-rounds", type=int, default=0,
                    help="DAgger rounds after BC: the learner drives, the "
                         "expert labels, the dataset aggregates")
    ap.add_argument("--dagger-beta", type=float, default=0.5,
                    help="expert-mix probability in round 0 (halved each "
                         "round)")
    ap.add_argument("--ckpt", default=None,
                    help="save the student's parameters here")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    return ap.parse_args(argv)


def main(argv=None):
    from dtown_torch import EnvConfig, load_map
    from dtown_torch.learn import imitation as im

    args = parse_args(argv)
    dev = torch.device("cpu" if args.cpu else "cuda")
    cfg = EnvConfig(obs_type=args.obs, camera_width=args.size,
                    camera_height=args.size)
    maps = load_map(args.map)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.time()
    obs, act = im.collect_demos(cfg, maps, args.envs, args.demo_steps, gen,
                                device=dev)
    n = obs.shape[0] * obs.shape[1]
    float(act.sum())  # waits for the device
    dt = time.time() - t0
    print(json.dumps({"demos": n, "collect_s": round(dt, 1),
                      "demo_steps_per_s": round(n / dt)}))
    init, train_epoch, policy = im.make_bc(cfg, lr=args.lr,
                                           batch_size=args.batch, device=dev)
    bc = init(gen, obs[0])
    for e in range(args.epochs):
        t1 = time.time()
        bc, loss = train_epoch(bc, obs, act)
        print(json.dumps({"epoch": e, "bc_loss": round(float(loss), 6),
                          "seconds": round(time.time() - t1, 1)}))
    beta = args.dagger_beta
    for r in range(args.dagger_rounds):
        d_obs, d_act = im.collect_dagger(cfg, maps, bc.net, policy,
                                         args.envs, args.demo_steps, gen,
                                         beta=beta, device=dev)
        obs, act = torch.cat([obs, d_obs]), torch.cat([act, d_act])
        for _ in range(args.epochs):
            bc, loss = train_epoch(bc, obs, act)
        print(json.dumps({"dagger_round": r, "beta": round(beta, 3),
                          "dataset": int(obs.shape[0] * obs.shape[1]),
                          "bc_loss": round(float(loss), 6)}))
        beta *= 0.5
    surv, mr = im.eval_closed_loop(cfg, maps, bc.net, policy, args.envs,
                                   args.eval_steps, gen, device=dev)
    result = {"closed_loop_survival": round(float(surv), 4),
              "mean_reward": round(float(mr), 4),
              "eval_steps": args.eval_steps}
    print(json.dumps(result))
    if args.ckpt:
        from dtown_torch.utils import checkpoint

        checkpoint.save(args.ckpt, {"net": bc.net})
        print(f"saved params to {args.ckpt}")
    return result


if __name__ == "__main__":
    main()
