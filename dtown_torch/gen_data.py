"""Generate a steering-prediction dataset by driving the simulator.

Counterpart of scripts/gen_data.py. The privileged lane-PD expert
(learn.imitation) drives ``--envs`` envs on the device; the (observation,
expert action) pairs are written once as one ``.npz`` in the format that
scripts/train_torch_bc.py reads: ``obs`` [N, H, W, C] uint8 (or [N, 11]
f32), ``act`` [N, 2] f32, the flattened (step, env) provenance indices
``step_idx`` / ``env_idx`` and a JSON ``meta`` string. Runs on the card
unless ``--cpu``.

    python -m dtown_torch.gen_data --map small_loop --envs 64 --steps 200 \\
        --obs rgb --size 64 --out demos.npz
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--map", default="small_loop", nargs="+")
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--obs", default="rgb", choices=["rgb", "state"])
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--domain-rand", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="dtown_torch_demos.npz")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    return ap.parse_args(argv)


def main(argv=None):
    from dtown_torch import EnvConfig, load_map, stack_maps
    from dtown_torch.learn.imitation import collect_demos

    args = parse_args(argv)
    dev = torch.device("cpu" if args.cpu else "cuda")
    cfg = EnvConfig(obs_type=args.obs, camera_width=args.size,
                    camera_height=args.size, domain_rand=args.domain_rand)
    names = args.map if isinstance(args.map, list) else [args.map]
    maps = stack_maps(names) if len(names) > 1 else load_map(names[0])
    t0 = time.perf_counter()
    obs, act = collect_demos(cfg, maps, args.envs, args.steps,
                             torch.Generator(device=dev)
                             .manual_seed(args.seed), device=dev)
    obs_np = obs.flatten(0, 1).cpu().numpy()  # waits for the device
    act_np = act.flatten(0, 1).cpu().numpy()
    dt = time.perf_counter() - t0
    T, B = act.shape[:2]
    np.savez_compressed(
        args.out, obs=obs_np, act=act_np,
        step_idx=np.repeat(np.arange(T), B), env_idx=np.tile(np.arange(B),
                                                             T),
        meta=json.dumps({"maps": names, "obs_type": args.obs,
                         "size": args.size, "domain_rand": args.domain_rand,
                         "seed": args.seed}))
    summary = {"samples": int(T * B), "obs_shape": list(obs_np.shape[1:]),
               "out": args.out, "bytes": os.path.getsize(args.out),
               "gen_steps_per_s": round(T * B / dt)}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
