"""LOD adoption gate: pixel difference of obj_lod_px against LOD off over
fresh reset states, per map and frame size.

Counterpart of scripts/lod_probe.py (the gate: mean |diff| < 1 and
frac(|diff| > 10) < 1%). Frames come from the ray-caster
(render/raster.py; the blob render applies the same per-primitive cull),
on the card unless ``--cpu``.

    python -m dtown_torch.lod_probe --maps udem1,loop_obstacles --q 1.0,1.5,2.0
"""
from __future__ import annotations

import argparse
import dataclasses

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--maps", default="udem1,loop_obstacles,bigtown")
    ap.add_argument("--q", default="1.0,1.5,2.0")
    ap.add_argument("--sizes", default="64,96")
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--domain-rand", action="store_true",
                    help="gate the DR render path too (config-4 class)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    return ap.parse_args(argv)


def lod_diff(cfg, maps, states, q):
    """(mean |diff|, frac(|diff| > 10), max |diff|) of the frames of
    ``states`` at obj_lod_px=q against obj_lod_px=0 (LOD off), ``cfg``
    otherwise; ``maps`` is the tensor map on the states' device."""
    from dtown_torch import env

    base = dataclasses.replace(cfg, obj_lod_px=0.0)
    img0 = env.render_obs(base, maps, states).to(torch.int32)
    img = env.render_obs(dataclasses.replace(cfg, obj_lod_px=q), maps,
                         states).to(torch.int32)
    d = (img - img0).abs()
    return (float(d.float().mean()), float((d > 10).float().mean()),
            int(d.max()))


def gate(mean, frac):
    return mean < 1.0 and frac < 0.01


def main(argv=None):
    from dtown_torch import EnvConfig, env, load_map
    from dtown_torch.device import resolve_device

    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    lines = []
    for map_name in args.maps.split(","):
        maps = load_map(map_name).to(dev)
        for size in (int(s) for s in args.sizes.split(",")):
            cfg = EnvConfig(obs_type="rgb", camera_width=size,
                            camera_height=size, auto_reset=False,
                            domain_rand=args.domain_rand, obj_lod_px=0.0)
            states = env.reset(cfg, maps, torch.Generator(
                device=dev).manual_seed(args.seed), args.envs)
            for q in (float(x) for x in args.q.split(",")):
                mean, frac, mx = lod_diff(cfg, maps, states, q)
                line = (f"{map_name:16s} {size}x{size} q={q:3.1f}: mean "
                        f"{mean:.4f}  frac>10 {frac:.5f}  max {mx:3d}  "
                        f"{'PASS' if gate(mean, frac) else 'FAIL'}")
                print(line, flush=True)
                lines.append(line)
    return lines


if __name__ == "__main__":
    main()
