"""Phase bisection of the step path: where a batched step's time goes.

Counterpart of scripts/bench_profile.py. Each phase runs ``--iters``
times in a loop, once to warm up and once timed (CUDA events; the host
clock with ``--cpu``), on the batched states of ``--envs`` envs reset on
``--map``:
  dynamics       the wheel model and the integrator (dynamics.py);
  lane_pos       the lane query (geometry.get_lane_pos2);
  collision      SAT validity and the proximity penalty (physics.py);
  npc_objects    the NPC update (objects.step_dynamic_objects);
  reset_full     a fresh reset of every env (env.reset);
  render_ground  the camera rays and the shaded ground
                 (render/raster.py camera_rays, _ground_color);
  render_full    the whole frame (env.render_obs: the ray-caster);
  full_step      the whole per-env step (env.step: physics, auto-reset,
                 the ray-caster's frame).

Prints ONE JSON line {phase: ms per iteration}.

    python -m dtown_torch.bench_profile [--map udem1] [--envs 1024] [--cpu]
"""
from __future__ import annotations

import argparse
import json
import sys

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--map", default="udem1")
    ap.add_argument("--envs", type=int, default=1024)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    return ap.parse_args(argv)


def phases(cfg, maps, states, action, generator):
    """{name: fn(states) -> states} of the eight phases; ``maps`` and
    ``states`` on one device, ``generator`` on it."""
    from dtown_torch import env, objects, physics
    from dtown_torch.dynamics import integrate, wheel_model
    from dtown_torch.geometry import get_lane_pos2
    from dtown_torch.render.raster import _ground_color, camera_rays

    B = states.batch_size
    facts = env.host_facts(cfg, maps)
    obj_active = maps.obj_mask.expand(B, -1)
    obj_pos = maps.obj_pos.expand(B, -1, -1)

    def dynamics(s):
        wheels = torch.clamp(wheel_model(
            action, cfg.gain, cfg.trim, cfg.wheel_radius, cfg.k, cfg.limit,
            s.wheel_dist), -1.0, 1.0)
        pos, angle, speed, _ = integrate(s.pos, s.angle, wheels,
                                         s.robot_speed, s.wheel_dist,
                                         cfg.delta_time, 1)
        return s.replace(pos=pos, angle=angle, speed=speed)

    def lane_pos(s):
        lp = get_lane_pos2(maps, s.pos, s.angle)
        return s.replace(speed=s.speed + 1e-9 * lp.dist)

    def collision(s):
        _, _ = physics.valid_pose(maps, s.pos, s.angle, maps.obj_corners,
                                  maps.obj_norms, obj_active)
        pen = physics.proximity_penalty(s.pos, s.angle, obj_pos,
                                        maps.obj_safety_rad, obj_active,
                                        maps.obj_is_dynamic)
        return s.replace(speed=s.speed + 1e-9 * pen)

    def npc_objects(s):
        return s.replace(dyn=objects.step_dynamic_objects(
            maps, s.dyn, cfg.delta_time))

    def reset_full(s):
        return env.reset(cfg, maps, generator, B, facts.n_ok)

    def render_ground(s):
        rays, eye = camera_rays(cfg, s)
        rgb, _ = _ground_color(cfg, maps, s, rays, eye)
        return s.replace(speed=s.speed + 1e-12 * rgb.sum((1, 2, 3)))

    def render_full(s):
        img = env.render_obs(cfg, maps, s)
        return s.replace(speed=s.speed + 1e-12 * img.to(torch.float32).sum(
            (1, 2, 3)))

    def full_step(s):
        return env.step(cfg, maps, s, action, generator=generator,
                        facts=facts)[0]

    return dict(dynamics=dynamics, lane_pos=lane_pos, collision=collision,
                npc_objects=npc_objects, reset_full=reset_full,
                render_ground=render_ground, render_full=render_full,
                full_step=full_step)


def profile(cfg, maps, envs, iters, dev) -> dict:
    """{phase: ms per iteration} of the step path of ``cfg`` on ``maps``
    (numpy or tensors) at ``envs`` envs on ``dev``."""
    from dtown_torch import env
    from dtown_torch.utils.profiling import timed

    maps = maps.to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    states = env.reset(cfg, maps, gen, envs)
    action = torch.tensor([0.4, 0.1], device=dev).repeat(envs, 1)
    results = {}
    for name, fn in phases(cfg, maps, states, action, gen).items():
        def loop():
            s = states
            for _ in range(iters):
                s = fn(s)
            return s

        loop()                          # warm up the same loop
        dt, _ = timed(loop, dev)
        results[name] = dt / iters * 1e3
        print(f"{name:28s}: {results[name]:10.4f} ms/iter", file=sys.stderr)
    return results


def main(argv=None):
    from dtown_torch import EnvConfig, load_map
    from dtown_torch.device import describe, resolve_device

    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    print(f"device: {dev} ({describe(dev)})  map={args.map} "
          f"envs={args.envs}", file=sys.stderr)
    cfg = EnvConfig(obs_type="rgb", camera_width=args.size,
                    camera_height=args.size)
    results = profile(cfg, load_map(args.map), args.envs, args.iters, dev)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
