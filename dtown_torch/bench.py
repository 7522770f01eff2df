"""Benchmark: env-steps/s of the full step (dynamics + NPCs + collision +
reward + render) on one card.

Counterpart of the repo's bench.py. The fused path (the default) runs
make_fused_rollout's rollout: the state kernel and the blob render once a
step each (the state kernel alone with ``--obs state``); ``--no-fused``
runs the step path (env.step_batch) with the row-fed render kernels
(``--renderer pallas``) or the ray-caster (``--renderer xla``). Times are
CUDA events on the card, the host clock with ``--cpu``. The fused path
takes the paired two-point measurement, steps/s = envs * n / (t(2n) -
t(n)), which cancels a call's fixed cost.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}, the
metric named as bench.py names it with the prefix ``torch_``;
vs_baseline is against the reference's ~500 env-steps/s estimate
(BASELINE.md). The card's name and power limit go to stderr.

    python -m dtown_torch.bench [--map loop_obstacles] [--envs 4096] [--cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

REFERENCE_STEPS_PER_S = 500.0  # BASELINE.md engineering estimate


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--map", default="loop_obstacles",
                    help="a map, or a comma list of maps (a stack)")
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--width", type=int, default=0,
                    help="camera width override (default: --size)")
    ap.add_argument("--height", type=int, default=0,
                    help="camera height override (default: --size)")
    ap.add_argument("--iters", type=int, default=256)
    ap.add_argument("--obs", default="rgb", choices=["rgb", "state"])
    ap.add_argument("--grayscale", action="store_true",
                    help="single in-kernel luma plane (BASELINE config 2)")
    ap.add_argument("--domain-rand", action="store_true")
    ap.add_argument("--distortion", action="store_true",
                    help="fisheye distortion on the obs (baked into the "
                         "render kernel's ray table)")
    ap.add_argument("--no-autoreset", action="store_true")
    ap.add_argument("--no-objects", action="store_true")
    ap.add_argument("--lod", type=float, default=None,
                    help="obj_lod_px override (size-aware prim LOD cull; 0 "
                         "disables; default: EnvConfig)")
    ap.add_argument("--cull", type=float, default=None,
                    help="obj_cull_dist override (m)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--renderer", default="pallas", choices=["xla", "pallas"])
    ap.add_argument("--fused", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="blob-carried rollout: the state kernel + the blob "
                         "render per step (--no-fused for the step path)")
    ap.add_argument("--unroll", type=int, default=4,
                    help="accepted for compatibility with bench.py; eager "
                         "torch has no loop transform to unroll, so it has "
                         "no effect")
    args = ap.parse_args(argv)
    if args.distortion and args.obs != "rgb":
        ap.error("--distortion applies to image observations only "
                 "(got --obs state)")
    return args


def config(args):
    """(EnvConfig, maps, map label) of the arguments."""
    from dtown_torch import EnvConfig, load_map, stack_maps

    cfg = EnvConfig(
        obs_type=args.obs, camera_width=args.width or args.size,
        camera_height=args.height or args.size, grayscale=args.grayscale,
        domain_rand=args.domain_rand, distortion=args.distortion,
        auto_reset=not args.no_autoreset,
        render_objects=not args.no_objects, renderer=args.renderer)
    if args.lod is not None:
        cfg = dataclasses.replace(cfg, obj_lod_px=args.lod)
    if args.cull is not None:
        cfg = dataclasses.replace(cfg, obj_cull_dist=args.cull)
    names = args.map.split(",")
    if len(names) > 1:
        # a stack: env b on member b % n_maps (the curriculum of BASELINE
        # config 5)
        return cfg, stack_maps(names), f"multimap{len(names)}"
    return cfg, load_map(args.map), args.map


def two_point(rollout, n, envs, dev):
    """Marginal env-steps/s of rollout(n_iters): the median of 3
    paired differences t(2n) - t(n), retried with fresh warm-ups when
    noise swamps the margin; past 3 attempts the single-call rate when
    t(n) > 0.2 s, else SystemExit (raise --iters). bench.py also perturbs
    the actions before a retry, against a TPU runtime that memoized
    repeat calls; eager torch memoizes nothing, so the retry re-warms
    only."""
    from dtown_torch.utils.profiling import timed

    n2 = 2 * n
    rollout(n2)                                          # warm 2n
    for attempt in range(3):
        dts, t1s = [], []
        for _ in range(3):
            t1, _ = timed(lambda: rollout(n), dev)
            t2, _ = timed(lambda: rollout(n2), dev)
            t1s.append(t1)
            dts.append(t2 - t1)          # PAIRED diff: cancels slow drift
        dt, t1 = sorted(dts)[1], sorted(t1s)[1]
        if dt > 0 and dt >= 0.1 * t1:
            break
        print(f"two-point attempt {attempt + 1} degenerate (paired diffs "
              f"{[f'{d * 1e3:.1f}ms' for d in dts]} vs t(n)~"
              f"{t1 * 1e3:.0f} ms), retrying", file=sys.stderr)
        rollout(n2)
    else:
        if t1 <= 0.2:
            sys.exit(f"two-point measurement degenerate (paired diffs "
                     f"{[f'{d * 1e3:.1f}ms' for d in dts]} vs t(n)~"
                     f"{t1 * 1e3:.0f} ms): rerun with a larger --iters")
        dt = t1
        print("two-point degenerate after retries; falling back to the "
              f"single-call rate over t(n)={t1:.3f}s", file=sys.stderr)
    rate = envs * n / dt
    print(f"two-point {n}/{n2} x {envs} envs: median t(n)={t1:.6f}s paired "
          f"dt={dt:.6f}s -> marginal {rate / 1e6:.6f} M steps/s (fixed "
          f"per-call ~{max(0.0, t1 - dt) * 1e3:.3f} ms) [fused]",
          file=sys.stderr)
    return rate


def run(args) -> dict:
    """The benchmark of parsed ``args``; returns the JSON line's dict."""
    from dtown_torch import env
    from dtown_torch.device import describe, resolve_device
    from dtown_torch.ops.fused_env import make_fused_rollout
    from dtown_torch.utils.profiling import timed

    dev = resolve_device("cpu" if args.cpu else "cuda")
    cfg, maps, map_label = config(args)
    W, H = cfg.camera_width, cfg.camera_height
    print(f"device: {dev} ({describe(dev)})", file=sys.stderr)
    actions = torch.tensor([0.4, 0.1], device=dev).repeat(args.envs, 1)
    gen = torch.Generator(device=dev).manual_seed(0)

    if args.fused:
        init_blob, _, f_rollout = make_fused_rollout(cfg, maps, args.envs,
                                                     device=dev)
        t, blob = timed(lambda: init_blob(gen), dev)
        print(f"reset: {t:.3f}s", file=sys.stderr)
        carry = [blob]

        def rollout(n):
            # the blob carries on: each call steps fresh values
            carry[0], r, o = f_rollout(carry[0], actions, n)
            return r, o

        t, _ = timed(lambda: rollout(args.iters), dev)
        print(f"step warm-up: {t:.3f}s", file=sys.stderr)
        rate = two_point(rollout, args.iters, args.envs, dev)
        tag = "gray" if args.grayscale else args.obs
        if args.distortion:
            tag += "_fisheye"
        metric = (f"torch_env_steps_per_s_{W}x{H}_{tag}_{args.envs}envs_"
                  f"{map_label}_fused")
    else:
        maps_d = maps.to(dev)
        facts = env.host_facts(cfg, maps_d)
        pack = env.row_pack(cfg, maps_d)
        # every env starts on member 0, as bench.py's reset (idx = 0)
        first = maps_d.map_at(0) if maps_d.is_stack else maps_d
        t, states = timed(lambda: env.reset(cfg, first, gen, args.envs),
                          dev)
        print(f"reset: {t:.3f}s", file=sys.stderr)
        carry = [states]

        def rollout(n):
            acc = None
            for _ in range(n):
                carry[0], out = env.step_batch(
                    cfg, maps_d, carry[0], actions, generator=gen,
                    pack=pack, facts=facts)
                # consume the frames, as bench.py's scan outputs do
                acc = out.reward.sum() + out.obs.sum(dtype=torch.int64)
            return acc

        t, _ = timed(lambda: rollout(args.iters), dev)
        print(f"step warm-up: {t:.3f}s", file=sys.stderr)
        dt, _ = timed(lambda: rollout(args.iters), dev)
        rate = args.envs * args.iters / dt
        print(f"{args.iters} x {args.envs} envs in {dt:.6f}s "
              f"({rate / 1e6:.6f} M steps/s)", file=sys.stderr)
        metric = (f"torch_env_steps_per_s_{W}x{H}_{args.obs}_{args.envs}envs"
                  f"_{map_label}")
    unit = "env-steps/s/chip" if dev.type == "cuda" else "env-steps/s/cpu"
    return {"metric": metric, "value": rate, "unit": unit,
            "vs_baseline": rate / REFERENCE_STEPS_PER_S}


def main(argv=None):
    out = run(parse_args(argv))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
