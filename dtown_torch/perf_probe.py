"""Attribution probe of the fused step on the card.

Counterpart of scripts/perf_probe.py. Times, each over ``--iters`` steps
after a warm-up of the same shape (median of 3 runs, CUDA events; the
host clock with ``--cpu``):
  state   the state kernel alone (ops.state_kernel.state_step);
  render  the blob render alone on a constant blob
          (render.blob_raster.render_frames_from_blob);
  full    the fused step (state + render + glue, fused_step).
Every frame is consumed: its first plane row is summed each step.

Prints, per phase, one line ``<phase>: <us> us/iter (<M> M steps/s)``.

    python -m dtown_torch.perf_probe --map loop_obstacles --envs 4096
"""
from __future__ import annotations

import argparse
import sys

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--map", default="loop_obstacles")
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--epb", type=int, default=0,
                    help="accepted for compatibility with "
                         "scripts/perf_probe.py; the blob render's launch "
                         "shape is fixed, so it has no effect")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    return ap.parse_args(argv)


def probe(cfg, maps, envs, iters, dev) -> dict:
    """Seconds per step of the phases ("state", "render", "full") of the
    fused rollout of ``cfg`` on ``maps`` at ``envs`` envs, on ``dev``."""
    from dtown_torch.ops import state_kernel as sk
    from dtown_torch.ops.fused_env import make_fused_rollout
    from dtown_torch.render import blob_raster as br
    from dtown_torch.utils.profiling import median_timed

    init_blob, fused_step, _ = make_fused_rollout(cfg, maps, envs,
                                                  device=dev)
    st, pk = fused_step.tables, fused_step.pack
    blob0 = init_blob(torch.Generator(device=dev).manual_seed(0))
    actions = torch.tensor([0.4, 0.1], device=dev).repeat(envs, 1)
    report = {}

    carry = [blob0]

    def run_state():
        for _ in range(iters):
            carry[0] = sk.state_step(carry[0], actions, st)

    report["state"] = median_timed(run_state, dev) / iters
    print(f"state : {report['state'] * 1e3:8.3f} ms/iter", file=sys.stderr)

    if pk is not None and not pk.get("planless"):
        def run_render():
            acc = None
            for _ in range(iters):
                obs = br.render_frames_from_blob(blob0, pk)
                acc = obs[:, 0, 0, :].sum(dtype=torch.int64)
            return acc

        report["render"] = median_timed(run_render, dev) / iters
        print(f"render: {report['render'] * 1e3:8.3f} ms/iter",
              file=sys.stderr)

    carry = [blob0]

    def run_full():
        acc = None
        for _ in range(iters):
            carry[0], out, obs = fused_step(carry[0], actions)
            acc = out.reward.sum() + obs[:, 0, 0, :].sum(dtype=torch.int64)
        return acc

    report["full"] = median_timed(run_full, dev) / iters
    print(f"full  : {report['full'] * 1e3:8.3f} ms/iter", file=sys.stderr)
    return report


def main(argv=None):
    from dtown_torch import EnvConfig, load_map
    from dtown_torch.device import describe, resolve_device

    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    print(f"device: {dev} ({describe(dev)})", file=sys.stderr)
    cfg = EnvConfig(obs_type="rgb", camera_width=args.size,
                    camera_height=args.size, renderer="pallas")
    report = probe(cfg, load_map(args.map), args.envs, args.iters, dev)
    for k, v in report.items():
        print(f"{k}: {v * 1e6:.1f} us/iter ({args.envs / v / 1e6:.3f} M "
              f"steps/s)", flush=True)
    return report


if __name__ == "__main__":
    main()
