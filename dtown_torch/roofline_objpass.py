"""The blob render's object pass against the card's instruction bound.

Counterpart of scripts/roofline_objpass.py, whose census counts a TPU's
vector instructions against a v5e's vector rate; neither carries over.
Here:

1. MEASURED object-pass time: the blob render (K2) with objects minus
   the same render with ``render_objects=False`` (ground and sky only),
   per launch, the median of 3 loops of 64 launches (CUDA events).
2. COUNTED work: the instructions of the object pass on this blob, by
   the kernel's own culls (roofline.k2_ops with the objects minus
   k2_ops without them). The kernel builds with -fmad=false, so every
   operation is one instruction: ops and instructions per pixel agree.
3. CEILING: the card's float32 instruction rate,
   roofline.PEAK_INSTR (the published peak over 2).

gap = measured object-pass time / (instructions / PEAK_INSTR); a gap
below 1.0 means the count is wrong.

Prints ONE JSON line {"metric", "value", "unit", "detail"}; the detail
keeps the reference's ops_per_px, instr_per_px and the three times, and
gives bound_ms and the peak in place of its v5e clock range. With
``--cpu`` the times are the host's and the gap is not measured (null).

    python -m dtown_torch.roofline_objpass [--map udem1] [--envs 4096]
"""
from __future__ import annotations

import argparse
import json
import sys

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--map", default="udem1")
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--iters", type=int, default=64)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    return ap.parse_args(argv)


def render_time(cfg, maps, envs, dev, iters, reps=3):
    """(median seconds per launch of the blob render, the blob, the pack)
    on fresh states of ``envs`` envs."""
    from dtown_torch.ops.fused_env import make_fused_rollout
    from dtown_torch.render import blob_raster as br
    from dtown_torch.utils.profiling import median_timed

    init_blob, fused_step, _ = make_fused_rollout(cfg, maps, envs,
                                                  device=dev)
    pk = fused_step.pack
    if pk is None or pk.get("planless"):
        raise ValueError("the object pass is the blob render's: the map is "
                         "past its render plan")
    blob = init_blob(torch.Generator(device=dev).manual_seed(0))

    def loop():
        acc = None
        for _ in range(iters):
            acc = br.render_frames_from_blob(blob, pk)[:, 0, 0, :].sum(
                dtype=torch.int64)
        return acc

    return median_timed(loop, dev, reps) / iters, blob, pk


def objpass(map_name, envs, size, iters, dev) -> dict:
    """The JSON line's dict for ``map_name`` at ``envs`` envs of
    ``size`` x ``size`` frames on ``dev``."""
    from dtown_torch import EnvConfig, load_map
    from dtown_torch.device import describe
    from dtown_torch.roofline import PEAK_INSTR, k2_ops

    maps = load_map(map_name)
    cfg = EnvConfig(obs_type="rgb", camera_width=size, camera_height=size)
    cfg_ng = EnvConfig(obs_type="rgb", camera_width=size, camera_height=size,
                       render_objects=False)
    t_full, blob, pk = render_time(cfg, maps, envs, dev, iters)
    t_ground, _, pk_ng = render_time(cfg_ng, maps, envs, dev, iters)
    P = size * size
    instr = k2_ops(blob, pk, P) - k2_ops(blob, pk_ng, P)
    if instr <= 0:
        raise ValueError(f"{map_name} has no object in view: no object pass")
    t_obj = t_full - t_ground
    px = envs * P
    bound_s = instr / PEAK_INSTR
    gap = t_obj / bound_s if dev.type == "cuda" else None
    print(f"map {map_name}: {pk['n_objs']} objects -> {instr / px:.6g} "
          f"instructions per pixel on this blob", file=sys.stderr)
    print(f"render: full {t_full * 1e3:.6f} ms, ground-only "
          f"{t_ground * 1e3:.6f} ms -> object pass {t_obj * 1e3:.6f} ms "
          f"({px / 1e6:.6g} Mpx); bound {bound_s * 1e3:.6f} ms -> gap "
          f"{gap} on {describe(dev)}", file=sys.stderr)
    return {
        "metric": f"objpass_gap_to_instr_sol_{map_name}",
        "value": gap,
        "unit": "x (1.0 = speed of light: float32 instructions at the "
                "published peak rate)",
        "detail": {
            "ops_per_px": instr / px, "instr_per_px": instr / px,
            "obj_pass_ms": t_obj * 1e3, "full_ms": t_full * 1e3,
            "ground_ms": t_ground * 1e3, "bound_ms": bound_s * 1e3,
            "peak_instr_per_s": PEAK_INSTR, "device": describe(dev),
        },
    }


def main(argv=None):
    from dtown_torch.device import resolve_device

    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    out = objpass(args.map, args.envs, args.size, args.iters, dev)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
