"""Single-env frame rate: the reference's own measurement loop on the port.

Counterpart of the repo's benchmark.py (the wall-clock FPS of reset +
step + render on one env, SURVEY.md §2.17): ``dtown_torch.make(<map>)``
at 640x480, one numpy frame back to the host a step (host clock). For
the vectorized throughput use ``python -m dtown_torch.bench``.

    python -m dtown_torch.benchmark [--map udem1] [--steps 300] [--cpu]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--map", default="udem1")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    return ap.parse_args(argv)


def measure(map_name, steps, width, height, dev) -> dict:
    """The JSON line's dict: frames/s of ``steps`` steps of one env on
    ``map_name`` at width x height on ``dev``, after a warm-up."""
    import dtown_torch

    env = dtown_torch.make(map_name, camera_width=width,
                           camera_height=height, device=dev)
    # warm up outside the timed loop (the reference's GL pipeline has
    # the same structure: the first frame compiles shaders)
    obs = env.reset()
    env.step([0.1, 0.0])
    env.reset()

    t0 = time.perf_counter()
    n = 0
    for _ in range(steps):
        obs, r, done, info = env.step([0.3, 0.1])
        n += 1
        if done:
            env.reset()
    dt = time.perf_counter() - t0
    return {
        "metric": "single_env_fps",
        "value": n / dt,
        "unit": "frames/s",
        "map": map_name,
        "resolution": f"{width}x{height}",
        "obs_dtype": str(np.asarray(obs).dtype),
        "device": dev.type,
    }


def main(argv=None):
    from dtown_torch.device import resolve_device

    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    out = measure(args.map, args.steps, args.width, args.height, dev)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
