"""Readings that set a cell's limits, in one process on the card: for
each of ``--seeds`` a set-up and a short window of the program, then the
numbers its check compares; for each of ``--control-seeds`` the same with
the control (the reference in the next precision below) in the program's
place; with ``--fault`` the program runs with that fault planted
(faults.py). One JSON line a seed. The benchmark's own runs never run this.

    python3 -m simbench.calibrate --workload W --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 3
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

from simbench import cells, faults
from simbench.run import CACHE_DIRS


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault", default="",
                   help="plant this fault (faults.py) under the program")
    args = p.parse_args(argv)
    for var, parts in CACHE_DIRS.items():
        os.environ[var] = os.path.join(cells.ROOT, *parts)
    import torch

    if not torch.cuda.is_available():
        print("simbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = cells.find(cells.load_benchmark(), args.workload)
    runs = [(int(s), False) for s in args.seeds.split(",") if s] + [
        (int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        with (faults.plant(cell.traffic["loop"], args.fault)
              if args.fault else contextlib.nullcontext()):
            c = cell.loop.Cell(cell.config, cell.traffic, seed, "cuda")
            e2e, _, attempted = c.window(args.seconds, False)
        c.free()
        t = time.time()
        got = c.check(control=control)
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              control=control, fault=args.fault,
                              readings=got,
                              check_s=time.time() - t, chunks=attempted,
                              **e2e)), flush=True)
        del c
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
