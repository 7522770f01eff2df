"""Run one cell of BENCHMARK.json once on the card and print one JSON line.

    python3 -m simbench.run --workload <config>.<traffic> --seed N \
        --seconds S --trace 0|1

Set-up (building the program, compiling its kernels on a checkout's first
run, warming up every shape) is timed from the process's start to the
first timed step (``setup_s``); then the cell's loop runs its window for
S seconds; then, with the peak memory read and the program freed, the
plain reference checks what the window produced. With ``--trace 0`` the
line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics from a profiled part of the window. Each number compared
is printed beside its limit, last on standard error and under the line's
last key, ``checks``. No card, or fewer than the cell asks for: exit 2 and
no line. JAX or the JAX package loaded: exit 3 and no line.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from simbench import cells, guard  # noqa: E402

# every build and kernel cache at a fixed path inside the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": ("build", "simbench", "triton"),
              "TORCH_EXTENSIONS_DIR": ("build", "simbench", "torch_ext")}


class ForbiddenModules(RuntimeError):
    pass


def _no_forbidden(when):
    found = guard.forbidden_modules()
    if found:
        raise ForbiddenModules(f"{when}: modules {found} are loaded; the "
                               f"benchmark runs without JAX or its package")


def _value(v, unit):
    return {"value": float(v), "unit": unit}


def run_cell(cell, seed, seconds, trace, device="cuda", t_start=None):
    """One run of ``cell``; returns the result line's dict. ``device`` is
    "cpu" only in the harness's own tests, at small sizes."""
    import torch

    t_start = T_START if t_start is None else t_start
    gpu = device != "cpu"
    if gpu:
        torch.cuda.reset_peak_memory_stats()
    c = cell.loop.Cell(cell.config, cell.traffic, seed, device)
    setup_s = time.time() - t_start
    e2e, record, attempted = c.window(seconds, trace)
    mem = torch.cuda.max_memory_allocated() if gpu else 0
    _no_forbidden("after the window")
    c.free()
    dev = {"platform": "gpu" if gpu else "cpu",
           "kind": torch.cuda.get_device_name() if gpu else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(mem)}
    metrics, breakdown = {}, None
    if trace:
        record = c.layer_inputs(record)
        for m, reader in cell.per_layer:
            v = reader.read(record)
            if v is not None:
                metrics[m["name"]] = _value(v, m["unit"])
        dev.update(busy_s=record["busy_ms"] / 1e3,
                   window_s=record["window_ms"] / 1e3)
        breakdown = {"device_ops": record["device_ops"],
                     "idle_gaps": record["idle_gaps"]}
    else:
        e2e = dict(e2e, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = _value(e2e[m["name"]], m["unit"])
    t_check = time.time()
    got = c.check()
    check_s = time.time() - t_check
    limits = cell.traffic["limits"]
    checks = {k: {"value": float(got.get(k, float("inf"))),
                  "limit": float(lim)} for k, lim in limits.items()}
    correct = all(ch["value"] <= ch["limit"] for ch in checks.values())
    _no_forbidden("at the end")
    out = {"correct": correct, "attempted": int(attempted), "failed": 0,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check_s"] = check_s
    out["checks"] = checks
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, parts in CACHE_DIRS.items():
        os.environ[var] = os.path.join(cells.ROOT, *parts)
    import torch

    cell = cells.find(cells.load_benchmark(), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"simbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 2
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    except ForbiddenModules as e:
        print(f"simbench: {e}", file=sys.stderr)
        return 3
    for k, ch in out["checks"].items():
        print(f"check {k} {ch['value']!r} limit {ch['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
