"""Tracing and phase timing.

Counterpart of dtown/utils/profiling.py: a torch.profiler trace in place
of the JAX trace, and wall-clock phase timers with steps/s; ``timed``
times one call on the card with CUDA events (the measurement tools).
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict

import torch


def timed(fn, device):
    """(seconds, fn()) of one call of fn on ``device``: CUDA events around
    the call on the card (after a synchronize, so earlier work is not
    counted), the host clock on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3, out
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def median_timed(fn, device, reps=3):
    """Median seconds of ``reps`` timed calls of fn on ``device``, after
    one warm-up call."""
    fn()
    return sorted(timed(fn, device)[0] for _ in range(reps))[reps // 2]


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the block with torch.profiler (host and, where a card is
    present, CUDA activity) and export a Chrome trace to
    ``logdir/trace.json`` (chrome://tracing or Perfetto reads it)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class PhaseTimer:
    """Wall-clock time per phase, with steps/s accounting.

        timer = PhaseTimer()
        with timer.phase("rollout", steps=envs * T): ...
        print(timer.report())

    A phase synchronizes the CUDA device at its exit when one is in use,
    so that it holds its kernels' time and not only their launch."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.steps: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, steps: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.steps[name] = self.steps.get(name, 0) + steps

    def report(self) -> str:
        rows = {}
        for name, total in self.totals.items():
            row = {"seconds": round(total, 3)}
            if self.steps.get(name):
                row["steps_per_s"] = round(self.steps[name] / total, 1)
            rows[name] = row
        return json.dumps(rows)
