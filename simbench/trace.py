"""The traced window: torch.profiler over a callable on the card.

Device busy time is the sum of the kernels' self device time inside the
window and the window's length is read from CUDA events around it (the
rule of the port's chip_smoke.py ``profile_window``), so the idle share is
1 - busy / window. The trace also gives each kernel's device ms and launch
count, the operations that took most device time, and the longest idle
gaps named by what the host was doing when each began.
"""
from __future__ import annotations

import contextlib

import torch

# the harness's own host spans, recorded only in a traced window
SPAN_PREFIX = "simbench."


def sync(device):
    """Wait for the card's queue (nothing to wait for on the CPU)."""
    if device != "cpu":
        torch.cuda.synchronize()


def span(name, on):
    """A named host span in the trace when ``on``, else nothing."""
    if on:
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return contextlib.nullcontext()


def _device_ms(ev):
    return getattr(ev, "self_device_time_total",
                   getattr(ev, "self_cuda_time_total", 0.0)) / 1e3


def profile(window, top=10):
    """Run window() under torch.profiler. Returns a dict: ``kernels``
    {name: (device ms in all, launches)}, ``busy_ms``, ``window_ms``,
    ``device_ops`` [[name, s], ...] (the top by device time) and
    ``idle_gaps`` [[host activity, s], ...] (the longest gaps between
    kernels), and whatever window() returned under ``result``."""
    from torch.profiler import ProfilerActivity

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(SPAN_PREFIX + "window"):
            start.record()
            result = window()
            end.record()
            torch.cuda.synchronize()
    kernels, busy = {}, 0.0
    for ev in prof.key_averages():
        # the harness's spans also show on the device's timeline
        if ev.device_type != torch.autograd.DeviceType.CUDA or \
                ev.key.startswith(SPAN_PREFIX):
            continue
        t = _device_ms(ev)
        busy += t
        kernels[ev.key] = (t, ev.count)
    ops = sorted(([k, t / 1e3] for k, (t, _) in kernels.items()),
                 key=lambda kv: -kv[1])[:top]
    return dict(kernels=kernels, busy_ms=busy,
                window_ms=start.elapsed_time(end), device_ops=ops,
                idle_gaps=_idle_gaps(prof.events(), top), result=result)


def _idle_gaps(events, top):
    """The longest gaps between device kernels inside the window span, each
    named by the innermost host event running where it begins."""
    cuda, host, win = [], [], None
    for ev in events:
        tr = ev.time_range
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if not ev.name.startswith(SPAN_PREFIX):
                cuda.append((tr.start, tr.end))
        elif ev.name == SPAN_PREFIX + "window" and win is None:
            win = (tr.start, tr.end)
        else:
            host.append((tr.start, tr.end, ev.name))
    if win is None or not cuda:
        return []
    cuda.sort()
    gaps, last = [], win[0]
    for s, e in cuda:
        if s > last:
            gaps.append((s - last, last))
        last = max(last, e)
    if win[1] > last:
        gaps.append((win[1] - last, last))
    out = []
    for dur, at in sorted(gaps, reverse=True)[:top]:
        inner = [h for h in host if h[0] <= at <= h[1]]
        name = max(inner)[2] if inner else "host"
        out.append([name, dur / 1e6])
    return out
