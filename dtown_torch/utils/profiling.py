"""Tracing and phase timing.

Counterpart of dtown/utils/profiling.py: a torch.profiler trace in place
of the JAX trace, and wall-clock phase timers with steps/s; ``timed``
times one call on the card with CUDA events (the measurement tools).

Spans and counters. The program marks its layers with ``span(name)``.
A span records only while a torch profiler is recording (``device_trace``
or any ``torch.profiler.profile``); otherwise ``span`` returns one shared
no-op. A span is a host-only profiler event named ``dtown.<name>`` (so it
sits on the profiler's clock beside the kernels and puts nothing on the
device's timeline) and a row of the store: its name, its parent's index
and its host start and end (ns); with a CUDA ``device`` also a pair of
CUDA events at its edges (reused once read), read only when the store
is. The store holds one profiler session's spans: ``spans()``,
``totals()``. The program also counts events (each kernel's launches)
with ``count(name)``, always: ``counters()``, ``reset_counters()``.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_PREFIX = "dtown."


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
    _store.closed = True
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


class Span(NamedTuple):
    """One recorded span: ``parent`` is the index in ``spans()`` of the
    span it ran inside (-1 at the top); ``device_ms`` is the time between
    its CUDA events, None for a host-only span."""
    name: str
    parent: int
    start_ns: int
    end_ns: int
    device_ms: Optional[float]


class Total(NamedTuple):
    """The spans of one name: how many, their summed host ms and their
    summed device ms (None for host-only spans)."""
    n: int
    host_ms: float
    device_ms: Optional[float]


class _Store:
    """One profiler session's spans, a column each (name, parent index,
    host start and end ns: no object the garbage collector tracks, so a
    long session does not set off its full passes); the (start, end) CUDA
    events of device spans and their device by index, and their ms once
    read; the stack of the open spans' indices; each device's stream,
    looked up once."""

    def __init__(self):
        self.names, self.parents, self.starts, self.ends = [], [], [], []
        self.events = {}
        self.device_ms: Dict[int, float] = {}
        self.open = []
        self.streams = {}
        self.closed = False


# The profiler is one per process, and so is what it records: the store
# of one session. It closes when it is read after its session has ended,
# or when device_trace starts; a session's first span then starts anew.
_store = _Store()
# CUDA events whose times have been read, by device, for later spans
_free_events: Dict[torch.device, list] = {}
_counts: Dict[str, int] = {}

_OFF = contextlib.nullcontext()


def _event(device):
    free = _free_events.get(device)
    return free.pop() if free else torch.cuda.Event(enable_timing=True)


class _On:
    """A span while the profiler records."""
    __slots__ = ("name", "device", "store", "index", "event")

    def __init__(self, name, device):
        self.name = name
        self.device = device if device and device.type == "cuda" else None

    def __enter__(self):
        self.store = store = _store
        self.index = i = len(store.names)
        store.names.append(self.name)
        store.parents.append(store.open[-1] if store.open else -1)
        store.starts.append(0)
        store.ends.append(0)
        store.open.append(i)
        # host-only: record_function would also put a range on the
        # device's timeline, which a trace reader sums as kernel time
        self.event = torch._C._profiler._RecordFunctionFast(
            SPAN_PREFIX + self.name)
        self.event.__enter__()
        dev = self.device
        if dev is not None:
            stream = store.streams.get(dev)
            if stream is None:
                stream = store.streams[dev] = torch.cuda.current_stream(dev)
            ev = store.events[i] = (_event(dev), _event(dev), dev)
            ev[0].record(stream)
        store.starts[i] = time.perf_counter_ns()

    def __exit__(self, *exc):
        store, i = self.store, self.index
        store.ends[i] = time.perf_counter_ns()
        if self.device is not None:
            store.events[i][1].record(store.streams[self.device])
        self.event.__exit__(*exc)
        store.open.pop()
        return False


def span(name: str, device=False):
    """A span of the block named ``name`` while a torch profiler records,
    else the shared no-op. ``device``: the torch.device whose queue the
    span also times with CUDA events (a CUDA device; otherwise the span
    is host-only), on the stream current at the session's first span on
    that device."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    global _store
    if _store.closed:
        _store = _Store()
    return _On(name, device)


def spans():
    """The store's spans in the order they opened. Read them after the
    work is done: this waits for each device span's end event. Read after
    its session has ended, the store closes: the next session's first
    span starts a new one."""
    st = _store
    for i, (start, end, dev) in list(st.events.items()):
        end.synchronize()
        st.device_ms[i] = start.elapsed_time(end)
        del st.events[i]
        _free_events.setdefault(dev, []).extend((start, end))
    if not _autograd_profiler._is_profiler_enabled:
        st.closed = True
    return [Span(*row, st.device_ms.get(i)) for i, row in enumerate(
        zip(st.names, st.parents, st.starts, st.ends))]


def totals():
    """{name: Total} over ``spans()``."""
    acc = {}
    for s in spans():
        n, host, dev = acc.get(s.name, (0, 0.0, None))
        if s.device_ms is not None:
            dev = (dev or 0.0) + s.device_ms
        acc[s.name] = (n + 1, host + (s.end_ns - s.start_ns) / 1e6, dev)
    return {k: Total(*v) for k, v in acc.items()}


def count(name: str, n: int = 1):
    """Adds n to the counter ``name``. Counters count whether or not a
    profiler records (a dict update, a few a step); ``reset_counters``
    sets them to 0."""
    _counts[name] = _counts.get(name, 0) + n


def counters():
    """{name: count} since the last ``reset_counters``."""
    return dict(_counts)


def reset_counters():
    _counts.clear()
