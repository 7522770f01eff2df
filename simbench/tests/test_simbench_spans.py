"""The readers of the program's own spans (step_issue_us, policy_ms,
forward_ms, backward_ms, optimizer_ms) on a synthetic store and on none,
and the trace's kernel time and idle gaps beside the program's spans:
spans are host events, so no reader of the device's timeline counts
them, and a gap inside one is named by it."""
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dtown_torch.utils import profiling
from simbench import cells, trace

SPAN_METRICS = ("step_issue_us", "policy_ms", "forward_ms", "backward_ms",
                "optimizer_ms")


def _span(name, us, device_ms=None):
    return profiling.Span(name, -1, 1000, 1000 + int(us * 1e3), device_ms)


def _store(monkeypatch, rows):
    monkeypatch.setattr(profiling, "spans", lambda: list(rows))


def test_span_metrics_are_declared():
    bench = cells.load_benchmark()
    got = {m["name"]: m for m in bench["per_layer"]}
    for name in SPAN_METRICS:
        assert got[name]["source"] == "program_span"
        assert cells.metric_reader(name).read is not None
    assert got["step_issue_us"]["workloads"] == [
        "loop_obstacles_rgb64.rollout", "udem1_dr_rgb96.rollout"]
    for name in SPAN_METRICS[1:]:
        assert got[name]["workloads"] == ["loop_obstacles_rgb64.ppo"]


def test_readers_on_a_synthetic_store(monkeypatch):
    rows = [_span("fused_step", us) for us in (30.0, 10.0, 20.0, 90.0)]
    rows += [_span("state_step", 5.0)]
    for name, ms in (("ppo.policy", 3.0), ("ppo.policy", 5.0),
                     ("ppo.forward", 2.0), ("ppo.backward", 4.0),
                     ("ppo.optimizer", 1.0), ("ppo.optimizer", 1.5)):
        rows.append(_span(name, 100.0, device_ms=ms))
    _store(monkeypatch, rows)
    rec = {"iterations": 2}
    want = {"step_issue_us": 25.0, "policy_ms": 4.0, "forward_ms": 1.0,
            "backward_ms": 2.0, "optimizer_ms": 1.25}
    for name in SPAN_METRICS:
        assert cells.metric_reader(name).read(rec) == pytest.approx(
            want[name]), name


def test_readers_give_none_without_spans(monkeypatch):
    # an empty store; spans without device time (the CPU); a record
    # without iterations; a program without the store (the parent)
    _store(monkeypatch, [])
    for name in SPAN_METRICS:
        assert cells.metric_reader(name).read({"iterations": 2}) is None
    _store(monkeypatch, [_span("ppo.policy", 1.0)])
    assert cells.metric_reader("policy_ms").read({"iterations": 2}) is None
    _store(monkeypatch, [_span("ppo.policy", 1.0, device_ms=2.0)])
    assert cells.metric_reader("policy_ms").read({}) is None
    monkeypatch.delattr(profiling, "spans")
    for name in SPAN_METRICS:
        assert cells.metric_reader(name).read({"iterations": 2}) is None


def test_step_issue_us_reads_a_traced_store():
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with profiling.span("fused_step"):
                torch.ones(8).sum()
    got = cells.metric_reader("step_issue_us").read({})
    us = sorted((s.end_ns - s.start_ns) / 1e3 for s in profiling.spans())
    assert got == pytest.approx(us[1]) and got > 0


def _fake_kernel(start_us, end_us):
    return types.SimpleNamespace(
        name="k", device_type=torch.autograd.DeviceType.CUDA,
        time_range=types.SimpleNamespace(start=start_us, end=end_us))


def test_idle_gaps_and_kernel_time_skip_the_programs_spans():
    """A CPU-profiled run with the harness's window span and the
    program's spans, and kernels placed by hand: the spans are host
    events, so they add no device activity, and the gap that opens inside
    ``dtown.gap`` takes its name."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.SPAN_PREFIX + "window"):
            with profiling.span("outer"):
                torch.ones(4).sum()
                with profiling.span("gap"):
                    torch.ones(4).sum()
    events = list(prof.events())
    ours = {e.name: e for e in events
            if e.name.startswith(profiling.SPAN_PREFIX)}
    assert set(ours) == {"dtown.outer", "dtown.gap"}
    for e in ours.values():
        assert e.device_type != torch.autograd.DeviceType.CUDA
    # profile's sum of kernel time skips every host-typed key
    for ev in prof.key_averages():
        if ev.key.startswith(profiling.SPAN_PREFIX):
            assert ev.device_type != torch.autograd.DeviceType.CUDA
    win = next(e for e in events
               if e.name == trace.SPAN_PREFIX + "window").time_range
    gap = ours["dtown.gap"].time_range
    # device busy from the window's start to just inside dtown.gap, and
    # again from dtown.gap's end to the window's end
    at = gap.start + 0.25 * (gap.end - gap.start)
    kernels = [_fake_kernel(win.start, at), _fake_kernel(gap.end, win.end)]
    got = trace._idle_gaps(events + kernels, top=5)
    assert len(got) == 1
    assert got[0][1] == pytest.approx((gap.end - at) / 1e6)
    # named by dtown.gap or by an op that ran inside it
    named = [e for e in events if e.name == got[0][0]
             and e.time_range.start <= at <= e.time_range.end]
    assert named and all(gap.start <= e.time_range.start
                         and e.time_range.end <= gap.end for e in named)


@pytest.mark.card
def test_spans_on_the_card(card):
    """The fused rollout under trace.profile on the card: no kernel key is
    a span, the device spans read their CUDA events, and the launch
    counters count each kernel once a step."""
    import dtown_torch

    cfg = dtown_torch.EnvConfig(camera_width=32, camera_height=32)
    maps = dtown_torch.load_map("loop_obstacles")
    init_blob, fused_step, _ = dtown_torch.make_fused_rollout(
        cfg, maps, 64, device=card)
    blob = init_blob(torch.Generator(device=card).manual_seed(1))
    act = torch.zeros((64, 2), device=card)
    fused_step(blob, act)
    profiling.reset_counters()

    def window():
        b = blob
        for _ in range(4):
            b, _, _ = fused_step(b, act)
        with profiling.span("ppo.policy", torch.device(card)):
            torch.ones(1 << 20, device=card).sum()

    rec = trace.profile(window)
    assert not any(k.startswith(profiling.SPAN_PREFIX)
                   for k in rec["kernels"])
    assert not any(k.startswith(profiling.SPAN_PREFIX)
                   for k, _ in rec["device_ops"])
    tot = profiling.totals()
    assert tot["fused_step"].n == 4 and tot["fused_step"].device_ms is None
    assert tot["ppo.policy"].device_ms > 0
    c = profiling.counters()
    assert c["launches.state_step"] == 4 and c["launches.blob_render"] == 4
