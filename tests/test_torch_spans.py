"""dtown_torch.utils.profiling's spans and counters: spans record only
under a torch profiler, nest, stay off the device's timeline (host events
that are no user annotation), keep one profiler session apart from the
next, and mark the fused step and the PPO iteration where the benchmark's
readers look for them; counters count until reset."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dtown_torch import EnvConfig, load_map
from dtown_torch.learn import ppo as P
from dtown_torch.utils import profiling


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def closed_store():
    """Each test starts as a reader leaves the store: read after the
    session that filled it (an earlier test's), so closed."""
    profiling.spans()


def test_spans_nest_with_parent_indices():
    with _cpu_profile():
        with profiling.span("a"):
            with profiling.span("b"):
                with profiling.span("c"):
                    pass
            with profiling.span("d"):
                pass
        with profiling.span("e"):
            pass
    got = profiling.spans()
    assert [(s.name, s.parent) for s in got] == [
        ("a", -1), ("b", 0), ("c", 1), ("d", 0), ("e", -1)]
    for s in got:
        assert 0 < s.start_ns <= s.end_ns and s.device_ms is None
    a, b, c, d, _ = got
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns \
        <= d.start_ns <= d.end_ns <= a.end_ns
    tot = profiling.totals()
    assert set(tot) == set("abcde") and tot["a"].n == 1
    assert tot["a"].host_ms == (a.end_ns - a.start_ns) / 1e6
    assert tot["a"].device_ms is None


def test_off_without_a_profiler_returns_the_shared_no_op():
    with _cpu_profile():
        with profiling.span("kept"):
            pass
    first = profiling.span("x")
    assert first is profiling.span("y", torch.device("cpu"))
    with first as got:
        assert got is None
    assert [s.name for s in profiling.spans()] == ["kept"]


def test_spans_are_host_events_not_user_annotations():
    with _cpu_profile() as prof:
        with profiling.span("outer"):
            with profiling.span("inner", torch.device("cpu")):
                torch.ones(4).sum()
    ours = [e for e in prof.events()
            if e.name.startswith(profiling.SPAN_PREFIX)]
    assert sorted(e.name for e in ours) == ["dtown.inner", "dtown.outer"]
    for e in ours:
        # a user annotation also gets a range on the device's timeline,
        # which a trace reader would count as kernel time
        assert not e.is_user_annotation
        assert e.device_type == torch.autograd.DeviceType.CPU
    inner = next(e for e in ours if e.name == "dtown.inner")
    assert any(e.name == "aten::sum" and inner.time_range.start
               <= e.time_range.start <= inner.time_range.end
               for e in prof.events())


def test_two_sessions_do_not_mix(tmp_path):
    with _cpu_profile():
        with profiling.span("first"):
            pass
    assert [s.name for s in profiling.spans()] == ["first"]
    with _cpu_profile():
        with profiling.span("second"):
            # read during the session: the store stays open
            assert [s.name for s in profiling.spans()] == ["second"]
        with profiling.span("third"):
            pass
    assert [s.name for s in profiling.spans()] == ["second", "third"]
    # unread, a session's spans join the next session's store
    for name in ("fourth", "fifth"):
        with _cpu_profile():
            with profiling.span(name):
                pass
    assert [s.name for s in profiling.spans()] == ["fourth", "fifth"]
    # device_trace starts anew, the last session read or not
    with _cpu_profile():
        with profiling.span("sixth"):
            pass
    for name in ("seventh", "eighth"):
        with profiling.device_trace(str(tmp_path / name)):
            with profiling.span(name):
                pass
    assert [s.name for s in profiling.spans()] == ["eighth"]
    assert (tmp_path / "eighth" / "trace.json").exists()


def test_counters_count_always_until_reset():
    profiling.reset_counters()
    profiling.count("launches.z")
    with _cpu_profile():
        profiling.count("launches.z", 3)
        with profiling.span("s"):
            profiling.count("launches.y")
    profiling.count("launches.z")
    assert profiling.counters() == {"launches.z": 5, "launches.y": 1}
    profiling.reset_counters()
    assert profiling.counters() == {}


def test_a_span_closes_when_its_block_raises():
    with _cpu_profile():
        with pytest.raises(ValueError):
            with profiling.span("outer"):
                with profiling.span("raises"):
                    raise ValueError
        with profiling.span("after"):
            pass
    assert [(s.name, s.parent) for s in profiling.spans()] == [
        ("outer", -1), ("raises", 0), ("after", -1)]


def test_fused_ppo_iteration_spans():
    """One fused PPO iteration on the CPU, traced: the rollout's policy
    forwards (T + 1), each fused step's three parts, GAE, and each
    minibatch's forward, backward and optimizer spans under the update."""
    B = 8
    cfg = EnvConfig(camera_width=32, camera_height=32)
    ppo = P.PPOConfig(rollout_len=3, epochs=2, minibatches=2)
    init, train = P.make_ppo(cfg, load_map("small_loop"), B, ppo,
                             fused=True, device="cpu")
    ts = init(torch.Generator().manual_seed(0))
    with _cpu_profile():
        train(ts)
    got = profiling.spans()
    names = [s.name for s in got]
    tot = profiling.totals()
    assert {k: v.n for k, v in tot.items()} == {
        "ppo.rollout": 1, "ppo.policy": 4, "fused_step": 3,
        "state_step": 3, "render": 3, "outputs": 3, "ppo.gae": 1,
        "ppo.update": 1, "ppo.forward": 4, "ppo.backward": 4,
        "ppo.optimizer": 4}
    parent = {i: names[s.parent] if s.parent >= 0 else None
              for i, s in enumerate(got)}
    for i, n in enumerate(names):
        want = {"ppo.rollout": None, "ppo.gae": None, "ppo.update": None,
                "ppo.policy": "ppo.rollout", "fused_step": "ppo.rollout",
                "state_step": "fused_step", "render": "fused_step",
                "outputs": "fused_step", "ppo.forward": "ppo.update",
                "ppo.backward": "ppo.update",
                "ppo.optimizer": "ppo.update"}[n]
        assert parent[i] == want, (n, parent[i])
    # on the CPU no span has device time
    assert all(s.device_ms is None for s in got)
    assert names.index("ppo.gae") > names.index("ppo.rollout")
    assert names[-3:] == ["ppo.forward", "ppo.backward", "ppo.optimizer"]
