"""dtown_torch.utils.metrics and utils.profiling: MetricSink's running
summary and JSONL log (dtown/utils/metrics.py), all_device_mean without a
process group, PhaseTimer's report (dtown/utils/profiling.py) and
device_trace's Chrome trace on the CPU."""
import json
import os

import numpy as np
import torch

from dtown_torch.utils.metrics import MetricSink, all_device_mean
from dtown_torch.utils.profiling import PhaseTimer, device_trace


def test_metric_sink_summary_and_jsonl(tmp_path):
    path = str(tmp_path / "m.jsonl")
    sink = MetricSink(path)
    for i, r in enumerate([1.0, 2.0, 0.5, 4.0]):
        rec = sink.log(i, {"reward": torch.tensor(r),
                           "loss": np.float32(-r)}, extra={"phase": "a"})
        assert rec["step"] == i and rec["reward"] == r
    sink.close()
    assert sink.summary("reward") == {"last": 4.0, "mean": 1.875,
                                      "min": 0.5, "max": 4.0, "n": 4}
    assert sink.summary("missing") == {}
    with open(path) as f:
        lines = [json.loads(x) for x in f]
    assert [x["reward"] for x in lines] == [1.0, 2.0, 0.5, 4.0]
    assert all(x["phase"] == "a" and "t" in x for x in lines)
    assert sink.improved("reward", head=2, tail=2)  # 2.25 > 1.5
    assert not sink.improved("loss", head=2, tail=2)
    assert not sink.improved("reward", head=3, tail=3)  # too few


def test_all_device_mean_without_group_is_identity():
    m = {"loss": torch.tensor(1.5), "mean_reward": torch.tensor(-2.0)}
    assert all_device_mean(m) is m


def test_phase_timer_report():
    timer = PhaseTimer()
    for _ in range(2):
        with timer.phase("train", steps=100):
            sum(range(1000))
    with timer.phase("init"):
        pass
    rep = json.loads(timer.report())
    assert set(rep) == {"train", "init"}
    assert rep["train"]["steps_per_s"] > 0
    assert "steps_per_s" not in rep["init"]
    assert timer.steps["train"] == 200


def test_device_trace_writes_chrome_trace(tmp_path):
    with device_trace(str(tmp_path / "trace")):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    path = os.path.join(str(tmp_path / "trace"), "trace.json")
    with open(path) as f:
        assert "traceEvents" in json.load(f)
