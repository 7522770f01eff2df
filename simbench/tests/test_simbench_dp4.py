"""The four-card cell multimap3_rgb64.ppo_dp4: found by name with its
chips, the IMPALA-CNN's FLOPs counted by hand, and its four per-layer
readers on a synthetic record and store, and None on empty ones."""
import pytest

from dtown_torch.utils import profiling
from simbench import cells
from simbench.counts import impala, policy

CELL = "multimap3_rgb64.ppo_dp4"
METRICS = ("train_mfu.dp4", "idle_share.dp4", "update_ms.dp4",
           "allreduce_ms")


def test_cell_found_with_four_chips():
    bench = cells.load_benchmark()
    cell = cells.find(bench, CELL)
    assert cell.chips == 4 and cell.traffic["world"] == 4
    assert cell.traffic["loop"] == "ppo_dp"
    assert cell.traffic["ppo"]["trunk"] == "impala"
    assert cell.config["maps"] == ["zigzag_dists", "4way", "udem1"]
    assert cell.config["num_envs"] == 8192
    assert [m["name"] for m in cell.end_to_end] == ["train_env_steps_per_s",
                                                    "setup_s"]
    assert [m["name"] for m, _ in cell.per_layer] == list(METRICS)
    for m, reader in cell.per_layer:
        assert m["workloads"] == [CELL] and callable(reader.read)


def test_impala_flops_by_hand():
    # 2 x multiply-adds: stage 1 at 64x64 (3 -> 16), pool to 32x32, four
    # 16 -> 16; stage 2 at 32x32 (16 -> 32), pool to 16x16, four 32 -> 32;
    # stage 3 at 16x16 (32 -> 32), pool to 8x8, four 32 -> 32; Dense
    # 2048 -> 256; the heads 256 -> 3
    by_hand = (2 * 64 * 64 * 9 * 3 * 16 + 4 * 2 * 32 * 32 * 9 * 16 * 16
               + 2 * 32 * 32 * 9 * 16 * 32 + 4 * 2 * 16 * 16 * 9 * 32 * 32
               + 2 * 16 * 16 * 9 * 32 * 32 + 4 * 2 * 8 * 8 * 9 * 32 * 32
               + 2 * 2048 * 256 + 2 * 256 * 3)
    assert by_hand == 61_212_160
    assert impala.impala_forward_flops(64, 64, 3) == by_hand
    f = by_hand
    ppo = {"rollout_len": 128, "epochs": 4}
    assert policy.ppo_iteration_flops(f, ppo, 2048) == \
        f * (128 * 2048 + 2048) + 3 * f * 4 * 128 * 2048


def _span(name, device_ms):
    return profiling.Span(name, -1, 1000, 2000, device_ms)


def test_readers_on_a_synthetic_record(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [
        _span("ppo.allreduce", 0.25), _span("ppo.allreduce", 0.75),
        _span("ppo.optimizer", 9.0)])
    rec = {"kernels": {"ncclDevKernel_AllReduce_Sum_f32": (1.0, 2),
                       "conv": (7.0, 10)},
           "busy_ms": 8.0, "window_ms": 10.0, "flops": 989e9,
           "update_ms": 6.0, "iterations": 2}
    want = {"train_mfu.dp4": 10.0, "idle_share.dp4": 20.0,
            "update_ms.dp4": 6.0, "allreduce_ms": 0.5}
    for name in METRICS:
        got = cells.metric_reader(name).read(rec)
        assert got == pytest.approx(want[name]), name


def test_readers_give_none_on_an_empty_record(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [])
    for name in METRICS:
        assert cells.metric_reader(name).read({}) is None, name
    # the parent program records no ppo.allreduce span
    monkeypatch.setattr(profiling, "spans",
                        lambda: [_span("ppo.optimizer", 1.0)])
    assert cells.metric_reader("allreduce_ms").read({"iterations": 2}) \
        is None


# the cell at a CPU test's size: two gloo ranks of 8 envs, 32x32
SMALL = {"config": {"num_envs": 16, "env": {"camera_width": 32,
                                            "camera_height": 32}},
         "traffic": {"world": 2, "ppo": {"rollout_len": 4, "epochs": 2,
                                         "minibatches": 2}}}


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_run_on_two_cpu_ranks(fault):
    """A whole run through run_cell on two gloo ranks: ``correct`` with
    every check read, and false with each rank stepping on its own
    gradient (the fault planted in both ranks)."""
    import contextlib

    from simbench import faults, run

    cell = cells.find(cells.load_benchmark(), CELL, overrides=SMALL)
    with (faults.plant("ppo_dp", fault) if fault
          else contextlib.nullcontext()):
        out = run.run_cell(cell, 2**31 + 13, 0.3, False, device="cpu")
    assert set(out["checks"]) == set(cell.traffic["limits"])
    assert set(out["metrics"]) == {"train_env_steps_per_s", "setup_s"}
    assert out["correct"] is (fault is None), out["checks"]
    if fault:
        assert out["checks"]["ranks_gap"]["value"] > 0
