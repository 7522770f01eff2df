"""The port's measurement tools on the CPU at a tiny size: each runs as
``python -m dtown_torch.<tool> --cpu`` (in this process, through runpy)
and prints the reference tool's keys; bench's metric names are
bench.py's with the prefix ``torch_``; without ``--cpu`` and without a
card, bench exits non-zero with resolve_device's message; lod_probe's
statistics match the JAX package's on the same states within the
ray-caster's bar (mean |diff| <= 0.25, tests/test_torch_raster.py); and
scripts/plot_training.py reads the trainer's log."""
import importlib.util
import json
import os
import re
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--cpu", "--envs", "8", "--size", "32"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_module(name, argv, capsys, monkeypatch):
    """stdout lines of ``python -m dtown_torch.<name> <argv>``, run here."""
    monkeypatch.setattr(sys, "argv", [name] + argv)
    runpy.run_module(f"dtown_torch.{name}", run_name="__main__",
                     alter_sys=True)
    return capsys.readouterr().out.splitlines()


def last_json(lines):
    return json.loads(lines[-1])


TOOLS = {
    "bench": SMALL + ["--iters", "4"],
    "perf_probe": SMALL + ["--iters", "2"],
    "bench_profile": SMALL + ["--map", "loop_obstacles", "--iters", "2"],
    "roofline_objpass": SMALL + ["--iters", "2"],
    "benchmark": ["--cpu", "--steps", "3", "--width", "32", "--height",
                  "32", "--map", "loop_obstacles"],
    "lod_probe": ["--cpu", "--envs", "8", "--sizes", "32", "--maps",
                  "loop_obstacles", "--q", "2.0"],
    "sweep_ppo": ["--cpu", "--envs", "8", "--iters", "2", "--rollout", "4",
                  "--lrs", "1e-3", "--ents", "0.01", "--epochs", "1",
                  "--minibatches", "2"],
}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_runs_as_module(tool, capsys, monkeypatch):
    lines = run_module(tool, TOOLS[tool], capsys, monkeypatch)
    assert lines, tool
    if tool == "bench":
        out = last_json(lines)
        assert set(out) == {"metric", "value", "unit", "vs_baseline"}
        assert out["value"] > 0 and out["unit"] == "env-steps/s/cpu"
    elif tool == "perf_probe":
        got = [re.match(r"(\w+): ([\d.]+) us/iter \(([\d.]+) M steps/s\)$",
                        line) for line in lines]
        assert all(got) and [m.group(1) for m in got] == \
            ["state", "render", "full"], lines
    elif tool == "bench_profile":
        out = last_json(lines)
        assert list(out) == ["dynamics", "lane_pos", "collision",
                             "npc_objects", "reset_full", "render_ground",
                             "render_full", "full_step"]
        assert all(v > 0 for v in out.values())
    elif tool == "roofline_objpass":
        out = last_json(lines)
        assert set(out) == {"metric", "value", "unit", "detail"}
        assert out["metric"] == "objpass_gap_to_instr_sol_udem1"
        assert out["value"] is None           # no device time on the CPU
        d = out["detail"]
        assert d["ops_per_px"] == d["instr_per_px"] > 0
        assert d["bound_ms"] > 0 and d["device"] == "cpu"
        assert {"obj_pass_ms", "full_ms", "ground_ms"} <= set(d)
    elif tool == "benchmark":
        out = last_json(lines)
        assert out["metric"] == "single_env_fps" and out["value"] > 0
        assert out["resolution"] == "32x32" and out["obs_dtype"] == "uint8"
        assert out["device"] == "cpu"
        assert set(out) == {"metric", "value", "unit", "map", "resolution",
                            "obs_dtype", "device"}
    elif tool == "lod_probe":
        assert len(lines) == 1 and re.match(
            r"loop_obstacles +32x32 q=2\.0: mean [\d.]+  frac>10 [\d.]+  "
            r"max +\d+  (PASS|FAIL)$", lines[0]), lines
    else:
        out = last_json(lines)
        assert set(out) == {"lr", "ent_coef", "epochs", "minibatches",
                            "seed", "mean_reward_tail", "done_frac_tail",
                            "mean_reward_first", "seconds"}
        assert np.isfinite(out["mean_reward_tail"])


@pytest.mark.parametrize("extra,metric", [
    ([], "torch_env_steps_per_s_32x32_rgb_8envs_loop_obstacles_fused"),
    (["--obs", "state"],
     "torch_env_steps_per_s_32x32_state_8envs_loop_obstacles_fused"),
    (["--map", "small_loop,loop_empty"],
     "torch_env_steps_per_s_32x32_rgb_8envs_multimap2_fused"),
    (["--distortion", "--grayscale"],
     "torch_env_steps_per_s_32x32_gray_fisheye_8envs_loop_obstacles_fused"),
    (["--no-fused"], "torch_env_steps_per_s_32x32_rgb_8envs_loop_obstacles"),
])
def test_bench_metric_names(extra, metric, capsys):
    from dtown_torch import bench

    out = bench.main(SMALL + ["--iters", "4"] + extra)
    assert out["metric"] == metric
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out
    assert out["vs_baseline"] == out["value"] / bench.REFERENCE_STEPS_PER_S


def test_bench_refuses_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = subprocess.run([sys.executable, "-m", "dtown_torch.bench", "--envs",
                        "8", "--size", "32", "--iters", "2"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert r.stdout == ""


@pytest.mark.parametrize("q", [1.0, 2.0])
def test_lod_probe_matches_reference(q):
    """The port's LOD statistics on dtown's reset states of udem1 (8
    envs, 32x32) against dtown's, each difference within the
    ray-caster's bars (mean 0.25, share 0.005), and the same verdict."""
    import dataclasses

    from dtown import env as jenv
    from dtown import map_loader as jmap_loader
    from dtown import types as jtypes

    from dtown_torch import EnvConfig, load_map
    from dtown_torch.convert import env_states_from_numpy
    from dtown_torch.lod_probe import gate, lod_diff

    kw = dict(obs_type="rgb", camera_width=32, camera_height=32,
              auto_reset=False, obj_lod_px=0.0)
    jcfg = jtypes.EnvConfig(**kw)
    jmaps = jmap_loader.load_map("udem1")
    keys = jax.random.split(jax.random.PRNGKey(0), 8)
    idx = jnp.zeros((8,), jnp.int32)
    st = jax.vmap(lambda k, i: jenv.reset(jcfg, jmaps, k, i))(keys, idx)
    render = jax.vmap(lambda s, c: jenv.render_obs(c, jmaps, s),
                      in_axes=(0, None))
    img0 = np.asarray(render(st, jcfg)).astype(int)
    img = np.asarray(render(st, dataclasses.replace(
        jcfg, obj_lod_px=q))).astype(int)
    d = np.abs(img - img0)
    ref_mean, ref_frac = float(d.mean()), float((d > 10).mean())

    mean, frac, _ = lod_diff(EnvConfig(**kw), load_map("udem1").to("cpu"),
                             env_states_from_numpy(st, device="cpu"), q)
    assert abs(mean - ref_mean) <= 0.25, (mean, ref_mean)
    assert abs(frac - ref_frac) <= 0.005, (frac, ref_frac)
    assert gate(mean, frac) == (ref_mean < 1.0 and ref_frac < 0.01)


def test_plot_training_reads_trainer_log(tmp_path, capsys):
    from dtown_torch import train_ppo

    train_ppo.main(["--cpu", "--obs", "state", "--envs", "8", "--rollout",
                    "4", "--iters", "2", "--epochs", "1", "--minibatches",
                    "2"])
    lines = capsys.readouterr().out.splitlines()
    log = tmp_path / "train.log"
    log.write_text("\n".join(lines) + "\n")
    spec = importlib.util.spec_from_file_location(
        "plot_training", os.path.join(REPO, "scripts", "plot_training.py"))
    plot = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(plot)
    rows = plot.parse_log(str(log))
    assert [it for it, _ in rows] == [0, 1]
    assert all(np.isfinite(d["mean_reward"]) and "done_frac" in d
               for _, d in rows)
