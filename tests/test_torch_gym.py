"""dtown_torch's gym surfaces on the CPU: ``make`` and the gym-style env
(gym_compat), the gymnasium adapter (gymnasium_compat), the wrappers and
the vectorized frame stack, as tests/test_gymnasium.py,
tests/test_framestack.py and tests/test_config_surface.py, and the
verify recipe's flows: a P-controller survives 500 of 500 steps on
small_loop, the vectorized API crashes some envs with finite rewards, an
RGB frame is a real image, a NaN action is sanitised and a huge one
clipped, an unknown map raises FileNotFoundError, a step before reset
AssertionError."""
import numpy as np
import pytest
import torch

import dtown_torch
from dtown_torch import EnvConfig, load_map, wrappers
from dtown_torch.gym_compat import DuckietownNav, MultiMapEnv


def _make(name="small_loop", **kw):
    return dtown_torch.make(name, device="cpu", **kw)


def test_registered_ids_and_make_forms():
    ids = dtown_torch.registered_ids()
    assert "Duckietown-udem1-v0" in ids and ids[-1] == "MultiMap-v0"
    assert _make("Duckietown-udem1-v0", obs_type="state").map_name == "udem1"
    assert isinstance(_make("MultiMap-v0", map_names=["small_loop"],
                            obs_type="state"), MultiMapEnv)


def test_p_controller_survives_a_lap():
    env = _make(obs_type="state")
    obs = env.reset()
    ret = 0.0
    for t in range(500):
        steer = 10.0 * obs[5] + 5.0 * obs[7]
        obs, r, done, _ = env.step([0.55, steer])
        ret += r
        assert not done, f"crashed at step {t}"
    assert np.isfinite(ret)


def test_vectorized_api_crashes_some_envs():
    _, _, v_reset, v_step = dtown_torch.make_vec(
        "loop_obstacles", 64, device="cpu", obs_type="state")
    st = v_reset(torch.Generator().manual_seed(0))
    act = torch.tensor([[0.8, 0.3]]).repeat(64, 1)
    dones = 0
    for _ in range(30):
        st, out = v_step(st, act)
        dones += int(out.done.sum())
        assert torch.isfinite(out.reward).all()
    assert dones > 0


def test_rgb_frame_is_an_image_and_probes():
    env = _make("loop_obstacles", camera_width=32, camera_height=32)
    obs = env.reset()
    assert obs.shape == (32, 32, 3) and obs.dtype == np.uint8
    assert obs.std() > 5
    obs, r, d, info = env.step([np.nan, np.nan])
    assert np.isfinite(r) and np.isfinite(info["Simulator"]["cur_pos"]).all()
    before = env.state.pos.clone()
    obs, r, d, info = env.step([1e9, -1e9])
    assert np.isfinite(r)
    # clipped: one step moves the agent at most the top wheel speed's
    # reach in 1/30 s
    assert float((env.state.pos - before).norm()) < 0.1
    with pytest.raises(FileNotFoundError):
        _make("no_such_map")
    with pytest.raises(AssertionError):
        _make(obs_type="state").step([0.5, 0.0])


def test_gym_default_is_640x480():
    assert _make().observation_shape == (480, 640, 3)
    assert _make(camera_width=64, camera_height=64).observation_shape == \
        (64, 64, 3)


def test_full_transparency_info():
    env = _make(obs_type="state", full_transparency=True)
    env.seed(0)
    env.reset()
    _, _, _, info = env.step(np.array([0.3, 0.0]))
    sim = info["Simulator"]
    assert "domain_rand_params" in sim and "in_lane" in sim
    assert sim["map_name"] == "small_loop"


def test_randomize_maps_on_reset():
    env = _make(obs_type="state", randomize_maps_on_reset=True, seed=1)
    seen = set()
    for _ in range(6):
        env.reset()
        seen.add(env.map_name)
    assert len(seen) > 1


def test_start_overrides_on_the_gym_env():
    env = _make(obs_type="state", start_pose=(0.8, 0.3, 1.25))
    obs = env.reset()
    np.testing.assert_allclose(obs[:2], [0.8, 0.3], atol=1e-6)
    env = _make(obs_type="state", user_tile_start=(1, 0))
    env.reset()
    ts = float(env.maps.numpy().tile_size)
    pos = env.state.pos[0].numpy()
    assert (int(pos[0] // ts), int(pos[2] // ts)) == (1, 0)


def test_draw_overlays():
    base = dict(camera_width=64, camera_height=64)
    for name, flag, kw in (("small_loop", "draw_curve", {}),
                           ("loop_obstacles", "draw_bbox",
                            {"start_pose": (1.0, 0.38, 0.0)})):
        e0 = _make(name, **base, **kw)
        e1 = _make(name, **base, **kw, **{flag: True})
        e0.reset()
        e1.reset()
        e1.state = e0.state
        img0 = e0.render().astype(int)
        img1 = e1.render().astype(int)
        changed = np.abs(img1 - img0).sum(-1) > 30
        assert changed.any()
        reds = img1[changed]
        assert (reds[:, 0] > reds[:, 1]).mean() > 0.9


def test_render_modes(capsys):
    env = _make(camera_width=32, camera_height=32)
    env.reset()
    assert env.render("rgb_array").shape == (32, 32, 3)
    env.render("human")
    assert "\x1b[38;2;" in capsys.readouterr().out
    assert env.render("top_down").shape == (32, 32, 3)


def test_nav_env_goal_bonus():
    env = DuckietownNav(map_name="small_loop", obs_type="state",
                        device="cpu")
    env.seed(3)
    env.reset()
    ts = float(env.maps.numpy().tile_size)
    i, j = env._goal
    env.state = env.state.replace(pos=torch.tensor(
        [[(i + 0.5) * ts, 0.0, (j + 0.5) * ts]]))
    _, r, done, info = env.step([0.0, 0.0])
    assert info["goal_tile"] == (i, j)
    if info["Simulator"]["msg"] == "goal-reached":
        assert done and r > DuckietownNav.GOAL_REWARD - 100


def test_wrappers():
    env = _make(camera_width=64, camera_height=64)
    d = wrappers.DiscreteWrapper(env)
    assert d.reset().shape == (64, 64, 3)
    assert d.step(2)[0].shape == (64, 64, 3) and d.action_count == 3
    np.testing.assert_array_equal(
        wrappers.discrete_to_continuous(torch.tensor([0, 2])).numpy(),
        wrappers.DISCRETE_ACTIONS[[0, 2]])
    r = wrappers.ResizeWrapper(env, (32, 24))
    assert r.reset().shape == (32, 24, 3) and r.reset().dtype == np.uint8
    n = wrappers.NormalizeWrapper(env)
    o = n.reset()
    assert o.dtype == np.float32 and 0.0 <= o.min() and o.max() <= 1.0
    w = wrappers.SteeringToWheelVelWrapper(
        _make(obs_type="state", start_pose=(0.8, 0.3, 0.0)))
    assert not w.cfg.use_wheel_model
    w.reset()
    obs, _, _, _ = w.step([0.3, 0.3])
    assert abs(obs[3]) < 1e-6    # equal wheels: straight ahead


def test_resize_matches_jax_image_resize():
    """ResizeWrapper against the reference's jax.image.resize (bilinear,
    antialiased when shrinking) within one count."""
    import jax
    import jax.numpy as jnp

    img = np.random.default_rng(0).integers(0, 256, (48, 64, 3), np.uint8)
    ref = np.asarray(jnp.clip(jax.image.resize(
        jnp.asarray(img, jnp.float32), (24, 32, 3), method="bilinear"),
        0, 255).astype(jnp.uint8)).astype(int)
    ours = wrappers.ResizeWrapper(None, (24, 32))._resize(img).astype(int)
    assert np.abs(ours - ref).max() <= 1


def test_frame_stack_shapes_and_reset_fill():
    cfg = EnvConfig(camera_width=32, camera_height=32)
    fs_reset, fs_step = wrappers.make_frame_stack_vec(
        cfg, load_map("small_loop"), 8, k=4, device="cpu")
    carry, obs = fs_reset(torch.Generator().manual_seed(0))
    assert obs.shape == (8, 32, 32, 12)
    assert (obs[..., :3] == obs[..., 9:12]).all()
    for _ in range(3):
        carry, out = fs_step(carry, torch.tensor([[0.5, 0.0]]).repeat(8, 1))
    assert not (out.obs[..., :3] == out.obs[..., 9:12]).all()


def test_frame_stack_resets_on_done():
    fs_reset, fs_step = wrappers.make_frame_stack_vec(
        EnvConfig(obs_type="state"), load_map("small_loop"), 16, k=3,
        device="cpu")
    carry, _ = fs_reset(torch.Generator().manual_seed(1))
    act = torch.tensor([[1.0, -1.0]]).repeat(16, 1)
    saw = False
    for _ in range(80):
        carry, out = fs_step(carry, act)
        if out.done.any():
            saw = True
            o = out.obs[out.done]
            assert (o[:, :11] == o[:, 11:22]).all()
            assert (o[:, :11] == o[:, 22:]).all()
    assert saw


def test_frame_stack_host_wrapper():
    env = wrappers.FrameStackWrapper(_make(camera_width=32,
                                           camera_height=32), k=2)
    assert env.reset().shape == (32, 32, 6)
    assert env.step([0.5, 0.0])[0].shape == (32, 32, 6)


def test_gymnasium_make_and_step():
    gymnasium = pytest.importorskip("gymnasium")
    import dtown_torch.gymnasium_compat as gc

    ids = gc.register_gymnasium()
    assert "dtown_torch/Duckietown-small_loop-v0" in ids
    env = gymnasium.make("dtown_torch/Duckietown-small_loop-v0",
                         obs_type="state", device="cpu")
    obs, info = env.reset(seed=3)
    assert env.observation_space.contains(np.asarray(obs))
    for _ in range(10):
        obs, r, term, trunc, info = env.step(np.array([0.5, 0.0],
                                                      np.float32))
        assert np.isfinite(r) and isinstance(term, bool)
        if term or trunc:
            obs, info = env.reset()
    assert "Simulator" in info


def test_gymnasium_terminated_vs_truncated():
    pytest.importorskip("gymnasium")
    import dtown_torch.gymnasium_compat as gc

    env = gc.DuckietownGymnasiumEnv(map_name="straight_road",
                                    obs_type="state", max_steps=6,
                                    device="cpu")
    env.reset(seed=0)
    results = [env.step([0.3, 0.0])[2:4] for _ in range(6)]
    assert results[-1] == (False, True)
    assert all(t == (False, False) for t in results[:-1])
    env = gc.DuckietownGymnasiumEnv(map_name="small_loop", obs_type="state",
                                    device="cpu")
    env.reset(seed=0)
    for _ in range(200):
        _, r, term, trunc, _ = env.step([1.0, -1.0])
        if term or trunc:
            break
    assert term and not trunc and r <= -999.0
    with pytest.raises(ValueError):
        gc.DuckietownGymnasiumEnv(map_name="small_loop", obs_type="state",
                                  auto_reset=True, device="cpu")


def test_gymnasium_vector_env():
    gymnasium = pytest.importorskip("gymnasium")
    from dtown_torch.gymnasium_compat import DuckietownVectorEnv

    envs = DuckietownVectorEnv("small_loop", num_envs=16, obs_type="state",
                               device="cpu")
    assert envs.metadata["autoreset_mode"] == \
        gymnasium.vector.AutoresetMode.SAME_STEP
    obs, _ = envs.reset(seed=0)
    assert envs.observation_space.contains(np.asarray(obs))
    acts = np.tile(np.array([0.8, -0.5], np.float32), (16, 1))
    saw_done = False
    for _ in range(60):
        obs, rew, term, trunc, _ = envs.step(acts)
        assert obs.shape == (16, 11) and rew.shape == (16,)
        if term.any():
            saw_done = True
            assert (rew[term] <= -999.0).all()
    assert saw_done
