"""dtown_torch's step-path Nav task (tasks.py: nav_reset, nav_step,
goal_features, make_nav_vec) as tests/test_tasks.py, and nav_step against
the JAX package's on states and goals carried across (goal bonus, done,
shaping, the goal features) at tests/test_torch_env_step.py's bars."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dtown import map_loader as jmap_loader
from dtown import tasks as jtasks
from dtown import types as jtypes

from dtown_torch import EnvConfig, load_map, stack_maps
from dtown_torch import env as tenv
from dtown_torch import tasks
from dtown_torch.convert import env_states_from_numpy

from test_torch_env_step import REWARD_ATOL, _actions, _check_step


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_nav_goal_on_drivable_tiles():
    maps = load_map("udem1")
    v_reset, _ = tasks.make_nav_vec(EnvConfig(obs_type="state"), maps, 64,
                                    device="cpu")
    ns = v_reset(_gen(0))
    gi, gj = ns.goal[:, 0].numpy(), ns.goal[:, 1].numpy()
    assert np.asarray(maps.drivable)[gj, gi].all()
    assert len({(int(i), int(j)) for i, j in zip(gi, gj)}) > 4


def test_nav_goal_reached_bonus_and_redraw():
    maps = load_map("small_loop")
    v_reset, v_step = tasks.make_nav_vec(EnvConfig(obs_type="state"), maps, 8,
                                         device="cpu")
    ns = v_reset(_gen(1))
    ts = float(maps.tile_size)
    g = ns.goal.to(torch.float32)
    pos = torch.stack([(g[:, 0] + 0.5) * ts, torch.zeros(8),
                       (g[:, 1] + 0.5) * ts], -1)
    ns = ns.replace(env=ns.env.replace(pos=pos))
    ns2, out = v_step(ns, torch.zeros((8, 2)))
    reached = out.reward.numpy() > tasks.GOAL_REWARD - 100.0
    assert reached.sum() >= 6
    assert out.done.numpy()[reached].all()
    moved = (ns2.goal != ns.goal).any(-1).numpy()
    assert moved[reached].sum() >= 1


def test_nav_plain_step_matches_base_env_reward():
    cfg = EnvConfig(obs_type="state")
    maps = load_map("straight_road").to("cpu")
    v_reset, v_step = tasks.make_nav_vec(cfg, maps, 4, device="cpu")
    ns = v_reset(_gen(2))
    ns = ns.replace(goal=torch.full_like(ns.goal, 99))
    act = torch.tensor([[0.3, 0.0]]).repeat(4, 1)
    _, out_nav = v_step(ns, act)
    _, out_base, _ = tenv.step_physics(
        dataclasses.replace(cfg, auto_reset=False), maps, ns.env, act)
    np.testing.assert_array_equal(out_nav.reward.numpy(),
                                  out_base.reward.numpy())


@pytest.mark.parametrize("goal_in_obs", [False, True])
def test_nav_rgb_obs_paths(goal_in_obs):
    """RGB Nav renders through env.render_obs_batch (the row-fed kernels
    with renderer="pallas", the ray-caster by default); goal_in_obs makes
    the pair (frames, goal features)."""
    maps = load_map("small_loop")
    for renderer in ("pallas", "xla"):
        cfg = EnvConfig(camera_width=32, camera_height=32, renderer=renderer)
        v_reset, v_step = tasks.make_nav_vec(cfg, maps, 8,
                                             goal_in_obs=goal_in_obs,
                                             device="cpu")
        ns, out = v_step(v_reset(_gen(0)), torch.zeros((8, 2)))
        img = out.obs[0] if goal_in_obs else out.obs
        assert img.shape == (8, 32, 32, 3) and img.dtype == torch.uint8
        assert float(img.float().std()) > 5
        if goal_in_obs:
            np.testing.assert_allclose(
                out.obs[1].numpy(), tasks.goal_features(v_step.maps,
                                                        ns).numpy())


def test_nav_goal_in_obs():
    maps = load_map("small_loop")
    v_reset, v_step = tasks.make_nav_vec(EnvConfig(obs_type="state"), maps, 8,
                                         goal_in_obs=True, device="cpu")
    ns, out = v_step(v_reset(_gen(0)), torch.zeros((8, 2)))
    assert out.obs.shape == (8, 14)
    ts = float(maps.tile_size)
    g = ns.goal.numpy()
    pos = ns.env.pos.numpy()
    d = np.hypot((g[:, 0] + 0.5) * ts - pos[:, 0],
                 (g[:, 1] + 0.5) * ts - pos[:, 2])
    o = out.obs.numpy()
    np.testing.assert_allclose(o[:, 13], d, rtol=1e-4)
    np.testing.assert_allclose(np.hypot(o[:, 11], o[:, 12]), d, rtol=1e-4)


@pytest.mark.parametrize("names,shaping", [("small_loop", 0.0),
                                           ("straight_road", 10.0),
                                           (["small_loop", "udem1"], 0.0)])
def test_nav_step_matches_reference(names, shaping):
    """4 steps of dtown's vmapped nav_step and the port's from the same
    states and goals (auto-reset off): half the envs' goals on the tile
    they stand on, so the bonus is scored; rewards (with the shaping),
    dones and poses at the standing bars, the goal features within
    1e-5."""
    B = 8
    kw = dict(obs_type="state", auto_reset=False, nav_shaping_coef=shaping)
    jcfg, cfg = jtypes.EnvConfig(**kw), EnvConfig(**kw)
    if isinstance(names, list):
        jmaps, maps = jmap_loader.stack_maps(names), stack_maps(names)
    else:
        jmaps, maps = jmap_loader.load_map(names), load_map(names)
    maps = maps.to("cpu")
    keys = jax.random.split(jax.random.PRNGKey(6), B)
    idx = jnp.arange(B, dtype=jnp.int32) % maps.n_maps
    nj = jax.vmap(lambda k, i: jtasks.nav_reset(jcfg, jmaps, k, i))(keys,
                                                                     idx)
    ts = np.asarray(jmaps.tile_size, np.float32).reshape(-1)[
        np.asarray(idx) % np.asarray(jmaps.tile_size).size]
    pos = np.asarray(nj.env.pos)
    here = np.stack([pos[:, 0] // ts, pos[:, 2] // ts], -1).astype(np.int32)
    goal = np.where((np.arange(B) % 2 == 0)[:, None], here,
                    np.asarray(nj.goal))
    nj = nj._replace(goal=jnp.asarray(goal))
    nt = tasks.NavState(env_states_from_numpy(nj.env, device="cpu"),
                        torch.tensor(goal))
    step_j = jax.jit(jax.vmap(lambda s, a: jtasks.nav_step(jcfg, jmaps, s,
                                                           a)))
    feats_j = jax.vmap(lambda s: jtasks.goal_features(jmaps, s))
    rng = np.random.default_rng(0)
    scored = 0
    for _ in range(4):
        act = _actions(rng, B) * np.float32(0.3)
        nj, oj = step_j(nj, jnp.asarray(act))
        nt, ot = tasks.nav_step(cfg, maps, nt, torch.from_numpy(act))
        _check_step(nt.env, ot, nj.env, oj)
        np.testing.assert_array_equal(nt.goal.numpy(), np.asarray(nj.goal))
        np.testing.assert_allclose(ot.reward.numpy(), np.asarray(oj.reward),
                                   rtol=0, atol=REWARD_ATOL)
        np.testing.assert_allclose(tasks.goal_features(maps, nt).numpy(),
                                   np.asarray(feats_j(nj)), rtol=0,
                                   atol=1e-5)
        scored += int((ot.reward > tasks.GOAL_REWARD - 100).sum())
    assert scored > 0
