"""dtown_torch's batched env step (the vectorized API's physics) vs the
JAX package's vmapped ``step_physics``, ``_bank_spawn``,
``init_dyn_state`` and ``render_obs``, on states carried across from the
JAX package. Random draws differ between the two (torch.Generator vs
jax.random), so the draws are made once on the JAX side and fed to both."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dtown import env as jenv
from dtown import map_loader as jmap_loader
from dtown import objects as jobjects
from dtown import types as jtypes

from dtown_torch import EnvConfig, load_map
from dtown_torch import env as tenv
from dtown_torch import objects as tobjects
from dtown_torch.convert import env_states_from_numpy

# tests/test_fused.py bars of the fused kernel vs the XLA step
POSE_ATOL, REWARD_ATOL, LANE_ATOL, NPC_ATOL = 1e-5, 1e-4, 1e-5, 2e-5
# the speed is |delta pos| / dt: the pose bar times 1/dt = 30. Near-
# straight arcs turn about a far-away centre, which magnifies the last-bit
# differences of the two backends (XLA's CPU backend contracts
# multiply-adds into FMAs) in the displacement
SPEED_ATOL = POSE_ATOL * 30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several test processes side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reset_j(jcfg, jmaps, B, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    return jax.jit(jax.vmap(lambda k: jenv.reset(jcfg, jmaps, k)))(keys)


def _step_j(jcfg, jmaps):
    return jax.jit(jax.vmap(
        lambda s, a: jenv.step_physics(jcfg, jmaps, s, a)[:2]))


def _actions(rng, B):
    return np.stack([rng.uniform(0.2, 1.0, B), rng.uniform(-1.0, 1.0, B)],
                    -1).astype(np.float32)


def _close(t, j, atol, msg, rows=slice(None)):
    np.testing.assert_allclose(t.numpy()[rows], np.asarray(j)[rows],
                               rtol=0, atol=atol, err_msg=msg)


def _equal(t, j, msg, rows=slice(None)):
    np.testing.assert_array_equal(t.numpy()[rows], np.asarray(j)[rows],
                                  err_msg=msg)


def _check_step(st, ot, sj, oj, rows=slice(None)):
    _equal(ot.done, oj.done, "done", rows)
    _equal(ot.collision, oj.collision, "collision", rows)
    _equal(ot.in_lane, oj.in_lane, "in_lane", rows)
    _equal(st.step_count, sj.step_count, "step_count", rows)
    _close(st.pos, sj.pos, POSE_ATOL, "pos", rows)
    _close(st.angle, sj.angle, POSE_ATOL, "angle", rows)
    _close(st.speed, sj.speed, SPEED_ATOL, "speed", rows)
    _close(ot.reward, oj.reward, REWARD_ATOL, "reward", rows)
    _close(ot.lane_dist, oj.lane_dist, LANE_ATOL, "lane_dist", rows)
    _close(ot.lane_dot_dir, oj.lane_dot_dir, LANE_ATOL, "dot_dir", rows)
    _close(ot.timestamp, oj.timestamp, 1e-6, "timestamp", rows)
    _close(st.dyn.pos, sj.dyn.pos, NPC_ATOL, "npc pos", rows)
    _close(st.dyn.angle, sj.dyn.angle, NPC_ATOL, "npc angle", rows)
    _equal(st.dyn.phase, sj.dyn.phase, "light phase", rows)


@pytest.mark.parametrize("map_name", ["loop_obstacles", "loop_pedestrians",
                                      "town_dyn_duckiebots", "udem1"])
def test_step_physics_matches_reference(map_name):
    """8 steps of 8 envs with auto_reset off: walking duckies, scripted
    duckiebots and a traffic light advance with the agents."""
    B = 8
    jcfg = jtypes.EnvConfig(obs_type="state", auto_reset=False)
    cfg = EnvConfig(obs_type="state", auto_reset=False)
    jmaps = jmap_loader.load_map(map_name)
    maps = load_map(map_name).to("cpu")
    sj = _reset_j(jcfg, jmaps, B, 11)
    st = env_states_from_numpy(sj, device="cpu")
    step_j = _step_j(jcfg, jmaps)
    rng = np.random.default_rng(5)
    for _ in range(8):
        act = _actions(rng, B)
        sj, oj = step_j(sj, jnp.asarray(act))
        st, ot, _ = tenv.step_physics(cfg, maps, st, torch.from_numpy(act))
        _check_step(st, ot, sj, oj)
    if map_name != "loop_obstacles":
        moved = np.abs(np.asarray(sj.dyn.pos) - np.asarray(jmaps.obj_pos))
        assert map_name == "udem1" or moved.max() > 1e-3  # NPCs walked


def test_bank_spawn_and_dyn_init_match_reference():
    """Given the same draws: _bank_spawn picks the same pose (first clear
    candidate, or the least-blocked one when all are blocked), and
    init_dyn_state draws the same duckie speeds."""
    B = 16
    jcfg, cfg = jtypes.EnvConfig(), EnvConfig()
    jmaps = jmap_loader.load_map("loop_pedestrians")
    maps = load_map("loop_pedestrians").to("cpu")
    M = jmaps.max_objects
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    n_ok = tenv.bank_accept_count(cfg, maps)
    idxs = np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, (tenv.NTRY,), 0, n_ok))(keys))
    # block the first b % 9 candidates of env b with objects sat on them
    # (b % 9 == 8: every candidate blocked)
    sp = np.asarray(jmaps.spawn_pos)
    dyn_pos = np.repeat(np.asarray(jmaps.obj_pos)[None], B, 0)
    active = np.ones((B, M), bool)
    for b in range(B):
        for i in range(min(b % 9, M)):
            dyn_pos[b, i] = sp[idxs[b, i]]
    pos_j, ang_j = jax.vmap(lambda p, a, k: jenv._bank_spawn(
        jcfg, jmaps, p, a, k))(jnp.asarray(dyn_pos), jnp.asarray(active),
                               keys)
    pos_t, ang_t = tenv._bank_spawn(cfg, maps, torch.from_numpy(dyn_pos),
                                    torch.from_numpy(active),
                                    torch.tensor(idxs))
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
    np.testing.assert_array_equal(ang_t.numpy(), np.asarray(ang_j))
    assert len({tuple(p) for p in pos_t.numpy()}) > 4

    noise = np.asarray(jax.vmap(
        lambda k: jax.random.normal(k, (M,), jnp.float32))(keys))
    dj = jax.vmap(lambda k: jobjects.init_dyn_state(jmaps, key=k))(keys)
    dt = tobjects.init_dyn_state(maps, B, torch.tensor(noise))
    for f in ("pos", "angle", "vel", "walk_dist", "wiggle", "phase", "time"):
        np.testing.assert_array_equal(getattr(dt, f).numpy(),
                                      np.asarray(getattr(dj, f)), err_msg=f)


def test_auto_reset_at_max_steps():
    """max_steps=3: every env is done at step 3 and comes back fresh (a
    pose of the accepted bank prefix, fresh NPC state, step 0); envs that
    did not reset before match the JAX package step for step."""
    B = 8
    jcfg = jtypes.EnvConfig(obs_type="state", max_steps=3)
    cfg = EnvConfig(obs_type="state", max_steps=3)
    jmaps = jmap_loader.load_map("loop_pedestrians")
    maps = load_map("loop_pedestrians").to("cpu")
    sj = _reset_j(jcfg, jmaps, B, 3)
    st = env_states_from_numpy(sj, device="cpu")
    step_j = _step_j(jcfg, jmaps)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(2)
    kept = np.ones(B, bool)     # not reset by a crash so far
    for i in range(3):
        act = _actions(rng, B) * np.float32(0.3)
        sj, oj = step_j(sj, jnp.asarray(act))
        st, ot, _ = tenv.step_physics(cfg, maps, st, torch.from_numpy(act),
                                      generator=gen)
        # outputs are computed before the reset: equal for every env kept
        _equal(ot.done, oj.done, "done", kept)
        _close(ot.reward, oj.reward, REWARD_ATOL, "reward", kept)
        if i < 2:
            kept &= ~np.asarray(oj.done)
            _check_step(st, ot, sj, oj, kept)
    assert kept.any()
    assert ot.done.all() and (st.step_count == 0).all()
    n_ok = tenv.bank_accept_count(cfg, maps)
    bank = np.concatenate([np.asarray(maps.spawn_pos[:n_ok]),
                           np.asarray(maps.spawn_angle[:n_ok])[:, None]], -1)
    got = np.concatenate([st.pos.numpy(), st.angle.numpy()[:, None]], -1)
    assert (got[:, None, :] == bank[None]).all(-1).any(-1).all()
    assert (st.dyn.time == 0).all() and (st.dyn.walk_dist == 0).all()
    np.testing.assert_array_equal(
        st.dyn.pos.numpy(), np.repeat(np.asarray(jmaps.obj_pos)[None], B, 0))
    assert (st.speed == 0).all() and (st.wheel_vels == 0).all()


def test_state_obs_matches_reference():
    """The 11-column state observation after 4 steps."""
    B = 8
    jcfg = jtypes.EnvConfig(obs_type="state", auto_reset=False)
    cfg = EnvConfig(obs_type="state", auto_reset=False)
    jmaps = jmap_loader.load_map("udem1")
    maps = load_map("udem1").to("cpu")
    sj = _reset_j(jcfg, jmaps, B, 9)
    st = env_states_from_numpy(sj, device="cpu")
    step_j = _step_j(jcfg, jmaps)
    rng = np.random.default_rng(4)
    for _ in range(4):
        act = _actions(rng, B) * np.float32(0.5)
        sj, _ = step_j(sj, jnp.asarray(act))
        st, _, _ = tenv.step_physics(cfg, maps, st, torch.from_numpy(act))
    ref = jax.jit(jax.vmap(lambda s: jenv.render_obs(jcfg, jmaps, s)))(sj)
    ours = tenv.render_obs_batch(cfg, maps, st)
    assert ours.shape == (B, 11) and ours.dtype == torch.float32
    ours, ref = ours.numpy(), np.asarray(ref)
    cols = [c for c in range(11) if c != 4]
    np.testing.assert_allclose(ours[:, cols], ref[:, cols], rtol=0,
                               atol=1e-5)
    # column 4 is the speed
    np.testing.assert_allclose(ours[:, 4], ref[:, 4], rtol=0,
                               atol=SPEED_ATOL)
    assert np.asarray(ref)[:, 8].any()  # some envs are in a lane
