"""dtown_torch's rejection spawning and start overrides vs the JAX
package (tests/test_spawn_modes.py, tests/test_config_surface.py): the
acceptance test of dtown's own ``jax.random`` proposals (equal decisions
on every proposal), the first-accepted pick and its bank fallback from
the same proposals (equal poses), the validity of the port's own
rejection spawns, the bank fallback when every proposal fails, and
``start_pose`` / ``user_tile_start`` in reset and in the state kernel's
spawn bank."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dtown import env as jenv
from dtown import map_loader as jmap_loader
from dtown import types as jtypes
from dtown.ops import state_kernel as jsk

import dtown_torch
from dtown_torch import EnvConfig, load_map
from dtown_torch import env as tenv
from dtown_torch import physics
from dtown_torch.geometry import get_lane_pos2
from dtown_torch.ops import state_kernel as sk


def _objs(jmaps):
    return (jmaps.obj_corners, jmaps.obj_norms, jmaps.obj_mask)


@pytest.mark.parametrize("map_name", ["loop_cones", "udem1",
                                      "bigtown_pedestrians",
                                      "regress_spawn_clearance",
                                      "loop_obstacles"])
def test_spawn_accept_matches_reference(map_name):
    """dtown's _spawn_try on 512 keys: the port's spawn_accept takes the
    same decision on each proposal; the all-fail probability of the
    default budget stays under 1e-3 (test_rejection_fallback_rate).
    dtown's decisions are taken op by op (vmap without jit): jitted, XLA's
    fusion moves one udem1 proposal's lane angle from -60.18 to -59.96
    degrees, across the 60 degree bar (a flip in the lane query's
    bisection), and the port agrees with the op-by-op reference."""
    jcfg = jtypes.EnvConfig(obs_type="state", spawn_mode="rejection")
    cfg = EnvConfig(obs_type="state", spawn_mode="rejection")
    jmaps = jmap_loader.load_map(map_name)
    maps = load_map(map_name).to("cpu")
    keys = jax.random.split(jax.random.PRNGKey(0), 512)
    ok, pos, ang = jax.vmap(
        lambda k: jenv._spawn_try(jcfg, jmaps, _objs(jmaps), k))(keys)
    active = maps.obj_mask.expand(512, -1)
    ours = tenv.spawn_accept(cfg, maps, active,
                             torch.tensor(np.asarray(pos)),
                             torch.tensor(np.asarray(ang)))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ok))
    p = float(ours.float().mean())
    assert 0.0 < p and (1.0 - p) ** cfg.spawn_attempts < 1e-3


@pytest.mark.parametrize("attempts", [16, 0])
def test_sample_spawn_matches_reference(attempts):
    """_sample_spawn's key schedule replayed to get its proposals and its
    fallback bank index: the port picks the same pose from them (with no
    attempt, the bank fallback)."""
    B = 16
    jcfg = jtypes.EnvConfig(obs_type="state", spawn_mode="rejection",
                            spawn_attempts=attempts)
    cfg = EnvConfig(obs_type="state", spawn_mode="rejection",
                    spawn_attempts=attempts)
    jmaps = jmap_loader.load_map("loop_obstacles")
    maps = load_map("loop_obstacles").to("cpu")
    n_ok = tenv.bank_accept_count(cfg, maps)

    def replay(key):
        key, k_fb = jax.random.split(key)
        fb = jax.random.randint(k_fb, (), 0, n_ok)
        pp, aa = [], []
        for _ in range(attempts):
            key, sub = jax.random.split(key)
            _, p, a = jenv._spawn_try(jcfg, jmaps, _objs(jmaps), sub)
            pp.append(p)
            aa.append(a)
        if not attempts:
            return fb, jnp.zeros((0, 3)), jnp.zeros((0,))
        return fb, jnp.stack(pp), jnp.stack(aa)

    keys = jax.random.split(jax.random.PRNGKey(2), B)
    fb, pos, ang = jax.jit(jax.vmap(replay))(keys)
    want_p, want_a = jax.jit(jax.vmap(
        lambda k: jenv._sample_spawn(jcfg, jmaps, _objs(jmaps), k)))(keys)
    got_p, got_a = tenv.sample_spawn(
        cfg, maps, maps.obj_mask.expand(B, -1),
        torch.tensor(np.asarray(pos)).reshape(B, attempts, 3),
        torch.tensor(np.asarray(ang)).reshape(B, attempts),
        torch.tensor(np.asarray(fb)))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    if not attempts:
        assert len({tuple(p) for p in got_p.numpy()}) > 1


@pytest.mark.parametrize("mode", ["bank", "rejection"])
def test_spawn_mode_validity(mode):
    cfg = EnvConfig(obs_type="state", spawn_mode=mode, spawn_attempts=16)
    maps = load_map("loop_obstacles").to("cpu")
    st = tenv.reset(cfg, maps, torch.Generator().manual_seed(4), 16)
    valid, _ = physics.valid_pose(maps, st.pos, st.angle, maps.obj_corners,
                                  maps.obj_norms,
                                  maps.obj_mask.expand(16, -1))
    assert valid.all()
    lp = get_lane_pos2(maps, st.pos, st.angle)
    assert lp.in_lane.all()
    assert (lp.angle_deg.abs() <= cfg.accept_start_angle_deg + 1e-3).all()


def test_spawn_modes_differ_and_fallback_is_a_bank_pose():
    maps = load_map("small_loop").to("cpu")
    poses = {m: tenv.reset(EnvConfig(obs_type="state", spawn_mode=m), maps,
                           torch.Generator().manual_seed(0), 4).pos.numpy()
             for m in ("bank", "rejection")}
    assert not np.allclose(poses["bank"], poses["rejection"])
    # no attempt: every spawn is an accepted bank pose
    maps = load_map("loop_obstacles").to("cpu")
    st = tenv.reset(EnvConfig(obs_type="state", spawn_mode="rejection",
                              spawn_attempts=0), maps,
                    torch.Generator().manual_seed(1), 16)
    bank = maps.spawn_pos.numpy()[maps.spawn_mask.numpy()]
    d = np.linalg.norm(bank[None] - st.pos.numpy()[:, None], axis=-1)
    assert d.min(1).max() < 1e-6 and len(set(d.argmin(1))) > 1


@pytest.mark.parametrize("over", [{"start_pose": (0.8, 0.3, 1.25)},
                                  {"user_tile_start": (1, 0)},
                                  {"user_tile_start": (1, 1)}])
def test_start_overrides_match_reference(over):
    """reset's pose and the state kernel's bank rows equal dtown's."""
    name = "udem1" if over.get("user_tile_start") == (1, 1) \
        else "small_loop"
    jcfg = jtypes.EnvConfig(obs_type="state", **over)
    cfg = EnvConfig(obs_type="state", **over)
    jmaps = jmap_loader.load_map(name)
    maps = load_map(name)
    sj = jenv.reset(jcfg, jmaps, jax.random.PRNGKey(0))
    st = tenv.reset(cfg, maps.to("cpu"), torch.Generator().manual_seed(7), 4)
    np.testing.assert_allclose(st.pos.numpy(),
                               np.repeat(np.asarray(sj.pos)[None], 4, 0),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(st.angle.numpy(), float(sj.angle), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(sk.build_tables(cfg, maps)["bank"],
                                  jsk.build_tables(jcfg, jmaps)["bank"])
    if "user_tile_start" in over:
        ts = float(maps.tile_size)
        i, j = over["user_tile_start"]
        assert (st.pos[:, 0] // ts == i).all() and \
            (st.pos[:, 2] // ts == j).all()
        if name == "small_loop":   # as tests/test_config_surface.py
            lp = get_lane_pos2(maps.to("cpu"), st.pos, st.angle)
            assert lp.in_lane.all() and (lp.dot_dir > 0.7).all()


def test_start_pose_on_the_fused_rollout():
    """The fused rollout's auto-reset respawns at the override pose."""
    cfg = EnvConfig(obs_type="state", start_pose=(0.8, 0.3, 1.25),
                    max_steps=2)
    init_blob, fused_step, _ = dtown_torch.make_fused_rollout(
        cfg, load_map("small_loop"), 8, device="cpu")
    blob = init_blob(torch.Generator().manual_seed(0))
    for _ in range(2):
        blob, out, _ = fused_step(blob, torch.full((8, 2), 0.3))
    assert out.done.all()
    np.testing.assert_allclose(blob[sk.F_POS_X].numpy(), 0.8, atol=1e-6)
    np.testing.assert_allclose(blob[sk.F_POS_Z].numpy(), 0.3, atol=1e-6)
    np.testing.assert_allclose(blob[sk.F_ANGLE].numpy(), 1.25, atol=1e-6)
