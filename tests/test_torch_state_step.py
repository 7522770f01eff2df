"""dtown_torch state step (plain torch version on the CPU) vs the JAX
package's Pallas state kernel in interpret mode, on the same blob and
actions, through auto-resets. The CUDA kernel is held against the same
plain version on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dtown import geometry as jgeom
from dtown import map_loader as jmap_loader
from dtown import types as jtypes
from dtown.ops import state_kernel as jsk
from dtown.ops.fused_env import make_fused_rollout as j_make_fused_rollout

from dtown_torch import EnvConfig, load_map, stack_maps
from dtown_torch.convert import blob_from_numpy
from dtown_torch.geometry import sincos
from dtown_torch.ops import state_kernel as sk

DISCRETE = (sk.F_DONE, sk.F_STEP, sk.F_RNG, sk.F_COLL, sk.F_INLANE,
            sk.F_OINLANE, sk.F_ENVID, sk.F_MAPID)
# tests/test_fused.py bars of the fused kernel vs the XLA step
POSE_ATOL, REWARD_ATOL, LANE_ATOL = 1e-5, 1e-4, 1e-5


def test_sincos_hash_acos_match_reference():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-40, 40, 4096),
                        np.arange(-8, 9) * np.pi / 4]).astype(np.float32)
    s_j, c_j = jgeom.sincos(jnp.asarray(x))
    s_t, c_t = sincos(torch.from_numpy(x))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))

    a = rng.integers(0, 1 << 20, 4096).astype(np.int32)
    b = rng.integers(0, 1 << 16, 4096).astype(np.int32)
    h_j = jsk._hash_u32(jnp.asarray(a), jnp.asarray(b), salt=0x20000000)
    h_t = sk._hash_u32(torch.from_numpy(a), torch.from_numpy(b),
                       salt=sk.SALT_SPAWN)
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))

    d = rng.uniform(-1, 1, 4096).astype(np.float32)
    np.testing.assert_allclose(sk._acos(torch.from_numpy(d)).numpy(),
                               np.asarray(jsk._acos(jnp.asarray(d))),
                               rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def trajectories():
    """6 steps on loop_obstacles with max_steps=3 (timeouts force
    auto-resets), both sides from dtown's initial blob."""
    B, n = 8, 6
    jcfg = jtypes.EnvConfig(obs_type="state", max_steps=3)
    cfg = EnvConfig(obs_type="state", max_steps=3)
    jmaps = jmap_loader.load_map("loop_obstacles")
    jtables = jsk.build_tables(jcfg, jmaps)
    init_blob, _, _ = j_make_fused_rollout(jcfg, jmaps, B)
    blob_j, _ = init_blob(jax.random.PRNGKey(0))
    step_j = jax.jit(lambda b, a: jsk.state_step_pallas(
        jcfg, jmaps, b, a, jtables, interpret=True))

    dev = sk.device_tables(cfg, sk.build_tables(cfg, load_map(
        "loop_obstacles")), "cpu")
    blob_t = blob_from_numpy(np.asarray(blob_j), device="cpu")
    rng = np.random.default_rng(1)
    out_j, out_t = [], []
    for _ in range(n):
        act = np.stack([rng.uniform(-0.2, 1.0, B),
                        rng.uniform(-1.0, 1.0, B)], -1).astype(np.float32)
        blob_j = step_j(blob_j, jnp.asarray(act))
        blob_t = sk.state_step(blob_t, torch.from_numpy(act), dev)
        out_j.append(np.asarray(blob_j))
        out_t.append(blob_t.numpy().copy())
    return out_j, out_t


def test_state_step_matches_pallas_interpret(trajectories):
    out_j, out_t = trajectories
    n_done = 0
    for bj, bt in zip(out_j, out_t):
        assert bt.shape == bj.shape and np.isfinite(bt).all()
        for f in DISCRETE:
            np.testing.assert_array_equal(bt[f], bj[f], err_msg=str(f))
        for f in (sk.F_POS_X, sk.F_POS_Y, sk.F_POS_Z, sk.F_ANGLE):
            np.testing.assert_allclose(bt[f], bj[f], rtol=0,
                                       atol=POSE_ATOL, err_msg=str(f))
        np.testing.assert_allclose(bt[sk.F_REWARD], bj[sk.F_REWARD],
                                   rtol=0, atol=REWARD_ATOL)
        for f in (sk.F_LDIST, sk.F_OLDIST, sk.F_SPEED, sk.F_WVL, sk.F_WVR,
                  sk.F_TIME, sk.F_LDOT, sk.F_OLDOT):
            np.testing.assert_allclose(bt[f], bj[f], rtol=0,
                                       atol=LANE_ATOL, err_msg=str(f))
        n_done += int(bj[sk.F_DONE].sum())
    # the comparison went through auto-resets
    assert n_done >= 8


def test_state_step_rejects_bad_inputs():
    cfg = EnvConfig()
    dev = sk.device_tables(cfg, sk.build_tables(cfg, load_map(
        "small_loop")), "cpu")
    blob = torch.zeros((sk.NF, 8))
    with pytest.raises(ValueError):
        sk.state_step(blob, torch.zeros((4, 2)), dev)
    with pytest.raises(ValueError):
        sk.state_step(blob.double(), torch.zeros((8, 2)), dev)


def test_state_step_scope_raises():
    """The state step's tables take every option: the start-pose
    overrides (on a stack too: every member's bank holds the pose), moving
    NPCs, domain randomization and stacks of maps."""
    maps = load_map("small_loop")
    stacked = stack_maps(["small_loop", "4way"])
    t = sk.build_tables(EnvConfig(start_pose=(1.0, 1.0, 0.0)), stacked)
    dev = sk.device_tables(EnvConfig(), sk.build_tables(EnvConfig(),
                                                        stacked), "cpu")
    assert dev["n_maps"] == 2 and dev["t_pad"] == 25
    for cfg in (EnvConfig(start_pose=(1.0, 1.0, 0.0)),
                EnvConfig(user_tile_start=(1, 1))):
        bank = sk.build_tables(cfg, maps)["bank"]
        assert (bank[sk.BK_X] == bank[sk.BK_X][0]).all()
        assert (bank[sk.BK_ANG] == bank[sk.BK_ANG][0]).all()
    dr = EnvConfig(domain_rand=True)
    dev = sk.device_tables(dr, sk.build_tables(
        dr, load_map("loop_pedestrians")), "cpu")
    assert dev["n_npc"] == 3 and dev["nf"] == sk.nf_for(3, True)
