"""dtown_torch state step with moving NPCs (plain torch version on the
CPU) vs the JAX package's Pallas state kernel in interpret mode, on the
same initial blob and actions, through auto-resets (max_steps=3): walking
duckies, pure-pursuit duckiebots with their two chained lane queries, live
NPC footprints in the SAT test and proximity sum, and the NPCs'
re-placement with a fresh duckie speed at a reset. The CUDA kernel is held
against the same plain version on the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dtown import map_loader as jmap_loader
from dtown import types as jtypes
from dtown.ops import state_kernel as jsk
from dtown.ops.fused_env import make_fused_rollout as j_make_fused_rollout

from dtown_torch import EnvConfig, load_map
from dtown_torch.convert import blob_from_numpy
from dtown_torch.ops import state_kernel as sk

B, N_STEPS = 8, 6
DISCRETE = (sk.F_DONE, sk.F_STEP, sk.F_RNG, sk.F_COLL, sk.F_INLANE,
            sk.F_OINLANE, sk.F_ENVID, sk.F_MAPID)
# test_torch_state_step.py's bars; NPC rows at tests/test_fused.py's 2e-5
POSE_ATOL, REWARD_ATOL, LANE_ATOL, NPC_ATOL = 1e-5, 1e-4, 1e-5, 2e-5
MAPS = ["loop_pedestrians", "loop_dyn_duckiebots", "town_dyn_duckiebots"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_both(map_name, n_steps=N_STEPS, seed=0, **kw):
    """n_steps of B envs on both sides from dtown's initial blob with the
    same random actions; returns the blobs after each step (numpy) and the
    port's device tables."""
    jcfg = jtypes.EnvConfig(obs_type="state", max_steps=3, **kw)
    cfg = EnvConfig(obs_type="state", max_steps=3, **kw)
    jmaps = jmap_loader.load_map(map_name)
    jtables = jsk.build_tables(jcfg, jmaps)
    init_blob, _, _ = j_make_fused_rollout(jcfg, jmaps, B)
    blob_j, _ = init_blob(jax.random.PRNGKey(seed))
    step_j = jax.jit(lambda b, a: jsk.state_step_pallas(
        jcfg, jmaps, b, a, jtables, interpret=True))
    dev = sk.device_tables(cfg, sk.build_tables(cfg, load_map(map_name)),
                           "cpu")
    blob_t = blob_from_numpy(np.asarray(blob_j), device="cpu")
    rng = np.random.default_rng(seed + 1)
    out_j, out_t = [np.asarray(blob_j)], [blob_t.numpy().copy()]
    for _ in range(n_steps):
        act = np.stack([rng.uniform(-0.2, 1.0, B),
                        rng.uniform(-1.0, 1.0, B)], -1).astype(np.float32)
        blob_j = step_j(blob_j, jnp.asarray(act))
        blob_t = sk.state_step(blob_t, torch.from_numpy(act), dev)
        out_j.append(np.asarray(blob_j))
        out_t.append(blob_t.numpy().copy())
    return out_j, out_t, dev


def check_rows(bj, bt):
    """The bars shared by every map: discrete rows equal, pose, reward
    and lane rows at test_torch_state_step.py's bars."""
    assert bt.shape == bj.shape and np.isfinite(bt).all()
    for f in DISCRETE:
        np.testing.assert_array_equal(bt[f], bj[f], err_msg=str(f))
    for f in (sk.F_POS_X, sk.F_POS_Y, sk.F_POS_Z, sk.F_ANGLE):
        np.testing.assert_allclose(bt[f], bj[f], rtol=0, atol=POSE_ATOL,
                                   err_msg=str(f))
    np.testing.assert_allclose(bt[sk.F_REWARD], bj[sk.F_REWARD], rtol=0,
                               atol=REWARD_ATOL)
    for f in (sk.F_LDIST, sk.F_OLDIST, sk.F_LDOT, sk.F_OLDOT, sk.F_TIME):
        np.testing.assert_allclose(bt[f], bj[f], rtol=0, atol=LANE_ATOL,
                                   err_msg=str(f))


@pytest.fixture(scope="module", params=MAPS)
def npc_run(request):
    return request.param, run_both(request.param)


def test_state_step_with_npcs_matches_pallas_interpret(npc_run):
    map_name, (out_j, out_t, dev) = npc_run
    n_npc = dev["n_npc"]
    assert n_npc > 0 and out_t[0].shape[0] == sk.nf_for(n_npc)
    npc_rows = slice(sk.F_NPC_BASE, sk.dr_base(n_npc))
    n_done = 0
    for bj, bt in zip(out_j[1:], out_t[1:]):
        check_rows(bj, bt)
        np.testing.assert_allclose(bt[npc_rows], bj[npc_rows], rtol=0,
                                   atol=NPC_ATOL)
        n_done += int(bj[sk.F_DONE].sum())
    assert n_done >= B  # the comparison went through auto-resets
    # the NPCs moved, and a reset put them back where they started
    first, last = out_t[0][npc_rows], out_t[3][npc_rows]
    assert np.abs(out_t[2][npc_rows] - first).max() > 1e-4
    done3 = out_t[3][sk.F_DONE] > 0.5
    assert done3.any()
    for i, npc in enumerate(dev["npcs"]):
        base = sk.NPC_ROWS * i
        np.testing.assert_array_equal(last[base, done3], np.float32(npc["x0"]))
        np.testing.assert_array_equal(last[base + 3, done3], 0.0)


def test_npc_tables():
    """The NPC descriptor table and the column map of town_dyn_duckiebots:
    two duckiebots then two duckies, on the first four object columns."""
    cfg = EnvConfig()
    tables = sk.build_tables(cfg, load_map("town_dyn_duckiebots"))
    dev = sk.device_tables(cfg, tables, "cpu")
    kinds = dev["npc"][sk.NPC_KIND].tolist()
    assert kinds == [sk.NPC_BOT, sk.NPC_BOT, sk.NPC_DUCKIE, sk.NPC_DUCKIE]
    assert dev["colmap"][0, :4].tolist() == [0, 1, 2, 3]
    assert (dev["colmap"][0, 4:] == -1).all()
    assert (dev["colmap"][1] == -1).all()       # no optional bits off DR
    assert dev["nf"] == sk.nf_for(4) == 48
