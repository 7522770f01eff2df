"""dtown_torch state step (plain torch version on the CPU) vs the JAX
package's Pallas state kernel in interpret mode on the state step's edge
states (chip_smoke.py::k1_edge_blob), with domain randomization on the
stack town_dyn_duckiebots + udem1: agents at tile centres across straight
lanes (curve-select ties) and at k·π/4 on junctions, on static objects and
NPC start poses, off the grid, and every env at its last step, so the
first step resets every env (the DR redraw and the NPC re-placement in
every env); then a step of random actions. The edge states must reach
their branches. chip_smoke.py holds the CUDA kernel against the same plain
version on the same states at 4096 envs."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dtown import map_loader as jmap_loader
from dtown import types as jtypes
from dtown.ops import state_kernel as jsk

from dtown_torch import EnvConfig, make_fused_rollout, stack_maps
from dtown_torch.ops import state_kernel as sk

import chip_smoke
from test_torch_state_npc import NPC_ATOL, check_rows

B = 32
NAMES = ["town_dyn_duckiebots", "udem1"]
LIGHT_ATOL = 1e-6   # test_torch_state_dr.py's bar (the reference's rsqrt)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def edge_run():
    """The edge blob, then two steps on both sides (zero actions, then
    random ones); returns the blobs (numpy), the port's device tables, the
    curve-select ties and the static and NPC collisions of the first
    step."""
    cfg = EnvConfig(obs_type="state", domain_rand=True)
    jcfg = jtypes.EnvConfig(obs_type="state", domain_rand=True)
    maps = stack_maps(NAMES)
    init_blob, fused_step, _ = make_fused_rollout(cfg, maps, B,
                                                  device="cpu")
    dev = fused_step.tables
    blob = chip_smoke.k1_edge_blob(init_blob(torch.Generator().manual_seed(
        21)), dev, maps, cfg.max_steps)
    act = torch.zeros((B, 2))
    ties = chip_smoke.curve_ties(blob, dev)
    n_static, n_npc = chip_smoke.k1_collisions(blob, act, dev)
    jmaps = jmap_loader.stack_maps(NAMES)
    jtables = jsk.build_tables(jcfg, jmaps)
    step_j = jax.jit(lambda b, a: jsk.state_step_pallas(
        jcfg, jmaps, b, a, jtables, interpret=True))
    rng = np.random.default_rng(3)
    out_j, out_t = [blob.numpy().copy()], [blob.numpy().copy()]
    blob_j = jnp.asarray(blob.numpy())
    for _ in range(2):
        blob_j = step_j(blob_j, jnp.asarray(act.numpy()))
        blob = sk.state_step(blob, act, dev)
        out_j.append(np.asarray(blob_j))
        out_t.append(blob.numpy().copy())
        act = torch.from_numpy(np.stack(
            [rng.uniform(-0.2, 1.0, B), rng.uniform(-1.0, 1.0, B)],
            -1).astype(np.float32))
    return out_j, out_t, dev, ties, n_static, n_npc


def test_edge_states_reach_their_branches(edge_run):
    out_j, out_t, dev, ties, n_static, n_npc = edge_run
    assert ties >= 1 and n_static >= 1 and n_npc >= 1
    # the storm step: every env was at its last step and resets
    assert (out_t[1][sk.F_DONE] == 1.0).all()
    assert (out_t[1][sk.F_STEP] == 0.0).all()
    # off the grid: a crash on a clipped tile id
    ts_inv = float(dev["prm"][sk._PARAM_NAMES.index("ts_inv")])
    i = np.floor(out_t[0][sk.F_POS_X] * ts_inv)
    j = np.floor(out_t[0][sk.F_POS_Z] * ts_inv)
    off = (i < 0) | (i >= dev["Wg"]) | (j < 0) | (j >= dev["Hg"])
    assert off.any() and (out_t[1][sk.F_REWARD][off] == -1000.0).all()
    # every env's DR rows were redrawn and its NPCs re-placed
    drb = sk.dr_base(dev["n_npc"])
    assert (out_t[1][drb + sk.DR_FOV] != out_t[0][drb + sk.DR_FOV]).all()
    for i, npc in enumerate(dev["npcs"]):
        base = sk.F_NPC_BASE + sk.NPC_ROWS * i
        np.testing.assert_array_equal(out_t[1][base], np.float32(npc["x0"]))


def test_edge_states_match_pallas_interpret(edge_run):
    out_j, out_t, dev, *_ = edge_run
    drb = sk.dr_base(dev["n_npc"])
    light = [drb + k for k in (sk.DR_LX, sk.DR_LY, sk.DR_LZ)]
    exact = [f for f in range(drb, drb + sk.DR_ROWS) if f not in light] \
        + [sk.F_ROBOT_SPEED, sk.F_WHEEL_DIST]
    for bj, bt in zip(out_j[1:], out_t[1:]):
        check_rows(bj, bt)
        np.testing.assert_allclose(bt[sk.F_NPC_BASE:drb],
                                   bj[sk.F_NPC_BASE:drb], rtol=0,
                                   atol=NPC_ATOL)
        for f in exact:
            np.testing.assert_array_equal(bt[f], bj[f], err_msg=str(f))
        np.testing.assert_allclose(bt[light], bj[light], rtol=0,
                                   atol=LIGHT_ATOL)
