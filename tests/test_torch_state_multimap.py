"""dtown_torch state step on stacked multimaps (plain torch version on the
CPU) vs the JAX package's Pallas state kernel in interpret mode, on the
same initial blob and actions, through auto-resets (max_steps=3): the word,
curve-table and spawn-bank offsets of each env's map, the map gate of every
object column (static, optional and moving NPCs), and the NPC rows of envs
on other members (junk by design; computed the same). Three stacks: static
maps, a duckiebot map beside an empty loop, and a pedestrian map with domain
randomization between two members with optional objects (global optional
bits 0-3): the two NPC kinds, each gated to its member. The CUDA kernel is held
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

from dtown_torch import EnvConfig, stack_maps
from dtown_torch.convert import blob_from_numpy
from dtown_torch.ops import state_kernel as sk

from test_torch_state_npc import NPC_ATOL, check_rows

N_STEPS = 6
LIGHT_ATOL = 1e-6   # test_torch_state_dr.py's bar (the reference's rsqrt)
STACKS = {
    "static": (["zigzag_dists", "4way", "small_loop"], 24, {}),
    "npc": (["loop_dyn_duckiebots", "small_loop"], 16, {}),
    "npc_dr": (["udem1", "loop_pedestrians", "udem1"], 24,
               dict(domain_rand=True)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_stack(names, B, seed=0, n_steps=N_STEPS, nav=False, **kw):
    """n_steps of B envs on both sides from dtown's initial blob of the
    stack with the same random actions; returns the blobs after each step
    (numpy), the port's device tables and dtown's stacked maps. With nav
    the Nav task's goal rows ride along (dtown's nav init blob)."""
    jcfg = jtypes.EnvConfig(obs_type="state", max_steps=3, **kw)
    cfg = EnvConfig(obs_type="state", max_steps=3, **kw)
    jmaps = jmap_loader.stack_maps(names)
    jtables = jsk.build_tables(jcfg, jmaps)
    jnav = jsk.build_goal_table(jmaps) if nav else None
    if nav:
        from dtown.ops.fused_env import make_fused_nav_rollout

        init_blob, _ = make_fused_nav_rollout(jcfg, jmaps, B)
    else:
        init_blob, _, _ = j_make_fused_rollout(jcfg, jmaps, B)
    blob_j, _ = init_blob(jax.random.PRNGKey(seed))
    step_j = jax.jit(lambda b, a: jsk.state_step_pallas(
        jcfg, jmaps, b, a, jtables, interpret=True, nav_tables=jnav))
    maps = stack_maps(names)
    dev = sk.device_tables(cfg, sk.build_tables(cfg, maps), "cpu",
                           sk.build_goal_table(maps) if nav else None)
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
    return out_j, out_t, dev, jmaps


@pytest.fixture(scope="module", params=sorted(STACKS))
def stack_run(request):
    names, B, kw = STACKS[request.param]
    return request.param, B, run_stack(names, B, **kw)


def test_state_step_on_stacks_matches_pallas_interpret(stack_run):
    tag, B, (out_j, out_t, dev, _) = stack_run
    n_npc = dev["n_npc"]
    drb = sk.dr_base(n_npc)
    assert dev["n_maps"] > 1 and out_t[0].shape[0] == sk.nf_for(
        n_npc, dev["domain_rand"])
    n_done = 0
    for bj, bt in zip(out_j[1:], out_t[1:]):
        check_rows(bj, bt)
        # every NPC row, the other members' envs included
        np.testing.assert_allclose(bt[sk.F_NPC_BASE:drb],
                                   bj[sk.F_NPC_BASE:drb], rtol=0,
                                   atol=NPC_ATOL)
        if dev["domain_rand"]:
            light = [drb + k for k in (sk.DR_LX, sk.DR_LY, sk.DR_LZ)]
            for f in range(drb, drb + sk.DR_ROWS):
                if f not in light:
                    np.testing.assert_array_equal(bt[f], bj[f],
                                                  err_msg=str(f))
            np.testing.assert_allclose(bt[light], bj[light], rtol=0,
                                       atol=LIGHT_ATOL)
        n_done += int(bj[sk.F_DONE].sum())
    assert n_done >= B      # the comparison went through auto-resets
    if tag == "npc":
        # the first member's duckiebots
        assert [(d["kind"], d["map"]) for d in dev["npcs"]] == [
            ("duckiebot", 0)] * 2
    if tag == "npc_dr":
        # the middle member's pedestrians, four global optional bits
        # (udem1's two on members 0 and 2)
        assert [(d["kind"], d["map"]) for d in dev["npcs"]] == [
            ("duckie", 1)] * 3
        assert dev["n_opt"] == 4
        assert sorted(set(dev["colmap"][2].tolist())) == [0, 1, 2]
        vis = np.concatenate([b[drb + sk.DR_OBJVIS] for b in out_t])
        assert set(np.unique(vis)) <= set(float(v) for v in range(16))
        assert vis.max() >= 4.0       # a bit of member 2 was drawn


def test_respawns_stay_on_the_env_map(stack_run):
    """Map assignment is sticky (round-robin) through auto-resets, and
    every respawn lands on a drivable tile of the env's own member."""
    tag, B, (out_j, out_t, dev, jmaps) = stack_run
    n_maps = dev["n_maps"]
    ts = float(np.asarray(jmaps.tile_size)[0])
    driv = np.asarray(jmaps.drivable)
    n_checked = 0
    for bt in out_t:
        np.testing.assert_array_equal(bt[sk.F_MAPID],
                                      np.arange(B) % n_maps)
        for e in np.nonzero(bt[sk.F_DONE] > 0.5)[0]:
            i = int(bt[sk.F_POS_X, e] // ts)
            j = int(bt[sk.F_POS_Z, e] // ts)
            assert driv[e % n_maps, j, i], (tag, e, i, j)
            n_checked += 1
    assert n_checked >= B
