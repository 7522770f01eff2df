"""dtown_torch's stacked multimaps against the JAX package's: stack_maps
field for field, the state kernel's concatenated tables
(_build_tables_multi: curve, word, object and bank segments, the column
maps, global NPC and optional-object indices, each member's accepted-bank
count) and the Nav task's drivable-tile goal table, on BASELINE config 5's
3-map stack and on the 6-map curriculum stack of scripts/bench_all.sh."""
import numpy as np
import pytest

from dtown import map_loader as jmap_loader
from dtown import types as jtypes
from dtown.ops import state_kernel as jsk

from dtown_torch import EnvConfig, stack_maps
from dtown_torch.ops import state_kernel as sk
from dtown_torch.types import MAP_FIELDS

STACKS = {
    "stack3": ["zigzag_dists", "4way", "udem1"],
    "stack6": ["zigzag_dists", "4way", "udem1", "small_loop",
               "loop_obstacles", "s_bend"],
}


@pytest.fixture(scope="module", params=sorted(STACKS))
def both(request):
    names = STACKS[request.param]
    return names, jmap_loader.stack_maps(names), stack_maps(names)


def test_stack_maps_matches_reference(both):
    names, jmaps, maps = both
    assert maps.is_stack and maps.n_maps == len(names)
    for f in MAP_FIELDS:
        ref = np.asarray(getattr(jmaps, f))
        ours = np.asarray(getattr(maps, f))
        assert ours.dtype == ref.dtype, f
        np.testing.assert_array_equal(ours, ref, err_msg=f)
    # a member is one map on the stack's padded grid and object budget
    m2 = maps.map_at(2)
    assert m2.grid_shape == maps.grid_shape and not m2.is_stack
    assert m2.max_objects == maps.max_objects


def test_stack_tables_match_reference(both):
    names, jmaps, maps = both
    cfg = EnvConfig(domain_rand=True)
    ref = jsk.build_tables(jtypes.EnvConfig(domain_rand=True), jmaps)
    ours = sk.build_tables(cfg, maps)
    assert sorted(ours) == sorted(ref)
    for k in ("ct", "words", "ot", "bank"):
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    for k in ("n_ok", "n_words", "M", "Hg", "Wg", "moving_cols",
              "opt_cols", "multi"):
        assert ours[k] == ref[k], k
    assert ours["ts_inv"] == ref["ts_inv"]
    assert [dict(n) for n in ours["npcs"]] == [dict(n) for n in ref["npcs"]]
    assert ours["multi"]["n_maps"] == len(names)
    dev = sk.device_tables(cfg, ours, "cpu")
    assert dev["n_maps"] == len(names)
    assert dev["n_tiles"] == ours["ct"].shape[1]
    assert dev["colmap"][2, :ours["M"]].tolist() == list(
        ref["multi"]["col_maps"])
    assert dev["n_ok_v"].tolist() == list(ref["multi"]["n_ok_list"])


def test_goal_table_matches_reference(both):
    _, jmaps, maps = both
    ref = jsk.build_goal_table(jmaps)
    ours = sk.build_goal_table(maps)
    np.testing.assert_array_equal(ours["goal"], ref["goal"])
    assert ours["goal_k"] == ref["goal_k"]
    assert ours["n_driv_list"] == ref["n_driv_list"]
    single = jmap_loader.load_map("small_loop")
    from dtown_torch import load_map

    ref1 = jsk.build_goal_table(single)
    ours1 = sk.build_goal_table(load_map("small_loop"))
    np.testing.assert_array_equal(ours1["goal"], ref1["goal"])
    assert ours1["n_driv_list"] == ref1["n_driv_list"]


def test_moving_npcs_on_stacks_match_reference():
    names = ["town_dyn_duckiebots", "loop_pedestrians", "small_loop"]
    ref = jsk.moving_npcs(jmap_loader.stack_maps(names))
    ours = sk.moving_npcs(stack_maps(names))
    assert ours == ref
    assert [n["map"] for n in ours] == [0, 0, 0, 0, 1, 1, 1]


def test_pack_and_update_on_stacks_match_reference():
    """The blob rows of a stack (NPCs parked on other members' envs, the
    global optional bits, the Nav goal rows) and the write-back into the
    states (each NPC and bit only into its own member's envs) equal
    dtown's pack_blob and update_states_from_blob."""
    import jax
    import torch

    from dtown import env as jenv
    from dtown.ops import fused_env as jfe

    from dtown_torch.convert import blob_from_numpy, env_states_from_numpy
    from dtown_torch.ops import fused_env as tfe

    names = ["udem1", "town_dyn_duckiebots", "udem1"]
    B = 12
    jcfg = jtypes.EnvConfig(domain_rand=True)
    jmaps, maps = jmap_loader.stack_maps(names), stack_maps(names)
    idx = np.arange(B, dtype=np.int32) % 3
    keys = jax.random.split(jax.random.PRNGKey(9), B)
    jstates = jax.vmap(lambda k, i: jenv.reset(jcfg, jmaps, k, i))(keys, idx)
    goal = np.stack([np.arange(B) % 4, np.arange(B) % 3], -1)
    ref = np.asarray(jfe.pack_blob(jstates, jmaps, True, nav_goal=goal))
    states = env_states_from_numpy(jstates, device="cpu")
    rng = torch.zeros(B, dtype=torch.int64)
    ours = tfe.pack_blob(states, maps, True, rng,
                         nav_goal=torch.as_tensor(goal)).numpy()
    rows = [f for f in range(ref.shape[0]) if f != sk.F_RNG]
    np.testing.assert_array_equal(ours[rows], ref[rows])
    # move the NPC rows and flip every visibility bit, then write back
    drb = sk.dr_base(4)
    blob = ref.copy()
    blob[sk.F_NPC_BASE:drb] += np.float32(0.25)
    blob[drb + sk.DR_OBJVIS] = 15.0 - blob[drb + sk.DR_OBJVIS]
    jnew = jfe.update_states_from_blob(jstates, blob, jmaps, True)
    new = tfe.update_states_from_blob(
        states, blob_from_numpy(blob, device="cpu"), maps, True)
    for f in ("pos", "angle", "walk_dist", "vel"):
        np.testing.assert_array_equal(getattr(new.dyn, f).numpy(),
                                      np.asarray(getattr(jnew.dyn, f)), f)
    np.testing.assert_array_equal(new.obj_visible.numpy(),
                                  np.asarray(jnew.obj_visible))
