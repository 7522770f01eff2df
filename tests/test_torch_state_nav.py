"""dtown_torch state step with the Nav task (plain torch version on the
CPU) vs the JAX package's Pallas state kernel in interpret mode with its
goal table, on small_loop and on the stack small_loop + zigzag_dists,
through auto-resets (max_steps=3) that redraw the goals from the kernel's
hash; the goal check (+NAV_GOAL_REWARD, done, respawn), the optional
distance shaping, and the Nav observations (the 14-column state vector and
the (planes, goal) pair) against dtown's ``make_fused_nav_rollout`` and
``nav_goal_features_from_blob``. The CUDA kernel is held against the same
plain version on the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dtown import map_loader as jmap_loader
from dtown import types as jtypes
from dtown.ops import fused_env as jfe
from dtown.ops import state_kernel as jsk

from dtown_torch import EnvConfig, load_map, make_fused_nav_rollout, \
    stack_maps
from dtown_torch.convert import blob_from_numpy
from dtown_torch.ops import fused_env as tfe
from dtown_torch.ops import state_kernel as sk

from test_torch_state_npc import REWARD_ATOL, check_rows

B, N_STEPS = 16, 6
FEATURE_ATOL = 1e-5   # torch's and XLA's cos/sin differ in the last ulp
CASES = {
    "single": (["small_loop"], {}),
    "stack": (["small_loop", "zigzag_dists"], {}),
    "shaping": (["small_loop"], dict(nav_shaping_coef=2.0)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _maps(names):
    if len(names) == 1:
        return jmap_loader.load_map(names[0]), load_map(names[0])
    return jmap_loader.stack_maps(names), stack_maps(names)


class NavRun:
    """Both sides of the Nav state step on one map or stack: dtown's nav
    init blob, its interpret-mode kernel with the goal table, and the
    port's tables."""

    def __init__(self, names, seed=0, obs_type="state", **kw):
        self.jcfg = jtypes.EnvConfig(obs_type=obs_type, max_steps=3,
                                     camera_width=32, camera_height=32, **kw)
        self.cfg = EnvConfig(obs_type=obs_type, max_steps=3,
                             camera_width=32, camera_height=32, **kw)
        self.jmaps, self.maps = _maps(names)
        jtables = jsk.build_tables(self.jcfg, self.jmaps)
        self.jnav = jsk.build_goal_table(self.jmaps)
        self.j_init, self.j_step = jfe.make_fused_nav_rollout(
            self.jcfg, self.jmaps, B, goal_in_obs=True)
        blob, self.states = self.j_init(jax.random.PRNGKey(seed))
        self.blob0 = np.asarray(blob)
        self.step_j = jax.jit(lambda b, a: jsk.state_step_pallas(
            self.jcfg, self.jmaps, b, a, jtables, interpret=True,
            nav_tables=self.jnav))
        self.dev = sk.device_tables(
            self.cfg, sk.build_tables(self.cfg, self.maps), "cpu",
            sk.build_goal_table(self.maps))
        self.navb = sk.nav_base(self.dev["n_npc"], self.cfg.domain_rand)

    def step(self, blob, act):
        """One step of both sides from the same numpy blob."""
        bj = np.asarray(self.step_j(jnp.asarray(blob), jnp.asarray(act)))
        bt = sk.state_step(blob_from_numpy(blob, device="cpu"),
                           torch.from_numpy(act), self.dev).numpy()
        return bj, bt


def _actions(rng):
    return np.stack([rng.uniform(-0.2, 1.0, B),
                     rng.uniform(-1.0, 1.0, B)], -1).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(CASES))
def nav_run(request):
    names, kw = CASES[request.param]
    return request.param, NavRun(names, **kw)


def test_nav_state_step_matches_pallas_interpret(nav_run):
    """Through auto-resets: every row, the goal rows equal, and each
    redrawn goal a drivable tile of the env's own map."""
    tag, r = nav_run
    assert r.dev["nav"] and r.blob0.shape[0] == sk.nf_for(
        r.dev["n_npc"], False, True)
    goals = slice(r.navb, r.navb + 2)
    driv = np.asarray(r.jmaps.drivable)
    if driv.ndim == 2:
        driv = driv[None]
    rng = np.random.default_rng(1)
    blob = r.blob0
    n_done = n_redrawn = 0
    for _ in range(N_STEPS):
        bj, bt = r.step(blob, _actions(rng))
        check_rows(bj, bt)
        np.testing.assert_array_equal(bt[goals], bj[goals])
        done = bt[sk.F_DONE] > 0.5
        n_done += int(done.sum())
        n_redrawn += int((bt[goals][:, done] != blob[goals][:, done])
                         .any(0).sum())
        for e in range(B):
            gi, gj = int(bt[r.navb, e]), int(bt[r.navb + 1, e])
            assert driv[int(bt[sk.F_MAPID, e]), gj, gi], (tag, e, gi, gj)
        blob = bj
    assert n_done >= B and n_redrawn > 0


def test_parked_goals_give_the_plain_rewards(nav_run):
    """Goals parked off the map are never reached: the Nav step's rows
    equal the plain step's bit for bit (the goal rows aside); with the
    distance shaping the reward differs by exactly that term."""
    tag, r = nav_run
    plain = sk.device_tables(r.cfg, sk.build_tables(r.cfg, r.maps), "cpu")
    coef = np.float32(r.cfg.nav_shaping_coef)
    ts_inv = plain["prm"][sk._PARAM_NAMES.index("ts_inv")]
    ts_k = np.float32(1.0) / np.float32(ts_inv)
    blob = r.blob0.copy()
    blob[r.navb:r.navb + 2] = -100.0
    rng = np.random.default_rng(2)
    for _ in range(3):
        act = torch.from_numpy(_actions(rng))
        nav_out = sk.state_step(blob_from_numpy(blob, device="cpu"), act,
                                r.dev).numpy()
        base = sk.state_step(
            blob_from_numpy(blob[:plain["nf"]].copy(), device="cpu"), act,
            plain).numpy()
        rows = [f for f in range(r.navb) if f != sk.F_REWARD]
        np.testing.assert_array_equal(nav_out[rows], base[rows])
        if coef:
            g = (np.float32(-100.0) + np.float32(0.5)) * ts_k
            d = lambda x, z: np.sqrt((g - x) ** 2 + (g - z) ** 2)
            shaping = coef * (d(blob[sk.F_POS_X], blob[sk.F_POS_Z])
                              - d(nav_out[sk.F_POS_X], nav_out[sk.F_POS_Z]))
            # a reset env's output pose is its fresh spawn, not the pose
            # the term was taken at: compare the live envs
            live = nav_out[sk.F_DONE] < 0.5
            np.testing.assert_allclose(nav_out[sk.F_REWARD][live],
                                       (base[sk.F_REWARD] + shaping)[live],
                                       rtol=0, atol=REWARD_ATOL)
        else:
            np.testing.assert_array_equal(nav_out[sk.F_REWARD],
                                          base[sk.F_REWARD])
        blob = nav_out
        blob[r.navb:r.navb + 2] = -100.0


def test_goal_on_the_current_tile_is_reached(nav_run):
    """A goal on the tile an env stands on (no motion): +NAV_GOAL_REWARD
    over the plain reward, done, and a respawn with a fresh goal."""
    tag, r = nav_run
    blob = r.blob0.copy()
    ts_inv = float(r.dev["prm"][sk._PARAM_NAMES.index("ts_inv")])
    blob[r.navb] = np.floor(blob[sk.F_POS_X] * np.float32(ts_inv))
    blob[r.navb + 1] = np.floor(blob[sk.F_POS_Z] * np.float32(ts_inv))
    act = np.zeros((B, 2), np.float32)
    bj, bt = r.step(blob, act)
    check_rows(bj, bt)
    np.testing.assert_array_equal(bt[r.navb:r.navb + 2],
                                  bj[r.navb:r.navb + 2])
    assert (bt[sk.F_DONE] > 0.5).all() and (bt[sk.F_STEP] == 0.0).all()
    plain = sk.device_tables(r.cfg, sk.build_tables(r.cfg, r.maps), "cpu")
    base = sk.state_step(
        blob_from_numpy(blob[:plain["nf"]].copy(), device="cpu"),
        torch.from_numpy(act), plain).numpy()
    live = base[sk.F_DONE] < 0.5
    assert live.all()
    bonus = bt[sk.F_REWARD] - base[sk.F_REWARD]
    if tag == "shaping":
        # no motion: the shaping term is zero
        np.testing.assert_allclose(bonus, 500.0, rtol=0, atol=REWARD_ATOL)
    else:
        np.testing.assert_array_equal(
            bt[sk.F_REWARD], base[sk.F_REWARD] + np.float32(500.0))
    assert (bt[r.navb:r.navb + 2] != blob[r.navb:r.navb + 2]).any()


def test_nav_observations_match_reference():
    """The 14-column state observation against dtown's Nav fused_step on
    small_loop, the goal features against dtown's
    nav_goal_features_from_blob on a stack, and the (planes, goal) pair of
    camera observations. (dtown's Nav fused_step with goal_in_obs cannot
    be traced on a stack: its moving_npcs slices the stack inside the
    trace, so the stack's features are compared outside jit.)"""
    jcfg = jtypes.EnvConfig(obs_type="state")
    cfg = EnvConfig(obs_type="state")
    jmaps, maps = _maps(["small_loop"])
    j_init, j_step = jfe.make_fused_nav_rollout(jcfg, jmaps, B,
                                                goal_in_obs=True)
    blob_j, states = j_init(jax.random.PRNGKey(3))
    act = np.tile(np.array([[0.5, 0.1]], np.float32), (B, 1))
    blob1_j, _, obs_j = jax.jit(lambda b, s, a: j_step(b, s, a))(
        blob_j, states, jnp.asarray(act))
    _, t_step, _ = make_fused_nav_rollout(cfg, maps, B, goal_in_obs=True,
                                          device="cpu")
    blob1_t, _, obs_t = t_step(
        blob_from_numpy(np.asarray(blob_j), device="cpu"),
        torch.from_numpy(act))
    check_rows(np.asarray(blob1_j), blob1_t.numpy())
    assert obs_t.shape == (B, 14)
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), rtol=0,
                               atol=3e-4)   # the speed column's bar
    # the goal features on a stack, from the same blob
    names = ["small_loop", "zigzag_dists"]
    jstack, stack = _maps(names)
    j_init_s, _ = jfe.make_fused_nav_rollout(jcfg, jstack, B)
    blob_s, _ = j_init_s(jax.random.PRNGKey(4))
    ref = np.stack([np.asarray(c) for c in jfe.nav_goal_features_from_blob(
        jcfg, jstack, blob_s)], -1)
    blob_s = blob_from_numpy(np.asarray(blob_s), device="cpu")
    ours = torch.stack(tfe.nav_goal_features_from_blob(cfg, stack, blob_s),
                       -1).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=FEATURE_ATOL)
    # camera observations: the (planes, goal) pair
    rcfg = EnvConfig(camera_width=32, camera_height=32)
    _, r_step, _ = make_fused_nav_rollout(rcfg, stack, B,
                                          goal_in_obs=True, device="cpu")
    blob2, _, (planes, goal) = r_step(blob_s, torch.from_numpy(act))
    assert planes.shape == (B, 3, 8, 128) and planes.dtype == torch.uint8
    np.testing.assert_array_equal(goal.numpy(), torch.stack(
        tfe.nav_goal_features_from_blob(rcfg, stack, blob2), -1).numpy())
    assert float(planes.float().std()) > 5.0
