"""dtown_torch state step under domain randomization (plain torch version
on the CPU) vs the JAX package's Pallas state kernel in interpret mode on
udem1, through auto-resets that redraw every randomization row; and the
fused rollout's state observations (``obs_type="state"``) vs the JAX
package's ``fused_step`` and ``obs_from_blob``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dtown import map_loader as jmap_loader
from dtown import types as jtypes
from dtown.ops import fused_env as jfe

from dtown_torch import EnvConfig, load_map, make_fused_rollout
from dtown_torch.convert import blob_from_numpy
from dtown_torch.ops import fused_env as tfe
from dtown_torch.ops import state_kernel as sk

from test_torch_state_npc import B, check_rows, run_both

LIGHT_ATOL = 1e-6   # the reference's rsqrt and XLA's contractions
OBS_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dr_run():
    return run_both("udem1", domain_rand=True)


def test_state_step_domain_rand_matches_pallas_interpret(dr_run):
    out_j, out_t, dev = dr_run
    drb = sk.dr_base(0)
    light = [drb + k for k in (sk.DR_LX, sk.DR_LY, sk.DR_LZ)]
    exact = [f for f in range(drb, drb + sk.DR_ROWS) if f not in light] \
        + [sk.F_ROBOT_SPEED, sk.F_WHEEL_DIST]
    redrawn = 0
    for prev, bj, bt in zip(out_t[:-1], out_j[1:], out_t[1:]):
        check_rows(bj, bt)
        for f in exact:
            np.testing.assert_array_equal(bt[f], bj[f], err_msg=str(f))
        np.testing.assert_allclose(bt[light], bj[light], rtol=0,
                                   atol=LIGHT_ATOL)
        done = bt[sk.F_DONE] > 0.5
        redrawn += int((bt[drb + sk.DR_FOV][done]
                        != prev[drb + sk.DR_FOV][done]).sum())
    assert redrawn >= B     # auto-resets redrew the randomization rows
    # the optional objects' visibility bits (udem1 has two) were redrawn
    vis = np.concatenate([b[drb + sk.DR_OBJVIS] for b in out_t])
    assert set(np.unique(vis)) <= {0.0, 1.0, 2.0, 3.0} and len(
        np.unique(vis)) > 1
    assert dev["n_opt"] == 2


@pytest.fixture(scope="module")
def state_obs_run():
    """One fused state-observation step on loop_pedestrians, both sides
    from dtown's initial blob."""
    jcfg = jtypes.EnvConfig(obs_type="state", max_steps=500)
    cfg = EnvConfig(obs_type="state", max_steps=500)
    jmaps = jmap_loader.load_map("loop_pedestrians")
    j_init, j_step, _ = jfe.make_fused_rollout(jcfg, jmaps, B)
    blob_j, states = j_init(jax.random.PRNGKey(4))
    act = np.tile(np.array([[0.5, 0.2]], np.float32), (B, 1))
    blob1_j, _, obs_j = jax.jit(lambda b, s, a: j_step(b, s, a))(
        blob_j, states, jnp.asarray(act))
    obs0_j = jfe.obs_from_blob(jcfg, jmaps, blob_j, states)
    _, t_step, _ = make_fused_rollout(cfg, load_map("loop_pedestrians"), B,
                                      device="cpu")
    blob1_t, out_t, obs_t = t_step(
        blob_from_numpy(np.asarray(blob_j), device="cpu"),
        torch.from_numpy(act))
    return dict(cfg=cfg, blob_j=np.asarray(blob_j),
                blob1_j=np.asarray(blob1_j), obs_j=np.asarray(obs_j),
                obs0_j=np.asarray(obs0_j), blob1_t=blob1_t.numpy(),
                obs_t=obs_t.numpy())


def test_fused_state_obs_columns_match_reference(state_obs_run):
    """The 11 columns read from the blob's rows: on the reference's own
    post-step blob they equal its fused_step observation."""
    r = state_obs_run
    ours = tfe.state_obs_from_blob(
        torch.from_numpy(r["blob1_j"].copy())).numpy()
    assert ours.shape == (B, 11) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, r["obs_j"], rtol=0, atol=OBS_ATOL)


def test_fused_state_step_matches_reference(state_obs_run):
    """The port's fused_step in state mode: the state kernel's plain
    version, then the 11 columns (at the state kernel's bars: the speed
    column is |delta pos| / dt)."""
    r = state_obs_run
    check_rows(r["blob1_j"], r["blob1_t"])
    assert r["obs_t"].shape == (B, 11)
    np.testing.assert_allclose(r["obs_t"], r["obs_j"], rtol=0, atol=3e-4)


def test_obs_from_blob_matches_reference(state_obs_run):
    """The first observation of a rollout: lane features from
    geometry.get_lane_pos2 on the blob's pose."""
    r = state_obs_run
    maps = load_map("loop_pedestrians").to("cpu")
    ours = tfe.obs_from_blob(r["cfg"], maps,
                             torch.from_numpy(r["blob_j"].copy())).numpy()
    assert ours.shape == (B, 11)
    assert (ours[:, 8] > 0.5).all()      # bank spawns start in the lane
    np.testing.assert_allclose(ours, r["obs0_j"], rtol=0, atol=OBS_ATOL)
