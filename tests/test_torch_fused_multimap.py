"""The slice as a whole on the CPU: dtown_torch's fused rollout and fused
Nav rollout on stacked multimaps (the plain versions of the state step and
the blob render) against the JAX package's ``make_fused_rollout`` and
``make_fused_nav_rollout``, from one initial blob, through auto-resets
(max_steps=2): the blob after every step and the observations (frames,
state vectors, the Nav forms); ``obs_from_blob`` on a stack; a stack past
the blob render's budget renders through the XLA ray-caster."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dtown import map_loader as jmap_loader
from dtown import types as jtypes
from dtown.ops import fused_env as jfe

import dtown_torch
from dtown_torch import EnvConfig, load_map, make_fused_nav_rollout, \
    make_fused_rollout, stack_maps
from dtown_torch.convert import blob_from_numpy
from dtown_torch.ops import fused_env as tfe
from dtown_torch.learn import ppo as tppo
from dtown_torch.ops import state_kernel as sk
from dtown_torch.render import blob_raster as br

from test_torch_state_npc import check_rows

B, S, N_STEPS = 16, 32, 4
MEAN_BAR, SHARE_BAR = 1.0, 0.01   # test_torch_blob_render.py's bars
STACK = ["4way", "small_loop"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check_frames(ours, ref):
    ours, ref = ours.numpy().astype(int), np.asarray(ref).astype(int)
    assert ours.shape == ref.shape == (B, 3, S * S // 128, 128)
    diff = np.abs(ours - ref)
    assert diff.mean() < MEAN_BAR, diff.mean()
    assert (diff > 10).mean() < SHARE_BAR
    assert ours.std() > 5


def _drive(j_step, t_step, blob_j, seed, check_obs):
    """N_STEPS of both fused steps from one blob with the same actions."""
    blob_t = blob_from_numpy(np.asarray(blob_j), device="cpu")
    rng = np.random.default_rng(seed)
    n_done = 0
    for _ in range(N_STEPS):
        act = np.stack([rng.uniform(0.0, 1.0, B),
                        rng.uniform(-1.0, 1.0, B)], -1).astype(np.float32)
        blob_j, _, obs_j = j_step(blob_j, jnp.asarray(act))
        blob_t, out_t, obs_t = t_step(blob_t, torch.from_numpy(act))
        bj, bt = np.asarray(blob_j), blob_t.numpy()
        check_rows(bj, bt)
        np.testing.assert_array_equal(bt[sk.F_MAPID],
                                      np.arange(B) % len(STACK))
        np.testing.assert_array_equal(out_t.done.numpy(),
                                      bj[sk.F_DONE] > 0.5)
        check_obs(obs_t, obs_j)
        n_done += int(bj[sk.F_DONE].sum())
    assert n_done >= B


@pytest.mark.parametrize("obs_type", ["rgb", "state"])
def test_fused_rollout_on_stack_matches_reference(obs_type):
    kw = dict(camera_width=S, camera_height=S, obs_type=obs_type,
              max_steps=2)
    jcfg, cfg = jtypes.EnvConfig(**kw), EnvConfig(**kw)
    jmaps = jmap_loader.stack_maps(STACK)
    j_init, j_step, _ = jfe.make_fused_rollout(jcfg, jmaps, B)
    blob_j, states = j_init(jax.random.PRNGKey(5))
    step_j = jax.jit(lambda b, a: j_step(b, states, a))
    _, t_step, _ = make_fused_rollout(cfg, stack_maps(STACK), B,
                                      device="cpu")
    if obs_type == "rgb":
        check = _check_frames
    else:
        def check(ours, ref):
            assert ours.shape == (B, 11)
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                       rtol=0, atol=3e-4)
    _drive(step_j, t_step, blob_j, 3, check)


def test_fused_nav_rollout_on_stack_matches_reference():
    """Nav on the stack with state observations: goal rows and rewards
    through goal redraws at the resets."""
    cfg_kw = dict(obs_type="state", max_steps=2)
    jcfg, cfg = jtypes.EnvConfig(**cfg_kw), EnvConfig(**cfg_kw)
    jmaps = jmap_loader.stack_maps(STACK)
    j_init, j_step = jfe.make_fused_nav_rollout(jcfg, jmaps, B)
    blob_j, states = j_init(jax.random.PRNGKey(6))
    step_j = jax.jit(lambda b, a: j_step(b, states, a))
    _, t_step, _ = make_fused_nav_rollout(cfg, stack_maps(STACK), B,
                                          device="cpu")
    navb = sk.nav_base(0)

    def check(ours, ref):
        assert ours.shape == (B, 11)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                                   atol=3e-4)

    blob0 = np.asarray(blob_j)
    _drive(step_j, t_step, blob_j, 4, check)
    assert blob0.shape[0] == sk.nf_for(0, False, True)
    assert (blob0[navb:navb + 2] >= 0).all()


def test_fused_nav_rollout_goal_in_obs_matches_reference():
    """Nav with goal_in_obs on small_loop: camera observations are the
    (planes, goal[B, 3]) pair, state vectors 14 columns."""
    for obs_type in ("rgb", "state"):
        kw = dict(camera_width=S, camera_height=S, obs_type=obs_type,
                  max_steps=2)
        jcfg, cfg = jtypes.EnvConfig(**kw), EnvConfig(**kw)
        jmaps = jmap_loader.load_map("small_loop")
        j_init, j_step = jfe.make_fused_nav_rollout(jcfg, jmaps, B,
                                                    goal_in_obs=True)
        blob_j, states = j_init(jax.random.PRNGKey(7))
        step_j = jax.jit(lambda b, a: j_step(b, states, a))
        _, t_step, _ = make_fused_nav_rollout(
            cfg, load_map("small_loop"), B, goal_in_obs=True, device="cpu")
        act = np.tile(np.array([[0.6, 0.2]], np.float32), (B, 1))
        blob1_j, _, obs_j = step_j(blob_j, jnp.asarray(act))
        blob1_t, _, obs_t = t_step(
            blob_from_numpy(np.asarray(blob_j), device="cpu"),
            torch.from_numpy(act))
        check_rows(np.asarray(blob1_j), blob1_t.numpy())
        if obs_type == "rgb":
            planes, goal = obs_t
            _check_frames(planes, obs_j[0])
            np.testing.assert_allclose(goal.numpy(), np.asarray(obs_j[1]),
                                       rtol=0, atol=1e-5)
        else:
            assert obs_t.shape == (B, 14)
            np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j),
                                       rtol=0, atol=3e-4)


def test_obs_from_blob_on_stack_returns_planes():
    """The first observation of a stack's rollout goes through the blob
    render (planes), and state vectors take each env's own member."""
    cfg = EnvConfig(camera_width=S, camera_height=S)
    maps = stack_maps(["small_loop", "4way"])
    init_blob, fused_step, _ = make_fused_rollout(cfg, maps, B,
                                                  device="cpu")
    blob = init_blob(torch.Generator().manual_seed(0))
    obs = tfe.obs_from_blob(cfg, maps.to("cpu"), blob, fused_step.pack)
    assert obs.shape == (B, 3, S * S // 128, 128) and obs.dtype == torch.uint8
    assert float(obs.float().std()) > 5.0
    scfg = EnvConfig(obs_type="state")
    st = tfe.obs_from_blob(scfg, maps.to("cpu"), blob)
    assert st.shape == (B, 11) and (st[:, 8] > 0.5).all()


def test_stack_past_the_plan_budget_raises():
    """A stack past the blob render's budget has no render plan: the
    fused rollout renders it through the XLA ray-caster (frames
    [B, H, W, 3]) and fused RGB PPO refuses it, as the reference's does
    (tests/test_torch_fused_fallback.py compares the frames with dtown's);
    make_vec takes a stack, whose frames come from the ray-caster whatever
    the renderer."""
    maps = stack_maps(["udem1"] * 4)
    cfg = EnvConfig(camera_width=S, camera_height=S)
    assert br.build_render_plan(cfg, maps) is None
    init_blob, fused_step, _ = make_fused_rollout(cfg, maps, 8,
                                                  device="cpu")
    assert fused_step.pack["planless"]
    blob = init_blob(torch.Generator().manual_seed(0))
    _, _, obs = fused_step(blob, torch.zeros((8, 2)))
    assert obs.shape == (8, S, S, 3) and obs.dtype == torch.uint8
    with pytest.raises(NotImplementedError, match="budget"):
        tppo.make_ppo(cfg, maps, 8, tppo.PPOConfig(rollout_len=2),
                      fused=True, device="cpu")
    # state observations need no plan
    make_fused_rollout(EnvConfig(obs_type="state"), maps, 8, device="cpu")
    _, _, v_reset, v_step = dtown_torch.make_vec(
        ["small_loop", "udem1"], 8, device="cpu", renderer="pallas",
        camera_width=S, camera_height=S)
    assert v_step.pack is None
    _, out = v_step(v_reset(torch.Generator().manual_seed(0)),
                    torch.zeros((8, 2)))
    assert out.obs.shape == (8, S, S, 3)


def test_baseline5_stack_entry_points_run():
    """BASELINE config 5's maps: make_fused_rollout in RGB and state, and
    make_fused_nav_rollout with and without goal_in_obs, 48 envs; the Nav
    rollout's one step equals its fused_step's."""
    maps = stack_maps(["zigzag_dists", "4way", "udem1"])
    gen = torch.Generator().manual_seed(1)
    act = torch.rand((48, 2), generator=gen)
    for obs_type, want in (("rgb", (48, 3, 8, 128)), ("state", (48, 11))):
        cfg = EnvConfig(camera_width=S, camera_height=S, obs_type=obs_type)
        init_blob, fused_step, rollout = make_fused_rollout(cfg, maps, 48,
                                                            device="cpu")
        blob, rsum, _ = rollout(init_blob(gen), act, 2)
        _, _, obs = fused_step(blob, act)
        assert tuple(obs.shape) == want and torch.isfinite(rsum)
        for goal_in_obs in (False, True):
            init_blob, fused_step, rollout = make_fused_nav_rollout(
                cfg, maps, 48, goal_in_obs=goal_in_obs, device="cpu")
            blob0 = init_blob(gen)
            blob, out, obs = fused_step(blob0, act)
            if goal_in_obs and obs_type == "rgb":
                assert tuple(obs[0].shape) == want
                assert tuple(obs[1].shape) == (48, 3)
            else:
                assert obs.shape[-1] == (
                    want[-1] + 3 if goal_in_obs else want[-1])
            assert torch.isfinite(blob).all()
            blob_r, rsum, osum = rollout(blob0, act, 1)
            assert torch.equal(blob_r, blob)
            assert torch.equal(rsum, out.reward.sum())
            if obs_type == "rgb":
                planes = obs[0] if goal_in_obs else obs
                assert int(osum) == int(planes[:, 0, 0, :].sum())
            else:
                assert int(osum) == int(obs.sum().to(torch.int32))
