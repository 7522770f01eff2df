"""Fused PPO on the port (dtown_torch.learn.make_ppo(..., fused=True))
against dtown.learn.ppo.make_ppo(..., fused=True): one whole iteration
from the same parameters, blob and first observation, with the reference's
key-chain draws fed to the port's rollout and update; then the port's own
runs on a stack in state mode, with Nav, and its refusals."""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from dtown import map_loader as jmap_loader
from dtown import types as jtypes
from dtown.learn import ppo as jppo
from dtown.ops.fused_env import make_fused_rollout as j_make_fused_rollout

from dtown_torch import EnvConfig, load_map, make_fused_rollout, stack_maps
from dtown_torch.convert import blob_from_numpy, params_from_flax
from dtown_torch.learn import ppo as tppo
from dtown_torch.learn.networks import ActorCritic
from dtown_torch.ops import fused_env as fe
from dtown_torch.ops import state_kernel as sk

DISCRETE = (sk.F_DONE, sk.F_STEP, sk.F_RNG, sk.F_COLL, sk.F_INLANE,
            sk.F_ENVID)


def _key_chain(key, T, B, epochs):
    """The reference fused train_step's draws: per rollout step
    key, k_act = split(key) and normal(k_act, (B, 2)); per epoch
    key, kp = split(key) and permutation(kp, T * B)."""
    noise, perms = [], []
    for _ in range(T):
        key, k_act = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(k_act, (B, 2))))
    for _ in range(epochs):
        key, kp = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(kp, T * B)))
    return torch.from_numpy(np.stack(noise)), torch.from_numpy(
        np.stack(perms)).long()


def test_fused_iteration_matches_reference():
    """loop_obstacles, 16 envs, 32x32 RGB, rollout 4, 2 epochs x 2
    minibatches. Bars: the blob after the rollout (discrete rows equal,
    pose 1e-4, reward 1e-3: the policy's bf16 mean moves the actions by
    ~1e-5); mean reward 1e-4 and done fraction equal; loss 1e-2 relative;
    each parameter's update within cosine 0.9 of the reference's (the
    frames of steps 1-3 come from the two renderers, which differ by a
    count on a few pixels, and Adam's first steps turn any such difference
    in a small gradient into a +-lr step; measured >= 0.95)."""
    B, T, S = 16, 4, 32
    jcfg = jtypes.EnvConfig(camera_width=S, camera_height=S)
    cfg = EnvConfig(camera_width=S, camera_height=S)
    jmaps = jmap_loader.load_map("loop_obstacles")
    maps = load_map("loop_obstacles")
    hp = dict(rollout_len=T, epochs=2, minibatches=2)
    _, j_train = jppo.make_ppo(jcfg, jmaps, B, jppo.PPOConfig(**hp),
                               fused=True)
    j_init_blob, _, _ = j_make_fused_rollout(jcfg, jmaps, B)
    blob_j, _ = j_init_blob(jax.random.PRNGKey(0))
    # the first observation from the port's render, so both start equal
    blob = blob_from_numpy(np.asarray(blob_j), device="cpu")
    _, fs, _ = make_fused_rollout(cfg, maps, B, device="cpu")
    planes0 = fe.obs_from_blob(cfg, maps.to("cpu"), blob, fs.pack)
    nhwc0 = tppo.planes_view(cfg)(planes0).numpy()
    net_j = jppo.ActorCritic()
    params = net_j.init(jax.random.PRNGKey(1), jnp.asarray(nhwc0[:2]))
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(1e-3))
    key = jax.random.PRNGKey(2)
    ts_j, m_j = jax.jit(j_train)(jppo.TrainState(
        params, tx.init(params), (blob_j, jnp.asarray(nhwc0)), key))

    ppo = tppo.PPOConfig(**hp)
    _, train = tppo.make_ppo(cfg, maps, B, ppo, fused=True, device="cpu")
    net = params_from_flax(jax.tree_util.tree_map(np.asarray, params),
                           ActorCritic((S, S, 3)))
    start = {k: v.clone() for k, v in net.state_dict().items()}
    ts = tppo.TrainState(net, tppo.make_optimizer(net, ppo),
                         (blob, planes0), torch.Generator())
    noise, perms = _key_chain(key, T, B, hp["epochs"])
    ts, traj, last_value = train.rollout(ts, noise)
    adv, ret = train.gae(traj, last_value)
    ts, losses = train.update(ts, traj, adv, ret, perms)

    bj, bt = np.asarray(ts_j.env_states[0]), ts.env_states[0].numpy()
    for f in DISCRETE:
        np.testing.assert_array_equal(bt[f], bj[f], err_msg=str(f))
    np.testing.assert_allclose(bt[:4], bj[:4], rtol=0, atol=1e-4)
    np.testing.assert_allclose(bt[sk.F_REWARD], bj[sk.F_REWARD], rtol=0,
                               atol=1e-3)
    assert abs(float(traj["reward"].mean()) - float(m_j["mean_reward"])) \
        <= 1e-4
    assert float(traj["done"].float().mean()) == float(m_j["done_frac"])
    assert abs(float(losses.mean()) - float(m_j["loss"])) <= \
        1e-2 * abs(float(m_j["loss"])) + 1e-4
    last_j = np.asarray(ts_j.env_states[1]).astype(int)
    last_t = tppo.planes_view(cfg)(ts.env_states[1]).numpy().astype(int)
    assert last_t.shape == last_j.shape == (B, S, S, 3)
    assert np.abs(last_t - last_j).mean() < 1.0
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, ts_j.params),
                            ActorCritic((S, S, 3))).state_dict()
    for k, got in ts.net.state_dict().items():
        a, b = (got - start[k]).flatten(), (want[k] - start[k]).flatten()
        assert float(b.norm()) > 0, k
        assert float(a @ b) >= 0.9 * float(a.norm() * b.norm()), k


MAPS = ["zigzag_dists", "4way", "small_loop"]


def test_fused_ppo_on_stack_state():
    """As tests/test_fused_multimap.py::test_fused_ppo_on_stack: fused PPO
    trains on a stack in state mode, finite metrics, every env still on
    its member of the stack."""
    cfg = EnvConfig(obs_type="state")
    init, train = tppo.make_ppo(cfg, stack_maps(MAPS), 24,
                                tppo.PPOConfig(rollout_len=8), fused=True,
                                device="cpu")
    ts = init(torch.Generator().manual_seed(0))
    for _ in range(2):
        ts, metrics = train(ts)
    assert set(metrics) == {"loss", "mean_reward", "done_frac"}
    assert all(np.isfinite(float(v)) for v in metrics.values())
    blob, obs = ts.env_states
    np.testing.assert_array_equal(blob[sk.F_MAPID].numpy().astype(int),
                                  np.arange(24) % 3)
    assert obs.shape == (24, 11)


def test_fused_rgb_ppo_refuses_beyond_plan_budget():
    """As tests/test_fused_multimap.py:267-277: a stack past the blob
    render's budget is refused, naming PPO."""
    cfg = EnvConfig(camera_width=64, camera_height=64)
    with pytest.raises(NotImplementedError, match="fused PPO"):
        tppo.make_ppo(cfg, stack_maps(["udem1"] * 4), 8,
                      tppo.PPOConfig(rollout_len=2), fused=True,
                      device="cpu")


@pytest.mark.parametrize("obs_type", ["rgb", "state"])
def test_fused_nav_goal_in_obs(obs_type):
    """Nav with the goal in the observation: (frames, goal) pairs or
    14-wide state vectors, the (image, vec) network, and goal_frac."""
    cfg = EnvConfig(obs_type=obs_type, camera_width=32, camera_height=32)
    init, train = tppo.make_ppo(cfg, stack_maps(MAPS), 16,
                                tppo.PPOConfig(rollout_len=4, epochs=2,
                                               minibatches=2),
                                fused=True, nav=True, goal_in_obs=True,
                                device="cpu")
    ts = init(torch.Generator().manual_seed(1))
    ts, metrics = train(ts)
    assert set(metrics) == {"loss", "mean_reward", "done_frac", "goal_frac"}
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert 0.0 <= float(metrics["goal_frac"]) <= float(metrics["done_frac"])
    _, obs = ts.env_states
    if obs_type == "rgb":
        planes, goal = obs
        assert planes.shape == (16, 3, 8, 128) and goal.shape == (16, 3)
        assert ts.net.pair
    else:
        assert obs.shape == (16, 14)


def test_nav_needs_fused_and_cuda_is_the_default():
    cfg = EnvConfig(obs_type="state")
    with pytest.raises(NotImplementedError, match="fused"):
        tppo.make_ppo(cfg, load_map("small_loop"), 8, nav=True,
                      device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tppo.make_ppo(cfg, load_map("small_loop"), 8, fused=True)
