"""The step-path learners of dtown_torch.learn against dtown.learn: one
non-fused PPO iteration on the reference's draws, the recurrent learner's
replay and carry resets (as tests/test_ppo_rnn.py), and imitation's
expert and behavior-cloning loss (as tests/test_imitation.py)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dtown import map_loader as jmap_loader
from dtown import types as jtypes
from dtown.learn import imitation as jim
from dtown.learn import ppo as jppo

from dtown_torch import EnvConfig, load_map
from dtown_torch.convert import env_states_from_numpy, params_from_flax
from dtown_torch.learn import imitation as tim
from dtown_torch.learn import ppo as tppo
from dtown_torch.learn.networks import ActorCritic
from dtown_torch.learn.ppo_rnn import _reset_carry, make_ppo_rnn
from dtown_torch.types import StepOutput
from test_torch_ppo_fused import _key_chain


def test_step_path_iteration_matches_reference():
    """make_ppo(fused=False) on small_loop state observations, 16 envs,
    rollout 4, 2 epochs x 2 minibatches, from the reference's states and
    parameters with its key-chain draws. No env ends its episode in these
    4 steps (asserted), so no reset draw is compared (the two draw resets
    from different generators). Bars: poses 1e-4, mean reward 1e-4, loss
    1e-2 relative; each parameter's update within cosine 0.99 of the
    reference's (bf16 trunk on both sides; measured >= 0.998)."""
    B, T = 16, 4
    hp = dict(rollout_len=T, epochs=2, minibatches=2)
    j_init, j_train = jppo.make_ppo(jtypes.EnvConfig(obs_type="state"),
                                    jmap_loader.load_map("small_loop"), B,
                                    jppo.PPOConfig(**hp))
    ts_j = j_init(jax.random.PRNGKey(0))
    ts_j2, m_j = jax.jit(j_train)(ts_j)
    assert float(m_j["done_frac"]) == 0.0

    ppo = tppo.PPOConfig(**hp)
    init, train = tppo.make_ppo(EnvConfig(obs_type="state"),
                                load_map("small_loop"), B, ppo, device="cpu")
    ts = init(torch.Generator().manual_seed(0))
    net = params_from_flax(jax.tree_util.tree_map(np.asarray, ts_j.params),
                           ActorCritic((11,)))
    start = {k: v.clone() for k, v in net.state_dict().items()}
    ts = ts._replace(net=net, opt=tppo.make_optimizer(net, ppo),
                     env_states=env_states_from_numpy(ts_j.env_states,
                                                      device="cpu"))
    noise, perms = _key_chain(ts_j.key, T, B, hp["epochs"])
    ts, traj, last_value = train.rollout(ts, noise)
    adv, ret = train.gae(traj, last_value)
    ts, losses = train.update(ts, traj, adv, ret, perms)

    np.testing.assert_allclose(ts.env_states.pos.numpy(),
                               np.asarray(ts_j2.env_states.pos), rtol=0,
                               atol=1e-4)
    assert not traj["done"].any()
    assert abs(float(traj["reward"].mean()) - float(m_j["mean_reward"])) \
        <= 1e-4
    assert abs(float(losses.mean()) - float(m_j["loss"])) <= \
        1e-2 * abs(float(m_j["loss"])) + 1e-4
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, ts_j2.params),
                            ActorCritic((11,))).state_dict()
    for k, got in ts.net.state_dict().items():
        a, b = (got - start[k]).flatten(), (want[k] - start[k]).flatten()
        assert float(a @ b) >= 0.99 * float(a.norm() * b.norm()), k


def test_step_path_refusals():
    cfg = EnvConfig(camera_width=32, camera_height=32)  # renderer="xla"
    with pytest.raises(NotImplementedError, match="renderer"):
        tppo.make_ppo(cfg, load_map("small_loop"), 8, device="cpu")
    with pytest.raises(NotImplementedError, match="sharded"):
        _, train = tppo.make_ppo(EnvConfig(obs_type="state"),
                                 load_map("small_loop"), 8, device="cpu")
        train(None, axis_name="envs")


def test_rnn_replay_reproduces_rollout_logp():
    """As tests/test_ppo_rnn.py::test_rnn_replay_reproduces_rollout_logp:
    with lr = 0 the update's replay from the rollout-start carry, with the
    rollout's done-gated resets, recomputes the rollout's logp, so
    mean_ratio is 1 within 1e-5. loop_obstacles ends episodes in these 16
    steps, so the resets are exercised (asserted)."""
    cfg = EnvConfig(obs_type="state")
    ppo = tppo.PPOConfig(rollout_len=16, lr=0.0, epochs=2, minibatches=4)
    init, train = make_ppo_rnn(cfg, load_map("loop_obstacles"), 32, ppo,
                               device="cpu")
    ts = init(torch.Generator().manual_seed(0))
    ts, metrics = train(ts)
    assert float(metrics["done_frac"]) > 0.0
    assert set(metrics) == {"loss", "mean_reward", "done_frac", "mean_ratio"}
    np.testing.assert_allclose(float(metrics["mean_ratio"]), 1.0, atol=1e-5)
    assert all(c.shape == (32, 128) for c in ts.carry)


def test_rnn_carry_resets_on_done():
    """As tests/test_ppo_rnn.py::test_rnn_carry_resets_on_done."""
    c = (torch.ones((4, 8)), 2.0 * torch.ones((4, 8)))
    done = torch.tensor([True, False, True, False])
    r = _reset_carry(c, done)
    assert float(r[0][0].sum()) == 0 and float(r[0][1].sum()) == 8
    assert float(r[1][2].sum()) == 0 and float(r[1][3].sum()) == 16


def test_rnn_rejects_env_count_not_divisible():
    with pytest.raises(ValueError, match="divide"):
        make_ppo_rnn(EnvConfig(obs_type="state"), load_map("small_loop"), 6,
                     tppo.PPOConfig(minibatches=4), device="cpu")


def test_expert_action_matches_reference():
    """The lane-PD expert on lane features that saturate the steering
    both ways: equal within 1e-6."""
    rng = np.random.default_rng(0)
    dist = (rng.standard_normal(64) * 0.2).astype(np.float32)
    deg = (rng.standard_normal(64) * 30.0).astype(np.float32)
    z = np.zeros(64, np.float32)
    want = np.asarray(jim.expert_action(jtypes.StepOutput(
        obs=None, reward=z, done=z, lane_dist=jnp.asarray(dist),
        lane_dot_dir=z, lane_angle_deg=jnp.asarray(deg), in_lane=z,
        collision=z, timestamp=z)))
    t = lambda a: torch.from_numpy(a)
    got = tim.expert_action(StepOutput(
        obs=None, reward=t(z), done=t(z), lane_dist=t(dist),
        lane_dot_dir=t(z), lane_angle_deg=t(deg), in_lane=t(z),
        collision=t(z), timestamp=t(z))).numpy()
    assert np.abs(want[:, 1]).max() == 1.0   # clipped both ways
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["state", "rgb"])
def test_bc_loss_and_grads_match_jax(kind):
    """BCPolicy's MSE against the expert's actions and its gradients, with
    flax's parameters: loss within 1e-4 relative; gradients in norm within
    1e-3 for the float32 head, 2% for bf16 kernels and 8% for bf16 biases
    (tests/test_torch_ppo_math.py gives the reasons)."""
    rng = np.random.default_rng(1)
    obs = (rng.standard_normal((32, 11)).astype(np.float32) if kind == "state"
           else rng.integers(0, 256, (32, 32, 32, 3), dtype=np.uint8))
    act = rng.standard_normal((32, 2)).astype(np.float32)
    net = jim.BCPolicy()
    params = net.init(jax.random.PRNGKey(0), jnp.asarray(obs[:1]))
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jnp.mean(jnp.square(net.apply(p, jnp.asarray(obs))
                                      - jnp.asarray(act))))(params)
    port = params_from_flax(jax.tree_util.tree_map(np.asarray, params),
                            tim.BCPolicy(obs.shape[1:]))
    loss = tim.bc_loss(port, torch.from_numpy(obs), torch.from_numpy(act))
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= 1e-4 * float(loss_j)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, grads_j),
                            tim.BCPolicy(obs.shape[1:]))
    for (name, p), (_, g) in zip(port.named_parameters(),
                                 want.named_parameters()):
        g = g.detach()
        bar = (1e-3 if name.startswith("Dense_0.")
               else 0.08 if name.endswith("bias") else 0.02)
        assert float((p.grad - g).norm()) <= bar * float(g.norm()) + 1e-7, \
            name


def test_imitation_pipeline_state():
    """Demos of the expert (sane actions), BC lowers its loss, the clone
    is evaluated closed-loop, and a DAgger round aggregates its data."""
    cfg = EnvConfig(obs_type="state")
    maps = load_map("small_loop")
    gen = torch.Generator().manual_seed(0)
    obs, act = tim.collect_demos(cfg, maps, 16, 16, gen, device="cpu")
    assert obs.shape == (16, 16, 11) and act.shape == (16, 16, 2)
    assert torch.all(act[..., 0] == tim.EXPERT_VEL)
    assert float(act[..., 1].abs().max()) <= 1.0
    init, train_epoch, policy = tim.make_bc(cfg, lr=1e-3, batch_size=64,
                                            device="cpu")
    bc = init(gen, obs[0])
    losses = []
    for _ in range(4):
        bc, loss = train_epoch(bc, obs, act)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
    surv, mean_r = tim.eval_closed_loop(cfg, maps, bc.net, policy, 8, 8, gen,
                                        device="cpu")
    assert 0.0 <= float(surv) <= 1.0 and np.isfinite(float(mean_r))
    d_obs, d_act = tim.collect_dagger(cfg, maps, bc.net, policy, 8, 4, gen,
                                      beta=0.5, device="cpu")
    assert d_obs.shape == (4, 8, 11) and d_act.shape == (4, 8, 2)
    # make_bc's default minibatch of 1024 needs 64 envs x 16 steps
    net, _, history = tim.dagger_rounds(cfg, maps, 64, 16, gen, rounds=1,
                                        epochs_per_round=1, device="cpu")
    assert len(history) == 2 and all(np.isfinite(history))


def test_imitation_rgb_demos():
    """As tests/test_imitation.py::test_bc_rgb_pipeline_shapes, through
    the row-fed render: camera demos, one BC epoch, frames -> actions."""
    cfg = EnvConfig(camera_width=32, camera_height=32, renderer="pallas")
    gen = torch.Generator().manual_seed(1)
    obs, act = tim.collect_demos(cfg, load_map("small_loop"), 8, 4, gen,
                                 device="cpu")
    assert obs.shape == (4, 8, 32, 32, 3) and obs.dtype == torch.uint8
    init, train_epoch, policy = tim.make_bc(cfg, batch_size=16, device="cpu")
    bc = init(gen, obs[0])
    bc, loss = train_epoch(bc, obs, act)
    assert np.isfinite(float(loss))
    assert policy(bc.net, obs[0]).shape == (8, 2)


@pytest.mark.slow
def test_ppo_learns_small_loop_state():
    """As tests/test_learning.py::test_ppo_learns_small_loop_state (slow
    there too): 30 iterations of state-obs PPO on small_loop, 128 envs,
    rollout 32; the tail's mean reward beats the head's by more than 1.0
    and the crash rate falls (about 30 s on the CPU)."""
    init, train = tppo.make_ppo(EnvConfig(obs_type="state"),
                                load_map("small_loop"), 128,
                                tppo.PPOConfig(rollout_len=32), device="cpu")
    ts = init(torch.Generator().manual_seed(0))
    hist = []
    for _ in range(30):
        ts, metrics = train(ts)
        hist.append((float(metrics["mean_reward"]),
                     float(metrics["done_frac"])))
    head, tail = np.mean(hist[:5], 0), np.mean(hist[-5:], 0)
    assert tail[0] > head[0] + 1.0, (head, tail)
    assert tail[1] < head[1], (head, tail)
