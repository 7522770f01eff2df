"""Recurrent PPO: an LSTM policy with a per-env hidden state.

Counterpart of dtown/learn/ppo_rnn.py. Same algorithm as learn/ppo.py with
ActorCriticRNN: the LSTM carry lives in the train state and is reset at
episode ends during the rollout, and the update replays each env's
sequence from the carry it had when the rollout started (minibatches
partition the env axis, so backpropagation through time runs over each
env's real transitions). On the step path (env.make_vec_env), like the
reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dtown_torch import env
from dtown_torch.device import resolve_device
from dtown_torch.learn import ppo as P
from dtown_torch.learn.networks import ActorCriticRNN


class RNNTrainState(NamedTuple):
    net: torch.nn.Module
    opt: torch.optim.Optimizer
    env_states: object
    generator: torch.Generator
    carry: tuple  # the LSTM's (c, h), each [B, hidden]


def _reset_carry(carry, done):
    """Zero the hidden state of the envs whose episode just ended."""
    return tuple(torch.where(done[:, None], torch.zeros_like(c), c)
                 for c in carry)


def rnn_loss(net, seq, carry0, ppo: P.PPOConfig):
    """(loss, ratio) of one env group, replayed in order: seq holds obs,
    action, logp, adv, ret and done as [T, Bm, ...]; carry0 is the group's
    carry at the rollout's start. The replay applies the rollout's
    done-gated resets, so with unchanged parameters it recomputes the
    rollout's logp and value."""
    carry, logps, values = carry0, [], []
    for t in range(seq["done"].shape[0]):
        mean, log_std, value, carry = net(seq["obs"][t], carry)
        logps.append(P.log_prob(seq["action"][t], mean, log_std))
        values.append(value)
        carry = _reset_carry(carry, seq["done"][t])
    ratio, pg = P.surrogate(torch.stack(logps), seq, ppo)
    v_loss = 0.5 * ((torch.stack(values) - seq["ret"]) ** 2).mean()
    loss = pg + ppo.vf_coef * v_loss - ppo.ent_coef * P.entropy(net.log_std)
    return loss, ratio


def make_ppo_rnn(cfg, maps, num_envs: int, ppo: P.PPOConfig = P.PPOConfig(),
                 hidden: int = 128, device="cuda"):
    """(init, train_step) of the recurrent learner on ``device`` (the card
    unless ``device="cpu"``). init(generator) -> RNNTrainState;
    train_step(ts) -> (ts, metrics); metrics add mean_ratio, which is 1
    exactly when the replay reproduces the rollout's logp (lr = 0). The
    pieces hang on train_step: rollout(ts, noise) -> (ts, traj,
    last_value, carry0), .gae, update(ts, traj, adv, ret, carry0, perms)
    with perms [epochs, num_envs]."""
    if num_envs % ppo.minibatches:
        raise ValueError(f"num_envs={num_envs} must divide into "
                         f"ppo.minibatches={ppo.minibatches} env groups")
    dev = resolve_device(device)
    v_reset, v_step = env.make_vec_env(cfg, maps, num_envs, device=dev)

    def render(states):
        return env.render_obs_batch(cfg, v_step.maps, states,
                                    pack=v_step.pack)

    def init(generator: torch.Generator) -> RNNTrainState:
        states = v_reset(generator)
        net = ActorCriticRNN(P.obs_shape(render(states)), trunk=ppo.trunk,
                             hidden=hidden, device=dev, generator=generator)
        return RNNTrainState(net, P.make_optimizer(net, ppo), states,
                             generator, net.initial_carry(num_envs))

    def rollout(ts: RNNTrainState, noise):
        T, B = noise.shape[:2]
        states, carry = ts.env_states, ts.carry
        obs = render(states)
        steps = []
        with torch.no_grad():
            for t in range(T):
                mean, log_std, value, carry = ts.net(obs, carry)
                action = mean + torch.exp(log_std) * noise[t]
                logp = P.log_prob(action, mean, log_std)
                states, out = v_step(states, torch.tanh(action))
                carry = _reset_carry(carry, out.done)
                steps.append(dict(obs=obs, action=action, logp=logp,
                                  value=value, reward=out.reward,
                                  done=out.done))
                obs = out.obs
            last_value = ts.net(obs, carry)[2]
        traj = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
        return (ts._replace(env_states=states, carry=carry), traj,
                last_value, ts.carry)

    def update(ts: RNNTrainState, traj, advantages, returns, carry0, perms):
        group = num_envs // ppo.minibatches
        data = dict(traj, adv=advantages, ret=returns)
        params = list(ts.net.parameters())
        losses, ratios = [], []
        for perm in perms:
            for m in range(ppo.minibatches):
                idx = perm[m * group:(m + 1) * group]
                seq = {k: v[:, idx] for k, v in data.items()}
                loss, ratio = rnn_loss(ts.net, seq,
                                       tuple(c[idx] for c in carry0), ppo)
                ts.opt.zero_grad()
                loss.backward()
                P.clip_by_global_norm_(params, ppo.max_grad_norm)
                ts.opt.step()
                losses.append(loss.detach())
                ratios.append(ratio.detach().mean())
        E = len(perms)
        return (ts, torch.stack(losses).reshape(E, -1).mean(1),
                torch.stack(ratios).reshape(E, -1).mean(1))

    gae_fn = lambda traj, last_value: P.gae(traj, last_value, ppo)

    def train_step(ts: RNNTrainState, axis_name=None):
        P.refuse_sharding(axis_name)
        noise = torch.randn((ppo.rollout_len, num_envs, 2),
                            generator=ts.generator, device=dev)
        perms = torch.stack([torch.randperm(num_envs, generator=ts.generator,
                                            device=dev)
                             for _ in range(ppo.epochs)])
        ts, traj, last_value, carry0 = rollout(ts, noise)
        adv, ret = gae_fn(traj, last_value)
        ts, losses, ratios = update(ts, traj, adv, ret, carry0, perms)
        return ts, dict(loss=losses.mean(),
                        mean_reward=traj["reward"].mean(),
                        done_frac=traj["done"].to(torch.float32).mean(),
                        mean_ratio=ratios.mean())

    train_step.rollout, train_step.gae, train_step.update = \
        rollout, gae_fn, update
    return init, train_step
