"""Imitation learning on the device: privileged expert -> demos -> BC.

Counterpart of dtown/learn/imitation.py. A lane-PD expert that reads the
lane features the simulator computes every step drives a batch of envs on
the step path (env.make_vec_env); the (observation, expert action) pairs
stay on the device, and a behavior-cloned student (state vector or camera
frames) trains by MSE regression on the expert's actions. DAgger then lets
the student drive while the expert labels every visited state.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from dtown_torch import env
from dtown_torch.device import resolve_device
from dtown_torch.learn import networks

# The lane-PD law proven stable closed-loop (a full lap): steer =
# 10*dist + 5*angle_rad at vel 0.55 (positive steer = left turn, dist > 0
# = right of the lane centre).
EXPERT_VEL = 0.55
EXPERT_KD = 10.0
EXPERT_KA = 5.0
_DEG2RAD = float(np.float32(np.pi / 180.0))


def expert_action(out) -> torch.Tensor:
    """The privileged expert's actions [B, 2] from a StepOutput's lane
    features."""
    steer = (EXPERT_KD * out.lane_dist
             + EXPERT_KA * (out.lane_angle_deg * _DEG2RAD))
    vel = torch.full_like(steer, EXPERT_VEL)
    return torch.stack([vel, torch.clamp(steer, -1.0, 1.0)], -1)


class BCPolicy(nn.Module):
    """Deterministic steering-prediction head (float32 Dense, lecun
    init) on the shared trunk."""

    def __init__(self, obs_shape, action_dim=2, trunk="nature", device=None,
                 generator=None):
        super().__init__()
        t = networks.add_trunk(self, trunk, obs_shape, device, generator)
        self.Dense_0 = networks.Dense(t.out_features, action_dim,
                                      torch.float32, device=device,
                                      generator=generator)

    def forward(self, obs):
        h = getattr(self, self.trunk_name)(obs)
        return self.Dense_0(h.to(torch.float32))


def _primed(cfg, maps, num_envs, generator, device):
    """A fresh batch after one coasting step (its lane features and first
    observation): (v_step, states, out)."""
    dev = resolve_device(device)
    v_reset, v_step = env.make_vec_env(cfg, maps, num_envs, device=dev)
    states = v_reset(generator)
    zeros = torch.zeros((num_envs, 2), device=dev)
    states, out = v_step(states, zeros)
    return v_step, states, out


def collect_demos(cfg, maps, num_envs: int, steps: int, generator,
                  device="cuda"):
    """Roll the expert for ``steps``: (obs [T, B, ...], act [T, B, 2]).
    The expert reads StepOutput's lane features, so the demos are camera
    frames or state vectors as cfg.obs_type says (RGB needs
    renderer="pallas"). ``generator`` draws the resets."""
    v_step, states, out = _primed(cfg, maps, num_envs, generator, device)
    obs, act = [], []
    with torch.no_grad():
        for _ in range(steps):
            a = expert_action(out)
            obs.append(out.obs)
            act.append(a)
            states, out = v_step(states, a)
    return torch.stack(obs), torch.stack(act)


class BCState(NamedTuple):
    net: nn.Module
    opt: torch.optim.Optimizer
    generator: torch.Generator


def bc_loss(net, obs, act):
    """Mean squared error of the policy's actions against the expert's."""
    return torch.mean(torch.square(net(obs) - act))


def make_bc(cfg, lr: float = 1e-3, batch_size: int = 1024,
            trunk: str = "nature", device="cuda"):
    """(init, train_epoch, policy): MSE behavior cloning with Adam.
    init(generator, example_obs) -> BCState (network draws and shuffles
    from ``generator``); train_epoch(bc, obs, act) -> (bc, mean loss) runs
    one pass over the flattened demos in shuffled minibatches;
    policy(net, obs) -> actions."""
    dev = resolve_device(device)

    def init(generator: torch.Generator, example_obs) -> BCState:
        net = BCPolicy(tuple(example_obs.shape[1:]), trunk=trunk,
                       device=dev, generator=generator)
        opt = torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999),
                               eps=1e-8)
        return BCState(net, opt, generator)

    def train_epoch(bc: BCState, obs, act):
        n = obs.shape[0] * obs.shape[1]
        obs_f, act_f = obs.flatten(0, 1), act.flatten(0, 1)
        perm = torch.randperm(n, generator=bc.generator, device=dev)
        nb = max(1, n // batch_size)
        losses = []
        for idx in perm[:nb * batch_size].reshape(nb, batch_size):
            loss = bc_loss(bc.net, obs_f[idx], act_f[idx])
            bc.opt.zero_grad()
            loss.backward()
            bc.opt.step()
            losses.append(loss.detach())
        return bc, torch.stack(losses).mean()

    def policy(net, obs):
        return net(obs)

    return init, train_epoch, policy


def eval_closed_loop(cfg, maps, net, policy, num_envs: int, steps: int,
                     generator, device="cuda"):
    """Drive the cloned policy: (survival fraction, mean reward), a crash
    being a done by collision or out of the lane."""
    v_step, states, out = _primed(cfg, maps, num_envs, generator, device)
    crashed = torch.zeros((num_envs,), dtype=torch.bool,
                          device=out.reward.device)
    rewards = []
    with torch.no_grad():
        for _ in range(steps):
            states, out = v_step(states, policy(net, out.obs))
            crashed = crashed | (out.done & out.collision) | (
                out.done & ~out.in_lane)
            rewards.append(out.reward)
    return 1.0 - crashed.to(torch.float32).mean(), torch.stack(
        rewards).mean()


def collect_dagger(cfg, maps, net, policy, num_envs: int, steps: int,
                   generator, beta: float = 0.0, device="cuda"):
    """DAgger rollout: the learner (the expert instead with probability
    ``beta`` at each step and env) drives, the expert labels every visited
    state. Returns (obs, act) shaped like collect_demos."""
    v_step, states, out = _primed(cfg, maps, num_envs, generator, device)
    obs, act = [], []
    with torch.no_grad():
        for _ in range(steps):
            label = expert_action(out)
            drive = policy(net, out.obs)
            if beta > 0.0:
                pick = torch.rand((num_envs, 1), generator=generator,
                                  device=label.device) < beta
                drive = torch.where(pick, label, drive)
            obs.append(out.obs)
            act.append(label)
            states, out = v_step(states, drive)
    return torch.stack(obs), torch.stack(act)


def dagger_rounds(cfg, maps, num_envs: int, steps: int, generator,
                  rounds: int = 3, epochs_per_round: int = 4,
                  lr: float = 1e-3, trunk: str = "nature",
                  beta0: float = 0.5, device="cuda"):
    """BC on expert demos, then ``rounds`` of learner-driven collection
    with expert labels, the dataset aggregated each round and beta halved.
    Returns (net, policy, the last epoch's loss of each round)."""
    init, train_epoch, policy = make_bc(cfg, lr=lr, trunk=trunk,
                                        device=device)
    obs, act = collect_demos(cfg, maps, num_envs, steps, generator, device)
    bc = init(generator, obs.flatten(0, 1))
    history = []
    beta = beta0
    for r in range(rounds + 1):
        if r:
            d_obs, d_act = collect_dagger(cfg, maps, bc.net, policy,
                                          num_envs, steps, generator,
                                          beta=beta, device=device)
            obs, act = torch.cat([obs, d_obs]), torch.cat([act, d_act])
            beta *= 0.5
        for _ in range(epochs_per_round):
            bc, loss = train_epoch(bc, obs, act)
        history.append(float(loss))
    return bc.net, policy, history
