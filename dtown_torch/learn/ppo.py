"""PPO on the port: rollout -> GAE -> clipped-surrogate update.

Counterpart of dtown/learn/ppo.py. The rollout collects ``rollout_len``
transitions of every env on the device (observations never reach the
host), GAE runs backwards over them, and the update takes ``epochs``
passes over the flattened T*B transitions in ``minibatches`` shuffled
minibatches, each a clipped-surrogate step through global-norm clipping
and Adam. Two rollouts feed the same update:

- ``fused=True`` (the main path): the fused rollout's state blob, one state
  kernel and one blob render launch a step (ops/fused_env.py);
- ``fused=False``: the vectorized step path (env.make_vec_env: batched
  physics and the row-fed render kernels, ``renderer="pallas"``).

One iteration is

    train_step(ts) = rollout(ts, noise) -> gae(traj, last_value)
                     -> update(ts, traj, advantages, returns, perms)

where train_step draws the policy noise [T, B, 2] and one permutation of
the T*B transitions per epoch from ``ts.generator``. The three pieces hang
on train_step (``train_step.rollout``, ``.gae``, ``.update``), so a test
can feed them the reference's draws.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from dtown_torch.device import resolve_device
from dtown_torch.learn.networks import ActorCritic
from dtown_torch.utils.profiling import count, span


class PPOConfig(NamedTuple):
    """The reference's PPO hyperparameters and defaults (their choice is
    argued in dtown/learn/ppo.py)."""
    rollout_len: int = 128
    lr: float = 1e-3
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    epochs: int = 4
    minibatches: int = 8
    max_grad_norm: float = 0.5
    # rewards are scaled before GAE so the -1000 crash does not dominate
    # the value loss (metrics report raw rewards)
    reward_scale: float = 0.02
    trunk: str = "nature"


class TrainState(NamedTuple):
    """The learner's state: ``net`` holds the float32 parameters, ``opt``
    their Adam moments; ``env_states`` is (blob, last observation as the
    rollout emits it) on the fused path, the batched EnvState on the step
    path; ``generator`` (on the device) draws the policy noise, the
    minibatch permutations and, on the step path, the auto-resets."""
    net: torch.nn.Module
    opt: torch.optim.Optimizer
    env_states: object
    generator: torch.Generator


# the reference's f32 constants: log(2 pi) and the Gaussian's entropy term
LOG_2PI = float(np.log(np.float32(2.0 * np.pi)))
HALF_LOG_2PIE = 0.5 * float(np.log(np.float32(2.0 * np.pi * np.e)))


def make_optimizer(net, ppo: PPOConfig):
    """optax.adam(lr): torch's Adam has the same moments, bias correction
    and eps outside the square root, in another operation order. The
    reference's chain clips first: call clip_by_global_norm_ before
    step()."""
    return torch.optim.Adam(net.parameters(), lr=ppo.lr, betas=(0.9, 0.999),
                            eps=1e-8)


def clip_by_global_norm_(params, max_norm: float):
    """optax.clip_by_global_norm on the parameters' gradients, in place:
    when the global norm g reaches max_norm each gradient becomes
    grad / g * max_norm (torch's clip_grad_norm_ divides by g + 1e-6 and
    always scales). No host sync. Returns g."""
    grads = [p.grad for p in params if p.grad is not None]
    g = torch.sqrt(sum((x * x).sum() for x in grads))
    keep = g < max_norm
    for x in grads:
        x.copy_(torch.where(keep, x, x / g * max_norm))
    return g


def pmean_grads_(params, group):
    """jax.lax.pmean of the parameters' gradients over the ranks of
    ``group`` (a torch.distributed process group), in place: one
    all_reduce (a sum) of the flattened gradients, then a division by the
    world size. Every rank ends with the same bits. The span
    ``ppo.allreduce`` times the exchange and the division on the device
    (the wait for the slowest rank included); the counters
    ``allreduce_calls`` and ``allreduce_bytes`` count the calls and the
    flattened gradients' bytes."""
    if not dist.is_initialized():
        raise RuntimeError("sharded training needs an initialised "
                           "torch.distributed process group "
                           "(parallel.make_mesh)")
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    count("allreduce_calls")
    count("allreduce_bytes", flat.numel() * flat.element_size())
    with span("ppo.allreduce", flat.device):
        dist.all_reduce(flat, group=group)
        flat = flat / dist.get_world_size(group)
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view_as(g))
        i += g.numel()


def log_prob(action, mean, log_std):
    """Gaussian log-density of [B, A] actions, summed over A."""
    std = torch.exp(log_std)
    return -0.5 * (((action - mean) / std) ** 2 + 2.0 * log_std
                   + LOG_2PI).sum(-1)


def entropy(log_std):
    """The diagonal Gaussian's entropy, summed over the action dims."""
    return (log_std + HALF_LOG_2PIE).sum()


def gae(traj, last_value, ppo: PPOConfig):
    """Generalized advantage estimates and returns, each [T, B], of a
    trajectory's reward, done and value [T, B] and the value [B] of the
    observation after it; rewards scaled by ppo.reward_scale."""
    with span("ppo.gae"):
        adv = torch.empty_like(traj["value"])
        acc = torch.zeros_like(last_value)
        next_value = last_value
        for t in reversed(range(adv.shape[0])):
            live = 1.0 - traj["done"][t].to(torch.float32)
            delta = (traj["reward"][t] * ppo.reward_scale
                     + ppo.gamma * next_value * live - traj["value"][t])
            acc = delta + ppo.gamma * ppo.gae_lambda * live * acc
            adv[t] = acc
            next_value = traj["value"][t]
        return adv, adv + traj["value"]


def surrogate(logp, batch, ppo: PPOConfig):
    """(ratio, clipped-surrogate policy loss) of new log-probs against a
    batch's old ``logp`` and its ``adv``, the advantages normalised with
    the population std (jnp.std's)."""
    ratio = torch.exp(logp - batch["logp"])
    adv = batch["adv"]
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg = -torch.minimum(
        ratio * adv,
        torch.clamp(ratio, 1 - ppo.clip_eps, 1 + ppo.clip_eps) * adv).mean()
    return ratio, pg


def ppo_loss(net, batch, ppo: PPOConfig):
    """(loss, ratio) of a minibatch: obs (the network's input), action,
    logp, adv and ret."""
    mean, log_std, value = net(batch["obs"])
    ratio, pg = surrogate(log_prob(batch["action"], mean, log_std), batch,
                          ppo)
    v_loss = 0.5 * ((value - batch["ret"]) ** 2).mean()
    return pg + ppo.vf_coef * v_loss - ppo.ent_coef * entropy(log_std), ratio


def tmap(fn, *xs):
    """fn over tensors, or over the members of tuples of tensors (the
    (image, goal) observation)."""
    if isinstance(xs[0], tuple):
        return tuple(fn(*a) for a in zip(*xs))
    return fn(*xs)


def obs_shape(obs):
    """The per-env shape of a batched observation (a pair for tuples)."""
    return tmap(lambda o: tuple(o.shape[1:]), obs)


def collect(net, noise, env_states, obs, step, obs_from):
    """The rollout loop: T = len(noise) policy steps from ``env_states``
    and the raw observation ``obs`` of it. step(env_states, actions) ->
    (env_states, StepOutput, raw obs) takes the tanh'd actions;
    obs_from(raw) is the network's input. Returns (traj, env_states, raw
    obs, last_value); traj holds obs (raw, [T, B, ...], written in place),
    action, logp, value, reward [T, B] and done (bool [T, B])."""
    T, B = noise.shape[:2]
    dev = noise.device
    f32 = dict(dtype=torch.float32, device=dev)
    with span("ppo.rollout"), torch.no_grad():
        traj = dict(
            obs=tmap(lambda o: torch.empty((T,) + tuple(o.shape),
                                           dtype=o.dtype, device=o.device),
                     obs),
            action=torch.empty((T, B, noise.shape[2]), **f32),
            logp=torch.empty((T, B), **f32),
            value=torch.empty((T, B), **f32),
            reward=torch.empty((T, B), **f32),
            done=torch.empty((T, B), dtype=torch.bool, device=dev))
        for t in range(T):
            with span("ppo.policy", dev):
                mean, log_std, value = net(obs_from(obs))
            action = mean + torch.exp(log_std) * noise[t]
            tmap(lambda buf, o: buf[t].copy_(o), traj["obs"], obs)
            traj["action"][t] = action
            traj["logp"][t] = log_prob(action, mean, log_std)
            traj["value"][t] = value
            env_states, out, obs = step(env_states, torch.tanh(action))
            traj["reward"][t] = out.reward
            traj["done"][t] = out.done
        with span("ppo.policy", dev):
            last_value = net(obs_from(obs))[2]
    return traj, env_states, obs, last_value


def update(ts: TrainState, traj, advantages, returns, perms,
           ppo: PPOConfig, obs_from, group=None):
    """The clipped-surrogate update: for each permutation of the T*B
    transitions in ``perms`` [epochs, T*B], ``ppo.minibatches`` steps of
    global-norm clipping and Adam on consecutive slices of it; obs_from
    maps the trajectory's raw observations to the network's input. With a
    process ``group`` each minibatch's gradients are averaged over its
    ranks before the clip (the reference's pmean before tx.update).
    Returns (ts, the epochs' mean losses [epochs])."""
    T, B = traj["reward"].shape
    n, dev = T * B, traj["reward"].device
    with span("ppo.update"):
        flat = dict(obs=tmap(lambda o: o.flatten(0, 1), traj["obs"]),
                    action=traj["action"].reshape(n, -1),
                    logp=traj["logp"].reshape(n), adv=advantages.reshape(n),
                    ret=returns.reshape(n))
        mb = n // ppo.minibatches
        params = list(ts.net.parameters())
        losses = []
        for perm in perms:
            for m in range(ppo.minibatches):
                with span("ppo.forward", dev):
                    idx = perm[m * mb:(m + 1) * mb]
                    batch = {k: tmap(lambda v: v[idx], v)
                             for k, v in flat.items()}
                    batch["obs"] = obs_from(batch["obs"])
                    loss, _ = ppo_loss(ts.net, batch, ppo)
                with span("ppo.backward", dev):
                    ts.opt.zero_grad()
                    loss.backward()
                with span("ppo.optimizer", dev):
                    if group is not None:
                        pmean_grads_(params, group)
                    clip_by_global_norm_(params, ppo.max_grad_norm)
                    ts.opt.step()
                losses.append(loss.detach())
        return ts, torch.stack(losses).reshape(len(perms), -1).mean(1)


def _train_step(ppo, num_envs, dev, rollout, obs_from, nav):
    """train_step over a rollout(ts, noise) -> (ts, traj, last_value)."""
    gae_fn = lambda traj, last_value: gae(traj, last_value, ppo)
    update_fn = lambda ts, traj, adv, ret, perms, group=None: update(
        ts, traj, adv, ret, perms, ppo, obs_from, group)

    def train_step(ts: TrainState, axis_name=None):
        """One PPO iteration; returns (ts, metrics of 0-d tensors: loss,
        mean_reward, done_frac and, under Nav, goal_frac). ``axis_name``
        is the process group whose ranks average every minibatch's
        gradients (parallel.make_sharded_ppo passes it); None trains
        alone. The metrics are this rank's own."""
        T, n = ppo.rollout_len, ppo.rollout_len * num_envs
        noise = torch.randn((T, num_envs, 2), generator=ts.generator,
                            device=dev)
        perms = torch.stack([torch.randperm(n, generator=ts.generator,
                                            device=dev)
                             for _ in range(ppo.epochs)])
        ts, traj, last_value = rollout(ts, noise)
        adv, ret = gae_fn(traj, last_value)
        ts, losses = update_fn(ts, traj, adv, ret, perms, axis_name)
        metrics = dict(loss=losses.mean(),
                       mean_reward=traj["reward"].mean(),
                       done_frac=traj["done"].to(torch.float32).mean())
        if nav:
            # a goal reach pays +500 (the lane term is O(1), a crash
            # -1000), so reward > 400 identifies it
            metrics["goal_frac"] = (traj["reward"] > 400.0).to(
                torch.float32).mean()
        return ts, metrics

    train_step.rollout, train_step.gae, train_step.update = \
        rollout, gae_fn, update_fn
    return train_step


def make_ppo(cfg, maps, num_envs: int, ppo: PPOConfig = PPOConfig(),
             fused: bool = False, nav: bool = False,
             goal_in_obs: bool = False, device="cuda"):
    """(init, train_step) of PPO on ``device`` (the card unless
    ``device="cpu"``, where the kernels' plain versions run).

    init(generator) -> TrainState: fresh env states and network
    parameters, drawn from ``generator`` (a torch.Generator on the
    device), which the state keeps. train_step(ts) -> (ts, metrics); it
    updates ts.net and ts.opt in place.

    fused=True: rollouts carry the state blob through the fused rollout,
    on one map or a stack (state observations; RGB within the blob
    render's budget), with domain randomization and NPCs in the kernels.
    nav=True (fused only): the Nav task; goal_in_obs adds the agent-frame
    goal to the observation (frames become (image, goal) pairs, state
    vectors grow by 3). fused=False: the step path over one map with
    ``renderer="pallas"`` for RGB."""
    dev = resolve_device(device)
    if fused:
        return _make_ppo_fused(cfg, maps, num_envs, ppo, nav, goal_in_obs,
                               dev)
    if nav:
        raise NotImplementedError(
            "nav PPO runs on the fused path (make_ppo(..., fused=True, "
            "nav=True))")
    from dtown_torch import env

    v_reset, v_step = env.make_vec_env(cfg, maps, num_envs, device=dev)

    def render(states):
        return env.render_obs_batch(cfg, v_step.maps, states,
                                    pack=v_step.pack)

    def step(states, actions):
        states, out = v_step(states, actions)
        return states, out, out.obs

    def init(generator: torch.Generator) -> TrainState:
        states = v_reset(generator)
        net = ActorCritic(obs_shape(render(states)), trunk=ppo.trunk,
                          device=dev, generator=generator)
        return TrainState(net, make_optimizer(net, ppo), states, generator)

    def rollout(ts: TrainState, noise):
        traj, states, _, last_value = collect(
            ts.net, noise, ts.env_states, render(ts.env_states), step,
            _identity)
        return ts._replace(env_states=states), traj, last_value

    return init, _train_step(ppo, num_envs, dev, rollout, _identity,
                             nav=False)


def _identity(obs):
    return obs


def planes_view(cfg):
    """uint8 planes [B, C, S, 128] -> NHWC [B, H, W, C] as a view: the
    values of render.row_raster.planes_to_nhwc without its copy (the
    trunk's bf16 conversion is the one copy the frames need)."""
    H, W = cfg.camera_height, cfg.camera_width

    def view(planes):
        return planes.reshape(planes.shape[0], planes.shape[1], H,
                              W).permute(0, 2, 3, 1)

    return view


def _make_ppo_fused(cfg, maps, num_envs, ppo, nav, goal_in_obs, dev):
    """Fused PPO: TrainState.env_states is (blob, the last observation as
    fused_step emits it). The trajectory keeps the frames as the planes
    the blob render writes (uint8 [T, B, C, S, 128], NCHW per env), each
    step a straight copy; the network sees them through planes_view."""
    from dtown_torch.ops import fused_env as fe

    try:
        if nav:
            init_blob, fused_step, _ = fe.make_fused_nav_rollout(
                cfg, maps, num_envs, goal_in_obs=goal_in_obs, device=dev)
        else:
            init_blob, fused_step, _ = fe.make_fused_rollout(
                cfg, maps, num_envs, device=dev)
    except NotImplementedError as e:
        raise NotImplementedError(f"fused PPO: {e}") from e
    maps_d = maps.to(dev)
    rgb = cfg.obs_type == "rgb"
    if rgb and maps_d.is_stack and fused_step.pack.get("planless"):
        # past the blob render's budget a stack's frames come from the
        # XLA ray-caster as [B, H, W, C], not the planes this path reads
        raise NotImplementedError(
            "fused PPO: RGB on a stack past the blob render's budget (more "
            "than 8 maps, 48 objects or 8 moving NPCs); use "
            "make_ppo(..., fused=False)")
    view = planes_view(cfg)

    def obs_from(raw):
        if not rgb:
            return raw
        return (view(raw[0]), raw[1]) if isinstance(raw, tuple) else \
            view(raw)

    def init(generator: torch.Generator) -> TrainState:
        blob = init_blob(generator)
        raw = fe.obs_from_blob(cfg, maps_d, blob, fused_step.pack)
        if nav and goal_in_obs:
            # obs_from_blob is task-agnostic: add the goal features that
            # the Nav fused_step emits, so the first obs matches the rest
            goal = torch.stack(fe.nav_goal_features_from_blob(
                cfg, maps_d, blob), -1)
            raw = (raw, goal) if rgb else torch.cat([raw, goal], -1)
        net = ActorCritic(obs_shape(obs_from(raw)), trunk=ppo.trunk,
                          device=dev, generator=generator)
        return TrainState(net, make_optimizer(net, ppo), (blob, raw),
                          generator)

    def rollout(ts: TrainState, noise):
        blob, raw = ts.env_states
        traj, blob, raw, last_value = collect(ts.net, noise, blob, raw,
                                              fused_step, obs_from)
        return ts._replace(env_states=(blob, raw)), traj, last_value

    train_step = _train_step(ppo, num_envs, dev, rollout, obs_from, nav)
    train_step.obs_from, train_step.fused_step = obs_from, fused_step
    return init, train_step
