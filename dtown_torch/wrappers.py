"""Env wrappers (counterpart of dtown/wrappers.py).

Object wrappers over the gym-style single env (gym_compat.DuckietownEnv),
with the reference's class names, and ``make_frame_stack_vec``, a frame
stack over the batched env core.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# 3 discrete actions as (velocity, steering): turn left, turn right, go
# forward
DISCRETE_ACTIONS = np.array([[0.6, +1.0], [0.6, -1.0], [0.7, 0.0]],
                            dtype=np.float32)


def discrete_to_continuous(action_idx):
    """int tensor [...] -> continuous (velocity, steering) [..., 2]."""
    table = torch.as_tensor(DISCRETE_ACTIONS, device=action_idx.device)
    return table[action_idx.long()]


class _Wrapper:
    def __init__(self, env):
        self.env = env

    def reset(self):
        return self.env.reset()

    def step(self, action):
        return self.env.step(action)

    def __getattr__(self, name):
        return getattr(self.env, name)


class DiscreteWrapper(_Wrapper):
    """3-action discrete interface over a DuckietownEnv."""

    def __init__(self, env):
        super().__init__(env)
        self.action_count = len(DISCRETE_ACTIONS)

    def step(self, action_idx: int):
        return self.env.step(DISCRETE_ACTIONS[int(action_idx)])


class SteeringToWheelVelWrapper(_Wrapper):
    """Raw wheel-velocity actions [u_l, u_r]: the wrapped env's config
    loses its inverse-kinematics wheel model."""

    def __init__(self, env):
        super().__init__(env)
        env.cfg = dataclasses.replace(env.cfg, use_wheel_model=False)


class ResizeWrapper(_Wrapper):
    """Host-side bilinear resize of the frames to ``shape`` (antialiased
    when shrinking, as jax.image.resize)."""

    def __init__(self, env, shape=(84, 84)):
        super().__init__(env)
        self.shape = shape

    def _resize(self, obs):
        x = torch.as_tensor(np.asarray(obs), dtype=torch.float32)
        out = torch.nn.functional.interpolate(
            x.permute(2, 0, 1)[None], size=tuple(self.shape),
            mode="bilinear", align_corners=False, antialias=True)
        return torch.clamp(out[0].permute(1, 2, 0), 0, 255) \
            .to(torch.uint8).numpy()

    def reset(self):
        return self._resize(self.env.reset())

    def step(self, action):
        obs, r, d, i = self.env.step(action)
        return self._resize(obs), r, d, i


class NormalizeWrapper(_Wrapper):
    """uint8 observations -> float32 in [0, 1]."""

    def reset(self):
        return np.asarray(self.env.reset(), dtype=np.float32) / 255.0

    def step(self, action):
        obs, r, d, i = self.env.step(action)
        return np.asarray(obs, dtype=np.float32) / 255.0, r, d, i


class FrameStackWrapper(_Wrapper):
    """The last k observations stacked along the channel axis."""

    def __init__(self, env, k: int = 4):
        super().__init__(env)
        self.k = k
        self._frames = None

    def _stacked(self):
        return np.concatenate(self._frames, axis=-1)

    def reset(self):
        self._frames = [np.asarray(self.env.reset())] * self.k
        return self._stacked()

    def step(self, action):
        obs, r, d, i = self.env.step(action)
        self._frames = self._frames[1:] + [np.asarray(obs)]
        return self._stacked(), r, d, i


def make_frame_stack_vec(cfg, maps, num_envs: int, k: int = 4,
                         device="cuda"):
    """(fs_reset, fs_step): the batched env (env.make_vec_env) whose
    observation is the last-axis concatenation of each env's k most
    recent frames. fs_reset(generator) -> ((states, buf [k, B, ...]),
    obs); fs_step(carry, actions) -> (carry, StepOutput). On a done (an
    auto-reset) an env's whole stack restarts from the new episode's
    first observation."""
    from dtown_torch import env as env_core

    v_reset, v_step = env_core.make_vec_env(cfg, maps, num_envs,
                                            device=device)

    def _stack(buf):
        return torch.cat(list(buf), dim=-1)

    def fs_reset(generator: torch.Generator):
        states = v_reset(generator)
        obs0 = env_core.render_obs_batch(cfg, v_step.maps, states,
                                         pack=v_step.pack)
        buf = obs0[None].repeat((k,) + (1,) * obs0.dim())
        return (states, buf), _stack(buf)

    def fs_step(carry, actions):
        states, buf = carry
        states, out = v_step(states, actions)
        buf = torch.cat([buf[1:], out.obs[None]], 0)
        dmask = out.done.reshape((1, -1) + (1,) * (out.obs.dim() - 1))
        buf = torch.where(dmask, out.obs[None], buf)
        return (states, buf), out.replace(obs=_stack(buf))

    fs_step.maps = v_step.maps
    return fs_reset, fs_step
