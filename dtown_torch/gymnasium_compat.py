"""Gymnasium adapter: the port's envs under gymnasium's API.

Counterpart of dtown/gymnasium_compat.py. ``gymnasium`` is an optional
extra, imported only by this module:

    import gymnasium
    import dtown_torch.gymnasium_compat  # registers the ids
    env = gymnasium.make("dtown_torch/Duckietown-udem1-v0", device="cpu")
    obs, info = env.reset(seed=0)
    obs, reward, terminated, truncated, info = env.step([0.5, 0.0])

The ids live in the ``dtown_torch`` namespace, beside the JAX package's
``Duckietown-<map>-v0``. The classic 4-tuple step maps to gymnasium's
5-tuple: ``terminated`` is a crash (the REWARD_INVALID_POSE payout),
``truncated`` any other end (the max_steps horizon).
"""
from __future__ import annotations

import numpy as np
import torch

try:
    import gymnasium
    from gymnasium import spaces
except ImportError:  # gymnasium is an optional extra
    gymnasium = None
    spaces = None

from dtown_torch import constants as C

NAMESPACE = "dtown_torch"


class DuckietownGymnasiumEnv(gymnasium.Env if gymnasium else object):
    """gymnasium.Env over gym_compat.DuckietownEnv."""

    metadata = {"render_modes": ["rgb_array", "human", "top_down"],
                "render_fps": C.DEFAULT_FRAMERATE}

    def __init__(self, map_name: str = C.DEFAULT_MAP_NAME,
                 render_mode: str = "rgb_array", **cfg_kwargs):
        assert gymnasium is not None, "gymnasium is not installed"
        from dtown_torch.gym_compat import DuckietownEnv

        if cfg_kwargs.get("auto_reset"):
            # under gymnasium the user resets after termination
            raise ValueError(
                "auto_reset is not supported on the gymnasium surface; "
                "use dtown_torch.make_vec / gymnasium's AutoResetWrapper")
        self._env = DuckietownEnv(map_name=map_name, **cfg_kwargs)
        self.render_mode = render_mode
        if self._env.cfg.obs_type == "rgb":
            self.observation_space = spaces.Box(
                0, 255, self._env.observation_shape, dtype=np.uint8)
        else:
            self.observation_space = spaces.Box(
                -np.inf, np.inf, self._env.observation_shape,
                dtype=np.float32)
        self.action_space = spaces.Box(-1.0, 1.0, (2,), dtype=np.float32)

    @property
    def unwrapped_dtown(self):
        return self._env

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._env.seed(seed)
        return self._env.reset(), {}

    def step(self, action):
        obs, reward, done, info = self._env.step(action)
        terminated = bool(done) and reward <= C.REWARD_INVALID_POSE + 1.0
        truncated = bool(done) and not terminated
        return obs, reward, terminated, truncated, info

    def render(self):
        return self._env.render(self.render_mode)

    def close(self):
        self._env.close()


def register_gymnasium():
    """Register ``dtown_torch/Duckietown-<map>-v0`` for every map with
    gymnasium (idempotent); returns the registered ids."""
    assert gymnasium is not None, "gymnasium is not installed"
    from dtown_torch import map_loader

    for m in map_loader.list_maps():
        env_id = f"{NAMESPACE}/Duckietown-{m}-v0"
        if env_id not in gymnasium.registry:
            gymnasium.register(
                id=env_id,
                entry_point="dtown_torch.gymnasium_compat:"
                            "DuckietownGymnasiumEnv",
                kwargs={"map_name": m})
    return sorted(k for k in gymnasium.registry
                  if k.startswith(f"{NAMESPACE}/Duckietown-"))


if gymnasium is not None:
    register_gymnasium()


class DuckietownVectorEnv(gymnasium.vector.VectorEnv if gymnasium
                          else object):
    """gymnasium.vector.VectorEnv over the batched env core
    (env.make_vec_env) on ``device``. Autoreset is SAME_STEP: a done step
    already returns the new episode's first observation.

        envs = DuckietownVectorEnv("small_loop", num_envs=1024)
        obs, info = envs.reset(seed=0)
        obs, rew, term, trunc, info = envs.step(actions)  # all [1024,...]
    """

    def __init__(self, map_name="small_loop", num_envs: int = 64,
                 device="cuda", **cfg_kwargs):
        assert gymnasium is not None, "gymnasium is not installed"
        from dtown_torch import env as env_core
        from dtown_torch import map_loader
        from dtown_torch.types import EnvConfig

        cfg_kwargs.setdefault("auto_reset", True)
        if not cfg_kwargs["auto_reset"]:
            raise ValueError("DuckietownVectorEnv requires auto_reset")
        self.cfg = EnvConfig(**cfg_kwargs)
        maps = (map_loader.stack_maps(list(map_name))
                if isinstance(map_name, (list, tuple))
                else map_loader.load_map(map_name))
        self._v_reset, self._v_step = env_core.make_vec_env(
            self.cfg, maps, num_envs, device=device)
        self.maps = self._v_step.maps
        self.num_envs = num_envs
        self.metadata = {"autoreset_mode":
                         gymnasium.vector.AutoresetMode.SAME_STEP}
        if self.cfg.obs_type == "rgb":
            shape = (self.cfg.camera_height, self.cfg.camera_width,
                     self.cfg.obs_channels)
            self.single_observation_space = spaces.Box(
                0, 255, shape, dtype=np.uint8)
        else:
            self.single_observation_space = spaces.Box(
                -np.inf, np.inf, (11,), dtype=np.float32)
        self.single_action_space = spaces.Box(-1.0, 1.0, (2,),
                                              dtype=np.float32)
        self.observation_space = gymnasium.vector.utils.batch_space(
            self.single_observation_space, num_envs)
        self.action_space = gymnasium.vector.utils.batch_space(
            self.single_action_space, num_envs)
        self._states = None

    def reset(self, *, seed=None, options=None):
        from dtown_torch import env as env_core

        dev = self.maps.obj_pos.device
        gen = torch.Generator(device=dev).manual_seed(
            0 if seed is None else seed)
        self._states = self._v_reset(gen)
        obs = env_core.render_obs_batch(self.cfg, self.maps, self._states,
                                        pack=self._v_step.pack)
        return obs.cpu().numpy(), {}

    def step(self, actions):
        assert self._states is not None, "call reset() first"
        dev = self.maps.obj_pos.device
        self._states, out = self._v_step(
            self._states,
            torch.as_tensor(np.asarray(actions, np.float32), device=dev))
        rewards = out.reward.cpu().numpy()
        done = out.done.cpu().numpy()
        terminations = done & (rewards <= C.REWARD_INVALID_POSE + 1.0)
        truncations = done & ~terminations
        info = {"lane_dist": out.lane_dist.cpu().numpy(),
                "in_lane": out.in_lane.cpu().numpy(),
                "collision": out.collision.cpu().numpy()}
        return (out.obs.cpu().numpy(), rewards, terminations, truncations,
                info)

    def close_extras(self, **kwargs):
        pass
