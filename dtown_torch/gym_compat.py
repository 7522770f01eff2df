"""Host-side single-env wrapper with the classic Gym API.

Counterpart of dtown/gym_compat.py: ``DuckietownEnv`` owns one env's
state on the device (the card unless ``device="cpu"``) and steps it with
the per-env step of env.py, whose frames come from the XLA ray-caster
(render/raster.py) at the reference gym surface's 640x480; only the
observation, the reward and the info cross to the host, in one copy a
step. ``DuckietownLF`` and ``DuckietownNav`` are its two tasks,
``MultiMapEnv`` cycles maps on reset.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from dtown_torch import constants as C
from dtown_torch import env as env_core
from dtown_torch import map_loader
from dtown_torch.device import resolve_device
from dtown_torch.types import EnvConfig


class DuckietownEnv:
    """Single-env, gym-style API over the batched env core (a batch of
    one): action [velocity, steering], reset() -> obs, step(action) ->
    (obs, reward, done, info). Observations are uint8 (H, W, C) frames,
    640x480 unless camera_width / camera_height are given, or the
    11-column state vector under obs_type="state". Auto-reset is off by
    default, as in the reference gym surface."""

    metadata = {"render.modes": ["rgb_array", "human", "top_down"]}

    def __init__(self, map_name: str = C.DEFAULT_MAP_NAME, seed: int = 0,
                 randomize_maps_on_reset: bool = False, device="cuda",
                 **cfg_kwargs):
        cfg_kwargs.setdefault("auto_reset", False)
        if cfg_kwargs.get("obs_type", "rgb") == "rgb":
            cfg_kwargs.setdefault("camera_width", C.DEFAULT_CAMERA_WIDTH)
            cfg_kwargs.setdefault("camera_height", C.DEFAULT_CAMERA_HEIGHT)
        self.cfg = EnvConfig(**cfg_kwargs)
        self.device = resolve_device(device)
        self.map_name = map_name
        self._load(map_name)
        self._randomize_maps = randomize_maps_on_reset
        self._map_pool = (map_loader.list_maps() if randomize_maps_on_reset
                          else None)
        self._np_random_maps = np.random.default_rng(seed)
        self.seed(seed)
        self.state = None
        h, w, c = (self.cfg.camera_height, self.cfg.camera_width,
                   self.cfg.obs_channels)
        self.observation_shape = ((h, w, c) if self.cfg.obs_type == "rgb"
                                  else (11,))
        self.action_shape = (2,)

    def _load(self, map_name):
        self.maps = map_loader.load_map(map_name).to(self.device)
        self._facts = env_core.host_facts(self.cfg, self.maps)

    # -- gym surface ---------------------------------------------------
    def seed(self, seed: int = 0):
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        return [seed]

    def reset(self):
        if self._randomize_maps:
            new_map = self._map_pool[
                self._np_random_maps.integers(0, len(self._map_pool))]
            if new_map != self.map_name:
                self.map_name = new_map
                self._load(new_map)
        self.state = env_core.reset(self.cfg, self.maps, self._gen, 1,
                                    self._facts.n_ok)
        return self._obs()

    def _obs(self):
        return env_core.render_obs(self.cfg, self.maps,
                                   self.state)[0].cpu().numpy()

    def step(self, action):
        assert self.state is not None, "call reset() first"
        act = np.asarray(action, dtype=np.float32)
        self.state, out = env_core.step(
            self.cfg, self.maps, self.state,
            torch.as_tensor(act, device=self.device).reshape(1, 2),
            generator=self._gen, facts=self._facts)
        st = self.state
        # every host-side scalar of the step in one copy
        vals = torch.cat([
            out.reward, out.done.float(), out.lane_dist, out.lane_dot_dir,
            out.lane_angle_deg, out.timestamp, out.in_lane.float(),
            out.collision.float(), st.speed, st.angle,
            st.step_count.float(), st.robot_speed, st.cam_fov_y,
            st.cam_height, st.cam_angle, st.wheel_dist, st.pos[0],
            st.wheel_vels[0]]).cpu().numpy().astype(np.float64)
        (reward, done, ldist, ldot, ldeg, tstamp, in_lane, coll, speed,
         angle, steps, rspeed, fov, camh, cama, wdist) = vals[:16]
        pos = vals[16:19].astype(np.float32)
        ts = float(self.maps.numpy().tile_size)
        info = {"Simulator": {
            "action": act,
            "lane_position": {"dist": ldist, "dot_dir": ldot,
                              "angle_deg": ldeg},
            "robot_speed": speed,
            "cur_pos": pos,
            "cur_angle": angle,
            "wheel_velocities": vals[19:21].astype(np.float32),
            "tile_coords": [int(float(pos[0]) // ts),
                            int(float(pos[2]) // ts)],
            "timestamp": tstamp,
            "msg": "",
        }}
        if self.cfg.full_transparency:
            info["Simulator"].update({
                "map_name": self.map_name,
                "in_lane": bool(in_lane),
                "lane_angle_rad": float(np.deg2rad(np.float32(ldeg))),
                "collision": bool(coll),
                "step_count": int(steps),
                "domain_rand_params": {
                    "robot_speed": rspeed, "cam_fov_y": fov,
                    "cam_height": camh, "cam_angle": cama,
                    "wheel_dist": wdist,
                },
            })
        return out.obs[0].cpu().numpy(), float(reward), bool(done), info

    def render(self, mode: str = "rgb_array"):
        """rgb_array returns the observation; 'human' also paints it into
        the terminal as ANSI truecolour half-blocks; 'top_down' renders
        the bird's-eye view of the map with an agent marker."""
        if mode == "top_down":
            from dtown_torch.render.raster import render_top_down

            rgb_cfg = (self.cfg if self.cfg.obs_type == "rgb" else
                       dataclasses.replace(self.cfg, obs_type="rgb"))
            return render_top_down(rgb_cfg, self.maps,
                                   self.state)[0].cpu().numpy()
        img = self._obs()
        if mode == "human":
            _print_ansi_frame(img)
        return img

    def close(self):
        pass


def _print_ansi_frame(img, max_cols: int = 64, out=None):
    """Paint an RGB uint8 frame into a terminal with 24-bit half-blocks
    (two pixel rows per text row)."""
    out = out or sys.stdout
    h, w = img.shape[:2]
    step = max(1, w // max_cols)
    small = img[::step * 2, ::step]
    small_lo = img[step::step * 2, ::step]
    lines = []
    for r in range(min(len(small), len(small_lo))):
        line = []
        for c in range(small.shape[1]):
            tr, tg, tb = (int(x) for x in small[r, c][:3])
            br, bg, bb = (int(x) for x in small_lo[r, c][:3])
            line.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀")
        lines.append("".join(line) + "\x1b[0m")
    out.write("\n".join(lines) + "\n")
    out.flush()


class DuckietownLF(DuckietownEnv):
    """Lane following: the base env's reward already encodes it."""


class DuckietownNav(DuckietownEnv):
    """Navigation: on reset a goal tile is drawn from the drivable tiles;
    entering it ends the episode with a bonus reward."""

    GOAL_REWARD = C.NAV_GOAL_REWARD

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._drivable = np.argwhere(np.asarray(self.maps.numpy().drivable))
        self._goal = None
        self._np_random = np.random.default_rng(0)

    def seed(self, seed: int = 0):
        self._np_random = np.random.default_rng(seed)
        return super().seed(seed)

    def reset(self):
        obs = super().reset()
        j, i = self._drivable[self._np_random.integers(0,
                                                       len(self._drivable))]
        self._goal = (int(i), int(j))
        return obs

    def step(self, action):
        obs, reward, done, info = super().step(action)
        info["goal_tile"] = self._goal
        if not done and tuple(info["Simulator"]["tile_coords"]) == self._goal:
            reward += self.GOAL_REWARD
            done = True
            info["Simulator"]["msg"] = "goal-reached"
        return obs, reward, done, info


class MultiMapEnv:
    """Cycles to the next map on every reset: one DuckietownEnv per map."""

    def __init__(self, map_names=None, seed: int = 0, **cfg_kwargs):
        names = list(map_names) if map_names else map_loader.list_maps()
        assert names, "no maps"
        self.envs = [DuckietownEnv(map_name=n, seed=seed + i, **cfg_kwargs)
                     for i, n in enumerate(names)]
        self._idx = -1
        self.env = self.envs[0]

    def reset(self):
        self._idx = (self._idx + 1) % len(self.envs)
        self.env = self.envs[self._idx]
        return self.env.reset()

    def step(self, action):
        return self.env.step(action)

    def render(self, mode: str = "rgb_array"):
        return self.env.render(mode)

    def seed(self, seed: int = 0):
        for i, e in enumerate(self.envs):
            e.seed(seed + i)
        return [seed]

    def close(self):
        pass
