"""Fused RGB rollout: blob-state steps driven by the two CUDA kernels.

Counterpart of dtown/ops/fused_env.py. The rollout carries the transposed
state blob [NF, B]; each step is one state step (ops/state_kernel.py) and
one blob render (render/blob_raster.py), with no other work between them:

    blob --state_step--> blob' --render_frames_from_blob--> u8 [B, 3, S, 128]

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU, where the plain torch versions run instead of the kernels.
Scope of this slice: RGB observations on a static single map.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dtown_torch import constants as C
from dtown_torch import env
from dtown_torch.device import resolve_device
from dtown_torch.ops import state_kernel as sk
from dtown_torch.render import blob_raster as br
from dtown_torch.types import EnvConfig


def pack_blob(pos, angle, rng, robot_speed, wheel_dist):
    """Freshly reset envs -> blob f32 [NF, B] on pos's device.

    pos [B, 3], angle [B], rng [B] (integer counter; stored mod 65536),
    robot_speed/wheel_dist [B]. Speed, wheel velocities, step count and
    map index start at zero; F_ENVID is arange(B).
    """
    B = pos.shape[0]
    f32 = torch.float32
    rows = torch.zeros((sk.NF, B), dtype=f32, device=pos.device)
    rows[sk.F_POS_X] = pos[:, 0]
    rows[sk.F_POS_Y] = pos[:, 1]
    rows[sk.F_POS_Z] = pos[:, 2]
    rows[sk.F_ANGLE] = angle
    rows[sk.F_RNG] = (rng.to(torch.int64) % 65536).to(f32)
    rows[sk.F_ROBOT_SPEED] = robot_speed
    rows[sk.F_WHEEL_DIST] = wheel_dist
    rows[sk.F_ENVID] = torch.arange(B, dtype=f32, device=pos.device)
    return rows


@dataclass(frozen=True)
class StepOutput:
    """Per-env step outputs read from the blob rows (each [B])."""
    reward: torch.Tensor
    done: torch.Tensor
    lane_dist: torch.Tensor
    lane_dot_dir: torch.Tensor
    lane_angle_deg: torch.Tensor
    in_lane: torch.Tensor
    collision: torch.Tensor
    timestamp: torch.Tensor


def unpack_outputs(blob) -> StepOutput:
    return StepOutput(
        reward=blob[sk.F_REWARD],
        done=blob[sk.F_DONE] > 0.5,
        lane_dist=blob[sk.F_LDIST],
        lane_dot_dir=blob[sk.F_LDOT],
        lane_angle_deg=blob[sk.F_LDEG],
        in_lane=blob[sk.F_INLANE] > 0.5,
        collision=blob[sk.F_COLL] > 0.5,
        timestamp=blob[sk.F_TIME],
    )


def make_fused_rollout(cfg: EnvConfig, maps, num_envs: int,
                       device="cuda"):
    """(init_blob, fused_step, rollout) of the fused RGB rollout.

    init_blob(generator) -> blob f32 [NF, B]: bank spawns (env._bank_spawn
    against the map's objects) drawn with the torch.Generator (a CPU
    generator: the draw happens on the host).
    fused_step(blob, actions[B, 2]) -> (blob, StepOutput, obs u8
    [B, 3, S, 128]).
    rollout(blob, actions, n_iters) -> (blob, reward_sum, obs_checksum):
    n_iters fused steps with fixed actions; reward_sum is the last step's
    reward summed over envs, obs_checksum the sum of the last frame's
    first plane row (int64), as in the reference.
    """
    dev = resolve_device(device)
    if cfg.obs_type != "rgb":
        raise NotImplementedError("state observations are not ported yet")
    if cfg.spawn_mode != "bank":
        raise NotImplementedError("rejection spawning is not ported yet")
    if num_envs % 8 != 0:
        raise ValueError(f"num_envs must be divisible by 8; got {num_envs}")
    tables = sk.build_tables(cfg, maps)
    st = sk.device_tables(cfg, tables, dev)
    plan = br.build_render_plan(cfg, maps)
    if plan is None:
        raise NotImplementedError(
            "maps with more than 48 objects need the row-fed render "
            "kernels, which are not ported yet")
    pk = br.pack_plan(cfg, plan, dev)
    host = maps.numpy().to("cpu")
    n_ok = env.bank_accept_count(cfg, host)
    M = host.max_objects

    def init_blob(generator: torch.Generator):
        idxs = torch.randint(0, n_ok, (num_envs, env.NTRY),
                             generator=generator)
        rng = torch.randint(0, 65536, (num_envs,), generator=generator)
        pos, angle = env._bank_spawn(
            cfg, host, host.obj_pos.expand(num_envs, M, 3),
            host.obj_mask.expand(num_envs, M), idxs)
        f = lambda v: torch.full((num_envs,), float(np.float32(v)),
                                 device=dev)
        return pack_blob(pos.to(dev), angle.to(dev), rng.to(dev),
                         f(cfg.robot_speed), f(C.WHEEL_DIST))

    def fused_step(blob, actions):
        blob = sk.state_step(blob, actions, st)
        obs = br.render_frames_from_blob(blob, pk)
        return blob, unpack_outputs(blob), obs

    def rollout(blob, actions, n_iters: int):
        rsum = osum = None
        for _ in range(n_iters):
            blob, out, obs = fused_step(blob, actions)
            rsum = out.reward.sum()
            osum = obs[:, 0, 0, :].sum(dtype=torch.int64)
        return blob, rsum, osum

    return init_blob, fused_step, rollout
