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
from dtown_torch.ops import state_kernel as sk
from dtown_torch.render import blob_raster as br
from dtown_torch.types import EnvConfig


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; CUDA must be present when asked for
    (there is no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "torch versions instead of the CUDA kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


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


NTRY = 8  # bank candidates per spawn (env.py _bank_spawn)


def bank_spawn(cfg, maps, idxs):
    """Bank-spawn pick (dtown env._bank_spawn): of the NTRY candidate bank
    indices per env ([B, NTRY], numpy ints), keep the first that clears
    every active object by MIN_SPAWN_OBJ_DIST + its safety radius, or the
    least-blocked one. Returns (pos [B, 3], angle [B]) float32 numpy."""
    sp = np.asarray(maps.spawn_pos)
    sa = np.asarray(maps.spawn_angle)
    act = np.asarray(maps.obj_mask)
    cand = sp[idxs]                                        # [B, NTRY, 3]
    opos = np.asarray(maps.obj_pos)[act]
    if len(opos):
        d = np.linalg.norm(cand[:, :, None, :] - opos[None, None], axis=-1)
        margin = (d - (C.MIN_SPAWN_OBJ_DIST
                       + np.asarray(maps.obj_safety_rad)[act])).min(-1)
    else:
        margin = np.full(idxs.shape, np.inf, np.float32)
    blocked = margin < 0.0
    pick = np.where((~blocked).any(-1), np.argmax(~blocked, -1),
                    np.argmax(margin, -1))
    idx = idxs[np.arange(len(idxs)), pick]
    return sp[idx], sa[idx]


def make_fused_rollout(cfg: EnvConfig, maps, num_envs: int,
                       device="cuda"):
    """(init_blob, fused_step, rollout) of the fused RGB rollout.

    init_blob(generator) -> blob f32 [NF, B]: bank spawns drawn with the
    torch.Generator (a CPU generator: the draw happens on the host).
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
    ok = np.asarray(maps.spawn_mask) & (
        np.abs(np.asarray(maps.spawn_lane_deg)) < cfg.accept_start_angle_deg)
    n_ok = max(int(ok.sum()), 1)

    def init_blob(generator: torch.Generator):
        idxs = torch.randint(0, n_ok, (num_envs, NTRY),
                             generator=generator).numpy()
        rng = torch.randint(0, 65536, (num_envs,), generator=generator)
        pos, angle = bank_spawn(cfg, maps, idxs)
        f = lambda v: torch.full((num_envs,), float(np.float32(v)),
                                 device=dev)
        return pack_blob(
            torch.as_tensor(pos, device=dev),
            torch.as_tensor(angle, device=dev), rng.to(dev),
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
