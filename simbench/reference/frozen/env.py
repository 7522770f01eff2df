"""The reset of the vectorized env: batched fresh episode states (torch).

A frozen copy of the port's ``env.reset`` and what it needs (the step path
is not copied: the benchmark's cells step through the state kernel's
plain version, ops/state_kernel.py). Every function takes a batch of B
envs; random draws come from an explicit torch.Generator on the state's
device. Spawns: the precomputed bank (``spawn_mode="bank"``), rejection
sampling (any other mode), or the ``start_pose`` / ``user_tile_start``
overrides.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from simbench.reference.frozen import constants as C
from simbench.reference.frozen import objects as objlib
from simbench.reference.frozen import physics
from simbench.reference.frozen import randomization
from simbench.reference.frozen.geometry import bezier_point, bezier_tangent, \
    norm3
from simbench.reference.frozen.types import EnvConfig, EnvState, MapArrays, \
    tree_where

NTRY = 8  # bank candidates per spawn


def check_scope(cfg: EnvConfig, maps: MapArrays):
    """Raise for what neither the step path nor the fused rollout takes:
    ValueError for an unknown obs_type, TypeError for a list of maps
    (``maps`` is one map or a stack of maps, map_loader.stack_maps)."""
    if isinstance(maps, (list, tuple)):
        raise TypeError("pass one map or a stack of maps "
                        "(simbench.reference.frozen.stack_maps(names)), not a list")
    if cfg.obs_type not in ("rgb", "state"):
        raise ValueError(f"unknown obs_type {cfg.obs_type}")


def active_objects(maps, state):
    """Collidable object slots [B, M] (padding and hidden optionals off)."""
    return maps.obj_mask & (~maps.obj_optional | state.obj_visible)


# ---------------------------------------------------------------------------
# Reset
# ---------------------------------------------------------------------------

def bank_accept_count(cfg, maps) -> int:
    """Number of spawn-bank entries within the start-angle limit (the bank
    is sorted by |lane angle|, so they are a prefix); at least 1."""
    host = maps.numpy()
    ok = np.asarray(host.spawn_mask) & (
        np.abs(np.asarray(host.spawn_lane_deg)) < cfg.accept_start_angle_deg)
    return max(int(ok.sum()), 1)


@dataclasses.dataclass(frozen=True)
class HostFacts:
    """What a step decides on the host, once per map and config: whether
    the map has objects (SAT and proximity, else the object-free
    validity) and dynamic objects (NPC stepping), and the spawn bank's
    accepted prefix that resets draw from. A stack carries the facts of
    each member in ``members``."""

    has_obj: bool
    has_dyn: bool
    n_ok: int
    members: tuple = ()


def host_facts(cfg, maps) -> HostFacts:
    host = maps.numpy()
    if host.is_stack:
        # the reference decides these branches at trace time, where a
        # stack's member tables are traced: it takes the object and NPC
        # branches on every member (NPC time and phase advance there too)
        return HostFacts(has_obj=True, has_dyn=True, n_ok=1, members=tuple(
            dataclasses.replace(host_facts(cfg, host.map_at(m)),
                                has_obj=True, has_dyn=True)
            for m in range(host.n_maps)))
    return HostFacts(has_obj=bool(np.asarray(host.obj_mask).any()),
                     has_dyn=bool(np.asarray(host.obj_is_dynamic).any()),
                     n_ok=bank_accept_count(cfg, host))


def _bank_spawn(cfg, maps, dyn_pos, obj_active, idxs):
    """Bank spawn of every env from its NTRY candidate bank indices
    idxs [B, NTRY]: the first candidate that clears every active object
    by MIN_SPAWN_OBJ_DIST + its safety radius, else the least-blocked one.
    dyn_pos [B, M, 3], obj_active [B, M]. Returns (pos [B, 3], angle [B])."""
    idxs = idxs.long()
    cand = maps.spawn_pos[idxs]                                 # [B, T, 3]
    d = norm3(cand[:, :, None, :] - dyn_pos[:, None, :, :])     # [B, T, M]
    clear = d - (C.MIN_SPAWN_OBJ_DIST + maps.obj_safety_rad)
    margin = torch.where(obj_active[:, None, :], clear, torch.inf).amin(-1)
    free = (margin >= 0.0) | torch.isnan(margin)
    pick = torch.where(free.any(-1), torch.argmax(free.to(torch.uint8), -1),
                       torch.argmax(margin, -1))
    idx = torch.gather(idxs, 1, pick[:, None])[:, 0]
    return maps.spawn_pos[idx], maps.spawn_angle[idx]


def _fallback_spawn(maps):
    """The deterministic spawn on the first drivable tile's first lane
    curve at t = 0.5, heading along the lane: (pos [3], angle 0-d)."""
    host = maps.numpy()
    flat = int(np.argmax(np.asarray(host.drivable_frac)))
    j, i = divmod(flat, host.grid_shape[1])
    cps = maps.curves[j, i, 0]
    t = torch.full((), 0.5, dtype=cps.dtype, device=cps.device)
    tan = bezier_tangent(cps, t)
    return bezier_point(cps, t), torch.atan2(-tan[2], tan[0])


def propose_spawns(maps, generator, num_envs: int, attempts: int):
    """Rejection-sampling proposals of every env: a drivable tile drawn
    with weights drivable_frac, a uniform point in it and a uniform
    heading in [0, 2 pi). Returns (pos [B, A, 3], angle [B, A])."""
    dev = maps.obj_pos.device
    if attempts == 0:
        return (torch.zeros((num_envs, 0, 3), device=dev),
                torch.zeros((num_envs, 0), device=dev))
    W = maps.grid_shape[1]
    flat = torch.multinomial(
        maps.drivable_frac.to(torch.float32).expand(num_envs, -1), attempts,
        replacement=True, generator=generator)
    uv = torch.rand((num_envs, attempts, 2), generator=generator, device=dev)
    ts = maps.tile_size.to(torch.float32)
    pos = torch.stack([((flat % W).to(torch.float32) + uv[..., 0]) * ts,
                       torch.zeros_like(uv[..., 0]),
                       ((flat // W).to(torch.float32) + uv[..., 1]) * ts], -1)
    angle = torch.rand((num_envs, attempts), generator=generator,
                       device=dev) * float(np.float32(2.0 * np.pi))
    return pos, angle


def spawn_accept(cfg, maps, obj_active, pos, angle):
    """The rejection sampler's acceptance test of N proposals (pos [N, 3],
    angle [N], the proposing env's obj_active [N, M]): clear of every
    active object by MIN_SPAWN_OBJ_DIST + its safety radius (static
    poses), a valid pose at safety factor 1.3, and in a lane within
    accept_start_angle_deg. Returns bool [N]."""
    d = norm3(maps.obj_pos - pos[:, None, :])
    clear = ~(obj_active & (d < (C.MIN_SPAWN_OBJ_DIST
                                 + maps.obj_safety_rad))).any(-1)
    valid, _ = physics.valid_pose(maps, pos, angle, maps.obj_corners,
                                  maps.obj_norms, obj_active,
                                  safety_factor=1.3)
    lp = get_lane_pos2(maps, pos, angle)
    acc = cfg.accept_start_angle_deg
    ang_ok = lp.in_lane & (lp.angle_deg > -acc) & (lp.angle_deg < acc)
    return clear & valid & ang_ok


def sample_spawn(cfg, maps, obj_active, pos, angle, fb_idx):
    """Rejection spawn of every env from its proposals (pos [B, A, 3],
    angle [B, A]; propose_spawns): the first accepted one, else the bank
    entry fb_idx [B] (an index below the accepted prefix), else, on a map
    with an empty bank, the deterministic first-lane pose.
    Returns (pos [B, 3], angle [B])."""
    B, A = angle.shape
    host = maps.numpy()
    have_bank = bool((np.asarray(host.spawn_mask) & (
        np.abs(np.asarray(host.spawn_lane_deg))
        < cfg.accept_start_angle_deg)).any())
    if have_bank:
        fb = fb_idx.long()
        fb_pos, fb_angle = maps.spawn_pos[fb], maps.spawn_angle[fb]
    else:
        p0, a0 = _fallback_spawn(maps)
        fb_pos, fb_angle = p0.expand(B, 3), a0.expand(B)
    if A == 0:
        return fb_pos, fb_angle
    ok = spawn_accept(cfg, maps, obj_active.repeat_interleave(A, 0),
                      pos.reshape(-1, 3), angle.reshape(-1)).reshape(B, A)
    first = torch.argmax(ok.to(torch.uint8), -1)
    found = ok.any(-1)
    b = torch.arange(B, device=pos.device)
    return (torch.where(found[:, None], pos[b, first], fb_pos),
            torch.where(found, angle[b, first], fb_angle))


def _start_override(cfg, maps, B):
    """(pos [B, 3], angle [B]) of the start_pose / user_tile_start
    override: the given world pose, or the tile's centre heading along its
    first lane curve at the curve point nearest the centre."""
    dev = maps.obj_pos.device
    if cfg.start_pose is not None:
        x0, z0, a0 = cfg.start_pose
        pos = torch.tensor([x0, 0.0, z0], dtype=torch.float32, device=dev)
        angle = torch.tensor(a0, dtype=torch.float32, device=dev)
    else:
        i0, j0 = cfg.user_tile_start
        ts = maps.tile_size.to(torch.float32)
        pos = torch.stack([(i0 + 0.5) * ts, torch.zeros_like(ts),
                           (j0 + 0.5) * ts])
        cps = maps.curves[j0, i0, 0]
        tan = bezier_tangent(cps, bezier_closest(cps, pos))
        angle = torch.atan2(-tan[2], tan[0])
    return pos.expand(B, 3).clone(), angle.expand(B).clone()


def reset_from_draws(cfg, maps, idxs, duckie_noise, rand=None,
                     proposals=None) -> EnvState:
    """Fresh episode states from the reset's draws: standard-normal duckie
    speed noise [B, M], the randomization fields ``rand``
    (randomization.draw or draw_from_uniforms; None gives the nominal
    ones, without domain randomization) and the spawn's draws: bank
    candidate indices idxs [B, NTRY] under spawn_mode="bank", else
    ``proposals`` = (pos [B, A, 3], angle [B, A], fallback bank index
    [B]) for sample_spawn. A start_pose / user_tile_start override takes
    neither."""
    B = duckie_noise.shape[0]
    dev = maps.obj_pos.device
    if rand is None:
        rand = randomization.draw(cfg, B, maps.grid_shape, maps.max_objects,
                                  dev)
    dyn = objlib.init_dyn_state(maps, B, noise=duckie_noise)
    obj_active = maps.obj_mask & (~maps.obj_optional | rand["obj_visible"])
    if cfg.start_pose is not None or cfg.user_tile_start is not None:
        pos, angle = _start_override(cfg, maps, B)
    elif cfg.spawn_mode == "bank":
        pos, angle = _bank_spawn(cfg, maps, dyn.pos, obj_active, idxs)
    else:
        pos, angle = sample_spawn(cfg, maps, obj_active, *proposals)
    zeros = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype,
                                                        device=dev)
    return EnvState(
        pos=pos, angle=angle,
        step_count=zeros(B, dtype=torch.int32), speed=zeros(B),
        wheel_vels=zeros(B, 2), last_action=zeros(B, 2),
        map_idx=initial_map_indices(maps, B, dev), dyn=dyn, **rand)


def reset(cfg, maps, generator: torch.Generator, num_envs: int,
          n_ok: int | None = None, offset: int = 0) -> EnvState:
    """Fresh episode states of ``num_envs`` envs, drawn from ``generator``
    (a torch.Generator on the map's device) on that device. ``n_ok`` is
    bank_accept_count(cfg, maps), counted here when None.

    On a stack of maps env b lives on member (offset + b) % n_maps
    (initial_map_indices; ``offset`` is the batch's first global index
    when it is one rank's slice): it spawns on that member with its own bank,
    carries its NPCs and takes its randomization draw on the stack's
    padded grid (dtown.env.reset with select_map)."""
    dev = maps.obj_pos.device
    if generator.device.type != dev.type:
        raise ValueError(f"the generator is on {generator.device}, the map "
                         f"on {dev}: draws stay on the state's device")
    if maps.is_stack:
        idx = initial_map_indices(maps, num_envs, dev, offset)
        out = None
        for m in range(maps.n_maps):
            st = reset(cfg, maps.map_at(m), generator, num_envs)
            out = st if out is None else tree_where(idx == m, st, out)
        return out.replace(map_idx=idx)
    if n_ok is None:
        n_ok = bank_accept_count(cfg, maps)
    override = cfg.start_pose is not None or cfg.user_tile_start is not None
    idxs = proposals = None
    if cfg.spawn_mode == "bank" and not override:
        idxs = torch.randint(0, n_ok, (num_envs, NTRY),
                             generator=generator, device=dev)
    noise = torch.randn((num_envs, maps.max_objects), generator=generator,
                        device=dev)
    rand = randomization.draw(cfg, num_envs, maps.grid_shape,
                              maps.max_objects, dev, generator=generator)
    if cfg.spawn_mode != "bank" and not override:
        pos, angle = propose_spawns(maps, generator, num_envs,
                                    cfg.spawn_attempts)
        fb = torch.randint(0, n_ok, (num_envs,), generator=generator,
                           device=dev)
        proposals = (pos, angle, fb)
    return reset_from_draws(cfg, maps, idxs, noise, rand, proposals)


# ---------------------------------------------------------------------------
# Map indices
# ---------------------------------------------------------------------------

def initial_map_indices(maps, num_envs: int, device, offset: int = 0):
    """Per-env map index on ``device``: env b on member (offset + b) %
    n_maps of a stack (a sticky round-robin curriculum over the global
    env index; ``offset`` is a rank slice's first), all zeros on a single
    map."""
    return torch.arange(offset, offset + num_envs, dtype=torch.int32,
                        device=device) % maps.n_maps
