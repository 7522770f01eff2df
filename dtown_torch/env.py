"""The vectorized env core: batched reset / step with auto-reset (torch).

Counterpart of dtown/env.py (``reset``, ``step_physics``, ``render_obs``,
``step``, ``render_obs_batch``, ``step_batch``, ``make_vec_env``). The
reference vmaps per-env functions; here every function takes a batch of B
envs (EnvState fields carry B as their leading dimension). Random draws
come from an explicit torch.Generator on the state's device; each draw is
split from its deterministic core (``_bank_spawn`` takes the candidate
indices, ``sample_spawn`` the rejection sampler's proposals,
``objects.init_dyn_state`` the normal noise,
``randomization.draw_from_uniforms`` the domain-randomization uniforms)
so tests can feed both implementations the same draws.

Static branches (objects present, NPCs present) and the spawn bank's
accepted prefix are decided once on the host from the numpy map
(``host_facts``), never from device tensors: a step makes no host sync.

Spawns: the precomputed bank (``spawn_mode="bank"``), rejection sampling
(any other mode), or the ``start_pose`` / ``user_tile_start`` overrides.
Observations: the 11-column state vector, or camera frames from the XLA
ray-caster as batched torch (render/raster.py, ``renderer="xla"``, the
default) or, with ``renderer="pallas"`` on one map, from the row-fed
render kernels (render/row_raster.py). A stack of maps (map_loader.
stack_maps) runs too: env b lives on member b % n_maps, its physics and
lane queries read that member, its frames come from the ray-caster.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dtown_torch import constants as C
from dtown_torch import objects as objlib
from dtown_torch import physics
from dtown_torch import randomization
from dtown_torch.device import resolve_device
from dtown_torch.dynamics import integrate, wheel_model
from dtown_torch.geometry import bezier_closest, bezier_point, \
    bezier_tangent, get_lane_pos2, norm3
from dtown_torch.types import EnvConfig, EnvState, MapArrays, StepOutput, \
    tree_where

NTRY = 8  # bank candidates per spawn


def check_scope(cfg: EnvConfig, maps: MapArrays):
    """Raise for what neither the step path nor the fused rollout takes:
    ValueError for an unknown obs_type, TypeError for a list of maps
    (``maps`` is one map or a stack of maps, map_loader.stack_maps)."""
    if isinstance(maps, (list, tuple)):
        raise TypeError("pass one map or a stack of maps "
                        "(dtown_torch.stack_maps(names)), not a list")
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
# Observation
# ---------------------------------------------------------------------------

def per_member(maps, map_idx, fn):
    """fn(map) of every env on its own map: on a stack fn runs on each
    member and env b keeps member map_idx[b]'s result (a dataclass or a
    tuple of them)."""
    if not maps.is_stack:
        return fn(maps)
    out = None
    for m in range(maps.n_maps):
        r = fn(maps.map_at(m))
        if out is None:
            out = r
        elif isinstance(r, tuple):
            out = tuple(tree_where(map_idx == m, a, b)
                        for a, b in zip(r, out))
        else:
            out = tree_where(map_idx == m, r, out)
    return out


def render_obs(cfg, maps, state, lane_pos=None):
    """Observation of every env: the state vector f32 [B, 11] (x, z, cos,
    sin, speed, then lane distance, alignment and angle (0 off-lane),
    in-lane, and the two wheel velocities), or camera frames uint8
    [B, H, W, C] from the XLA ray-caster (render/raster.py). On a stack
    each env reads its own member."""
    if cfg.obs_type == "rgb":
        from dtown_torch.render import raster

        return raster.render_frame(cfg, maps, state)
    if cfg.obs_type != "state":
        raise ValueError(f"unknown obs_type {cfg.obs_type}")
    lp = lane_pos if lane_pos is not None else per_member(
        maps, state.map_idx,
        lambda m: get_lane_pos2(m, state.pos, state.angle))
    zero = torch.zeros_like(lp.dist)
    return torch.stack([
        state.pos[:, 0], state.pos[:, 2],
        torch.cos(state.angle), torch.sin(state.angle), state.speed,
        torch.where(lp.in_lane, lp.dist, zero),
        torch.where(lp.in_lane, lp.dot_dir, zero),
        torch.where(lp.in_lane, lp.angle_rad, zero),
        lp.in_lane.to(torch.float32),
        state.wheel_vels[:, 0], state.wheel_vels[:, 1],
    ], dim=-1)


# ---------------------------------------------------------------------------
# Step
# ---------------------------------------------------------------------------

def _advance(cfg, maps, state, action, facts):
    """One step of every env on one map, without auto-reset: dynamics ->
    NPC updates -> validity -> reward. Returns (state, StepOutput with
    obs=None, lane_pos)."""
    if cfg.use_wheel_model:
        wheels = wheel_model(action, cfg.gain, cfg.trim, cfg.wheel_radius,
                             cfg.k, cfg.limit, state.wheel_dist)
    else:
        wheels = action
    wheels = torch.clamp(wheels, -1.0, 1.0)

    dt = cfg.delta_time
    pos, angle, speed, wheel_vels = integrate(
        state.pos, state.angle, wheels, state.robot_speed, state.wheel_dist,
        dt, cfg.frame_skip)

    dyn = state.dyn
    if facts.has_dyn:
        for _ in range(cfg.frame_skip):
            dyn = objlib.step_dynamic_objects(maps, dyn, dt)

    step_count = state.step_count + cfg.frame_skip
    obj_active = active_objects(maps, state)
    if facts.has_dyn:
        obj_corners, obj_norms = objlib.dynamic_corners(maps, dyn)
    else:
        obj_corners, obj_norms = maps.obj_corners, maps.obj_norms

    if facts.has_obj:
        valid, collided = physics.valid_pose(
            maps, pos, angle, obj_corners, obj_norms, obj_active)
        col_penalty = physics.proximity_penalty(
            pos, angle, dyn.pos, maps.obj_safety_rad, obj_active,
            maps.obj_is_dynamic)
    else:
        valid, collided = physics.valid_pose_no_objects(maps, pos, angle)
        col_penalty = torch.zeros_like(angle)
    lp = get_lane_pos2(maps, pos, angle)
    reward_alive = physics.compute_reward(speed, lp, col_penalty)

    truncated = step_count >= cfg.max_steps
    crashed = ~valid
    done = crashed | truncated
    reward = torch.where(crashed, C.REWARD_INVALID_POSE, reward_alive)

    new_state = state.replace(
        pos=pos, angle=angle, step_count=step_count, speed=speed,
        wheel_vels=wheel_vels, last_action=action, dyn=dyn)
    out = StepOutput(
        obs=None, reward=reward, done=done, lane_dist=lp.dist,
        lane_dot_dir=lp.dot_dir, lane_angle_deg=lp.angle_deg,
        in_lane=lp.in_lane, collision=collided,
        timestamp=step_count.to(torch.float32) * dt)
    return new_state, out, lp


def step_physics(cfg, maps, state, action, generator=None, facts=None):
    """One step of every env without the observation: dynamics -> NPC
    updates -> validity -> reward -> auto-reset (fresh states drawn from
    ``generator`` for every env, kept where done). ``facts`` is
    host_facts(cfg, maps), decided here when None. On a stack every env
    steps on its own member (each member's step runs on the batch, and env
    b keeps member map_idx[b]'s). Returns (new_state, StepOutput with
    obs=None, lane_pos)."""
    if facts is None:
        facts = host_facts(cfg, maps)
    action = torch.nan_to_num(action.to(torch.float32), nan=0.0,
                              posinf=1e6, neginf=-1e6)
    if maps.is_stack:
        members = iter(facts.members)
        new_state, out, lp = per_member(
            maps, state.map_idx,
            lambda m: _advance(cfg, m, state, action, next(members)))
    else:
        new_state, out, lp = _advance(cfg, maps, state, action, facts)
    if cfg.auto_reset:
        if generator is None:
            raise ValueError("auto_reset draws fresh states: pass the "
                             "torch.Generator of the batch")
        fresh = reset(cfg, maps, generator, state.batch_size, facts.n_ok)
        new_state = tree_where(out.done, fresh, new_state)
    return new_state, out, lp


def step(cfg, maps, state, action, generator=None, facts=None):
    """One full step of every env with its observation from render_obs
    (the XLA ray-caster for frames, whatever cfg.renderer says, as the
    reference's per-env ``step``). The lane query is reused for the
    state observation while the state was not auto-reset."""
    new_state, out, lp = step_physics(cfg, maps, state, action,
                                      generator=generator, facts=facts)
    reuse_lp = None if cfg.auto_reset else lp
    return new_state, out.replace(
        obs=render_obs(cfg, maps, new_state, lane_pos=reuse_lp))


def row_pack(cfg, maps):
    """The row-fed render's pack (row_raster.pack_row_scene) when the batch
    renders through K3/K4: RGB with ``renderer="pallas"`` on one map; else
    None (the XLA ray-caster, or state vectors)."""
    if cfg.obs_type != "rgb" or cfg.renderer != "pallas" or maps.is_stack:
        return None
    from dtown_torch.render import row_raster

    return row_raster.pack_row_scene(cfg, maps)


def render_obs_batch(cfg, maps, states, pack=None):
    """Batched observation: with ``renderer="pallas"`` on one map, RGB
    (or grayscale) frames uint8 [B, H, W, C] through the row-fed render
    kernels (``pack`` is row_pack(cfg, maps), built when None); otherwise
    render_obs (the XLA ray-caster, or state vectors)."""
    if cfg.obs_type == "rgb" and cfg.renderer == "pallas" \
            and not maps.is_stack:
        from dtown_torch.render import row_raster

        planes = row_raster.render_frames_rows(cfg, maps, states, pack=pack)
        obs = row_raster.planes_to_nhwc(cfg, planes)
        if cfg.grayscale:
            f = obs.to(torch.float32)
            luma = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
            obs = luma.to(torch.uint8)[..., None]
        return obs
    return render_obs(cfg, maps, states)


def step_batch(cfg, maps, states, actions, generator=None, pack=None,
               facts=None):
    """Batched step: physics + batched observation of the new states."""
    new_states, outs, _ = step_physics(cfg, maps, states, actions,
                                       generator=generator, facts=facts)
    return new_states, outs.replace(
        obs=render_obs_batch(cfg, maps, new_states, pack=pack))


# ---------------------------------------------------------------------------
# Vectorized convenience API
# ---------------------------------------------------------------------------

def initial_map_indices(maps, num_envs: int, device, offset: int = 0):
    """Per-env map index on ``device``: env b on member (offset + b) %
    n_maps of a stack (a sticky round-robin curriculum over the global
    env index; ``offset`` is a rank slice's first), all zeros on a single
    map."""
    return torch.arange(offset, offset + num_envs, dtype=torch.int32,
                        device=device) % maps.n_maps


def make_vec_env(cfg: EnvConfig, maps: MapArrays, num_envs: int,
                 device="cuda", env_offset: int = 0):
    """(v_reset, v_step) over a batch of ``num_envs`` envs on ``device``.

    v_reset(generator) -> EnvState: fresh states drawn from ``generator``
    (a torch.Generator on ``device``), which the batch keeps: v_step draws
    its auto-reset states from it.
    v_step(states, actions[B, 2]) -> (states, StepOutput with obs).
    Runs on the card unless ``device="cpu"``, where the plain torch
    versions of the render kernels run. ``maps`` is one map or a stack
    (map_loader.stack_maps), numpy or tensors; the batch works on its own
    copy on ``device``, which v_step carries as ``v_step.maps`` with its
    row-render pack (``v_step.pack``: None unless RGB with
    ``renderer="pallas"`` on one map) and its host facts
    (``v_step.facts``). The map's static branches are decided here,
    once. ``env_offset`` is the global index of the batch's first env when
    the batch is one rank's slice (parallel.make_sharded_env): on a stack
    env b starts on member (env_offset + b) % n_maps."""
    dev = resolve_device(device)
    check_scope(cfg, maps)
    maps_d = maps.to(dev)
    facts = host_facts(cfg, maps_d)
    pack = row_pack(cfg, maps_d)
    batch = {}

    def v_reset(generator: torch.Generator) -> EnvState:
        batch["generator"] = generator
        return reset(cfg, maps_d, generator, num_envs, facts.n_ok,
                     env_offset)

    def v_step(states, actions):
        gen = batch.get("generator")
        if gen is None and cfg.auto_reset:
            raise RuntimeError("call v_reset(generator) before v_step")
        return step_batch(cfg, maps_d, states, actions, generator=gen,
                          pack=pack, facts=facts)

    v_step.maps, v_step.pack, v_step.facts = maps_d, pack, facts
    return v_reset, v_step
