"""The vectorized env core: batched reset / step with auto-reset (torch).

Counterpart of dtown/env.py's vectorized API (``step_physics``,
``render_obs_batch``, ``step_batch``, ``make_vec_env``). The reference
vmaps per-env functions; here every function takes a batch of B envs
(EnvState fields carry B as their leading dimension). Random draws come
from an explicit torch.Generator on the state's device; each draw is
split from its deterministic core (``_bank_spawn`` takes the candidate
indices, ``objects.init_dyn_state`` the normal noise,
``randomization.draw_from_uniforms`` the domain-randomization uniforms)
so tests can feed both implementations the same draws.

Static branches (objects present, NPCs present) and the spawn bank's
accepted prefix are decided once on the host from the numpy map
(``host_facts``), never from device tensors: a step makes no host sync.

Scope: bank spawns, with or without domain randomization; RGB
observations through the row-fed render kernels (render/row_raster.py,
``renderer="pallas"``) or the 11-column state vector. ``reset`` also
takes a stack of maps (each env on its own member, assigned round-robin),
which the fused rollout uses; the step path runs single maps only. The
options not ported yet raise NotImplementedError from ``check_scope``
(shared with the fused rollout), ``check_single_map`` and, for RGB
observations, ``check_row_render_scope``; ``make_vec_env`` runs all three
once.
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
from dtown_torch.geometry import get_lane_pos2, norm3
from dtown_torch.types import EnvConfig, EnvState, MapArrays, StepOutput, \
    tree_where

NTRY = 8  # bank candidates per spawn


def check_scope(cfg: EnvConfig, maps: MapArrays):
    """Raise NotImplementedError for the options neither the step path nor
    the fused rollout has yet, naming the missing piece, and ValueError for
    an unknown obs_type. ``maps`` is one map or a stack of maps
    (map_loader.stack_maps); a list of maps is refused."""
    if isinstance(maps, (list, tuple)):
        raise TypeError("pass one map or a stack of maps "
                        "(dtown_torch.stack_maps(names)), not a list")
    if cfg.spawn_mode != "bank":
        raise NotImplementedError(
            f"spawn_mode={cfg.spawn_mode!r} (rejection sampling, "
            "env._sample_spawn) is not ported yet; use spawn_mode='bank'")
    if cfg.start_pose is not None or cfg.user_tile_start is not None:
        raise NotImplementedError(
            "start_pose / user_tile_start overrides are not ported yet")
    if cfg.obs_type not in ("rgb", "state"):
        raise ValueError(f"unknown obs_type {cfg.obs_type}")


def check_single_map(maps):
    """Raise NotImplementedError for a multimap on the step path: the
    reference renders stacks there with its XLA ray-caster
    (render/raster.py), which is not ported yet."""
    if isinstance(maps, (list, tuple)) or maps.is_stack:
        raise NotImplementedError(
            "stacked multimaps on the step path (make_vec) need the XLA "
            "ray-caster render/raster.py, which is not ported yet; the "
            "fused rollout (make_fused_rollout) takes stacks")


def check_row_render_scope(cfg: EnvConfig):
    """Raise NotImplementedError for a renderer the step path does not
    have yet. Fisheye renders through the row-fed kernels' NDC table, and
    mesh_fidelity is ignored there, as in the reference (OBJ kinds render
    as their material boxes)."""
    if cfg.renderer != "pallas":
        raise NotImplementedError(
            f"renderer={cfg.renderer!r}: the XLA ray-caster "
            "(render/raster.py) is not ported yet; pass "
            "renderer='pallas' for the row-fed CUDA render kernels")


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
    accepted prefix that resets draw from."""

    has_obj: bool
    has_dyn: bool
    n_ok: int


def host_facts(cfg, maps) -> HostFacts:
    host = maps.numpy()
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


def reset_from_draws(cfg, maps, idxs, duckie_noise, rand=None) -> EnvState:
    """Fresh episode states from the reset's draws: bank candidate indices
    idxs [B, NTRY], standard-normal duckie speed noise [B, M] and the
    randomization fields ``rand`` (randomization.draw or
    draw_from_uniforms; None gives the nominal ones, without domain
    randomization)."""
    B = idxs.shape[0]
    dev = maps.obj_pos.device
    if rand is None:
        rand = randomization.draw(cfg, B, maps.grid_shape, maps.max_objects,
                                  dev)
    dyn = objlib.init_dyn_state(maps, B, noise=duckie_noise)
    obj_active = maps.obj_mask & (~maps.obj_optional | rand["obj_visible"])
    pos, angle = _bank_spawn(cfg, maps, dyn.pos, obj_active, idxs)
    zeros = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype,
                                                        device=dev)
    return EnvState(
        pos=pos, angle=angle,
        step_count=zeros(B, dtype=torch.int32), speed=zeros(B),
        wheel_vels=zeros(B, 2), last_action=zeros(B, 2),
        map_idx=initial_map_indices(maps, B, dev), dyn=dyn, **rand)


def reset(cfg, maps, generator: torch.Generator, num_envs: int,
          n_ok: int | None = None) -> EnvState:
    """Fresh episode states of ``num_envs`` envs, drawn from ``generator``
    (a torch.Generator on the map's device) on that device. ``n_ok`` is
    bank_accept_count(cfg, maps), counted here when None.

    On a stack of maps env b lives on member b % n_maps
    (initial_map_indices): it spawns from that member's bank with its own
    accepted prefix, carries its NPCs and takes its randomization draw on
    the stack's padded grid (dtown.env.reset with select_map)."""
    dev = maps.obj_pos.device
    if generator.device.type != dev.type:
        raise ValueError(f"the generator is on {generator.device}, the map "
                         f"on {dev}: draws stay on the state's device")
    if maps.is_stack:
        idx = initial_map_indices(maps, num_envs, dev)
        out = None
        for m in range(maps.n_maps):
            st = reset(cfg, maps.map_at(m), generator, num_envs)
            out = st if out is None else tree_where(idx == m, st, out)
        return out.replace(map_idx=idx)
    if n_ok is None:
        n_ok = bank_accept_count(cfg, maps)
    idxs = torch.randint(0, n_ok, (num_envs, NTRY),
                         generator=generator, device=dev)
    noise = torch.randn((num_envs, maps.max_objects), generator=generator,
                        device=dev)
    rand = randomization.draw(cfg, num_envs, maps.grid_shape,
                              maps.max_objects, dev, generator=generator)
    return reset_from_draws(cfg, maps, idxs, noise, rand)


# ---------------------------------------------------------------------------
# Observation
# ---------------------------------------------------------------------------

def render_obs(cfg, maps, state, lane_pos=None):
    """State observation of every env, f32 [B, 11]: x, z, cos, sin, speed,
    then lane distance, alignment and angle (0 off-lane), in-lane, and the
    two wheel velocities. RGB frames come from ``render_obs_batch``."""
    if cfg.obs_type != "state":
        raise NotImplementedError(
            "per-env RGB rendering is the XLA ray-caster (render/raster.py),"
            " not ported yet; render_obs_batch renders with "
            "renderer='pallas'")
    lp = lane_pos if lane_pos is not None else get_lane_pos2(
        maps, state.pos, state.angle)
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

def step_physics(cfg, maps, state, action, generator=None, facts=None):
    """One step of every env without the observation: dynamics -> NPC
    updates -> validity -> reward -> auto-reset (fresh states drawn from
    ``generator`` for every env, kept where done). ``facts`` is
    host_facts(cfg, maps), decided here when None. Returns (new_state,
    StepOutput with obs=None, lane_pos)."""
    if facts is None:
        facts = host_facts(cfg, maps)
    action = torch.nan_to_num(action.to(torch.float32), nan=0.0,
                              posinf=1e6, neginf=-1e6)
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
    if cfg.auto_reset:
        if generator is None:
            raise ValueError("auto_reset draws fresh states: pass the "
                             "torch.Generator of the batch")
        fresh = reset(cfg, maps, generator, state.batch_size, facts.n_ok)
        new_state = tree_where(done, fresh, new_state)

    out = StepOutput(
        obs=None, reward=reward, done=done, lane_dist=lp.dist,
        lane_dot_dir=lp.dot_dir, lane_angle_deg=lp.angle_deg,
        in_lane=lp.in_lane, collision=collided,
        timestamp=step_count.to(torch.float32) * dt)
    return new_state, out, lp


def render_obs_batch(cfg, maps, states, pack=None):
    """Batched observation: RGB (or grayscale) frames uint8 [B, H, W, C]
    through the row-fed render kernels, or state vectors f32 [B, 11].
    ``pack`` is row_raster.pack_row_scene(cfg, maps), built when None."""
    if cfg.obs_type == "state":
        return render_obs(cfg, maps, states)
    from dtown_torch.render import row_raster

    planes = row_raster.render_frames_rows(cfg, maps, states, pack=pack)
    obs = row_raster.planes_to_nhwc(cfg, planes)
    if cfg.grayscale:
        f = obs.to(torch.float32)
        luma = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
        obs = luma.to(torch.uint8)[..., None]
    return obs


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

def initial_map_indices(maps, num_envs: int, device):
    """Per-env map index on ``device``: env b on member b % n_maps of a
    stack (a sticky round-robin curriculum), all zeros on a single map."""
    return torch.arange(num_envs, dtype=torch.int32,
                        device=device) % maps.n_maps


def make_vec_env(cfg: EnvConfig, maps: MapArrays, num_envs: int,
                 device="cuda"):
    """(v_reset, v_step) over a batch of ``num_envs`` envs on ``device``.

    v_reset(generator) -> EnvState: fresh states drawn from ``generator``
    (a torch.Generator on ``device``), which the batch keeps: v_step draws
    its auto-reset states from it.
    v_step(states, actions[B, 2]) -> (states, StepOutput with obs).
    Runs on the card unless ``device="cpu"``, where the plain torch
    versions of the render kernels run. ``maps`` may be the numpy map or
    a tensor copy; the batch works on its own copy on ``device``, which
    v_step carries as ``v_step.maps`` with its render pack
    (``v_step.pack``, None for state observations). The options not
    ported yet raise here, and the map's static branches are decided here,
    once."""
    dev = resolve_device(device)
    check_single_map(maps)
    check_scope(cfg, maps)
    maps_d = maps.to(dev)
    facts = host_facts(cfg, maps_d)
    pack = None
    if cfg.obs_type == "rgb":
        from dtown_torch.render import row_raster

        check_row_render_scope(cfg)

        pack = row_raster.pack_row_scene(cfg, maps_d)
    batch = {}

    def v_reset(generator: torch.Generator) -> EnvState:
        batch["generator"] = generator
        return reset(cfg, maps_d, generator, num_envs, facts.n_ok)

    def v_step(states, actions):
        gen = batch.get("generator")
        if gen is None and cfg.auto_reset:
            raise RuntimeError("call v_reset(generator) before v_step")
        return step_batch(cfg, maps_d, states, actions, generator=gen,
                          pack=pack, facts=facts)

    v_step.maps, v_step.pack = maps_d, pack
    return v_reset, v_step
