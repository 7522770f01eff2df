"""Fused rollout: blob-state steps driven by the two CUDA kernels.

Counterpart of dtown/ops/fused_env.py. The rollout carries the transposed
state blob [nf, B] (ops/state_kernel.py; nf = nf_for(n_npc, domain_rand));
each step is one state step and, for camera observations, one blob render
(render/blob_raster.py), with no other work between them:

    blob --state_step--> blob' --render_frames_from_blob--> u8 [B, C, S, 128]

State observations (``obs_type="state"``) read the 11 columns straight
from the blob's rows, so that path runs the state kernel alone. EnvState
<-> blob conversion (``pack_blob``, ``update_states_from_blob``) happens
once at the rollout's boundary.

A scene past the blob render's budget (more than 48 objects or 8 moving
NPCs; a stack past 8 maps, or of more than one tile size) has no render
plan: its frames come from the EnvState that ``update_states_from_blob``
writes from the blob into a template of states (``template_states``),
through the row-fed render K4 on one map (planes [B, 3, S, 128]) or the
XLA ray-caster on a stack (frames [B, H, W, C]), as in the reference's
``render_rgb_from_blob``.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU, where the plain torch versions run instead of the kernels.
Scope: single maps and stacks of maps (map_loader.stack_maps; env b on
member b % n_maps, kept across resets), with moving NPCs, domain
randomization, RGB or grayscale frames, or state vectors; and the Nav task
(``make_fused_nav_rollout``: goal tiles in the blob, checked and redrawn
inside the state kernel).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dtown_torch import constants as C
from dtown_torch import env
from dtown_torch import objects as objlib
from dtown_torch import randomization
from dtown_torch import tasks
from dtown_torch.device import resolve_device
from dtown_torch.geometry import get_lane_pos2
from dtown_torch.ops import state_kernel as sk
from dtown_torch.render import blob_raster as br
from dtown_torch.render import raster, row_raster
from dtown_torch.types import EnvConfig, EnvState, tree_where
from dtown_torch.utils.profiling import span

_DEG2RAD = float(np.float32(np.pi / 180.0))


def _opt_bits(maps):
    """The optional objects in bit order: bit k of the DR_OBJVIS row is the
    visibility of _opt_bits(maps)[k] = (member map or None, slot), the
    optional slots of each member in mask-column order, map-major (the
    state kernel's opt_cols and the render plan's opt_bit)."""
    host = maps.numpy()

    def slots(h):
        optional = np.asarray(h.obj_optional)
        return [int(s) for s in np.nonzero(np.asarray(h.obj_mask))[0]
                if bool(optional[int(s)])]

    if host.is_stack:
        return [(m, s) for m in range(host.n_maps)
                for s in slots(host.map_at(m))]
    return [(None, s) for s in slots(host)]


def pack_blob(states, maps, domain_rand, rng, nav_goal=None):
    """Batched EnvState -> blob f32 [nf, B] on the states' device.

    rng: int tensor [B], the per-env counter of the kernel's hash draws
    (stored mod 65536). The moving NPCs' rows come from states.dyn and,
    with domain_rand, the randomization rows from the states' draws,
    optional-object visibility packed as the DR_OBJVIS bitmask; nav_goal
    (int [B, 2] goal tiles) adds the Nav rows. On a stack an NPC's rows of
    an env on another member hold the NPC's initial pose (slot s of that
    env is another object): junk by design, gated in the kernels."""
    B = states.pos.shape[0]
    dev = states.pos.device
    f32 = torch.float32
    npcs = sk.moving_npcs(maps.numpy())
    rows = torch.zeros((sk.nf_for(len(npcs), domain_rand,
                                  nav_goal is not None), B), dtype=f32,
                       device=dev)
    rows[sk.F_POS_X] = states.pos[:, 0]
    rows[sk.F_POS_Y] = states.pos[:, 1]
    rows[sk.F_POS_Z] = states.pos[:, 2]
    rows[sk.F_ANGLE] = states.angle
    rows[sk.F_SPEED] = states.speed
    rows[sk.F_WVL] = states.wheel_vels[:, 0]
    rows[sk.F_WVR] = states.wheel_vels[:, 1]
    rows[sk.F_STEP] = states.step_count.to(f32)
    rows[sk.F_RNG] = (rng.to(torch.int64) % 65536).to(f32)
    rows[sk.F_ROBOT_SPEED] = states.robot_speed
    rows[sk.F_WHEEL_DIST] = states.wheel_dist
    rows[sk.F_ENVID] = torch.arange(B, dtype=f32, device=dev)
    rows[sk.F_MAPID] = states.map_idx.to(f32)
    for i, npc in enumerate(npcs):
        base = sk.F_NPC_BASE + sk.NPC_ROWS * i
        s = npc["slot"]
        vals = (states.dyn.pos[:, s, 0], states.dyn.pos[:, s, 2],
                states.dyn.angle[:, s], states.dyn.walk_dist[:, s],
                states.dyn.vel[:, s])
        if npc["map"] is not None:
            on = states.map_idx == npc["map"]
            v0 = (C.DUCKIE_WALK_SPEED if npc["kind"] == "duckie"
                  else C.DUCKIEBOT_VEL)
            park = (npc["x0"], npc["z0"], npc["a0"], 0.0, float(v0))
            vals = [torch.where(on, v, d) for v, d in zip(vals, park)]
        rows[base:base + sk.NPC_ROWS] = torch.stack(list(vals))
    if nav_goal is not None:
        nvb = sk.nav_base(len(npcs), domain_rand)
        rows[nvb + sk.NAV_GI] = nav_goal[:, 0].to(f32)
        rows[nvb + sk.NAV_GJ] = nav_goal[:, 1].to(f32)
    if domain_rand:
        drb = sk.dr_base(len(npcs))
        vis = torch.zeros((B,), dtype=f32, device=dev)
        # a bit of another member reads the env's same slot: junk by
        # design, gated by the kernels' map tests
        for k, (_, s) in enumerate(_opt_bits(maps)):
            vis = vis + torch.where(states.obj_visible[:, s],
                                    float(1 << k), 0.0)
        rows[drb:drb + sk.DR_ROWS] = torch.stack([
            states.cam_fov_y, states.cam_height, states.cam_angle,
            states.cam_fwd_dist, states.light_dir[:, 0],
            states.light_dir[:, 1], states.light_dir[:, 2],
            states.light_ambient, states.ground_color[:, 0],
            states.ground_color[:, 1], states.ground_color[:, 2],
            states.horizon_color[:, 0], states.horizon_color[:, 1],
            states.horizon_color[:, 2], states.tex_seed.to(f32), vis])
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


def update_states_from_blob(states, blob, maps, domain_rand):
    """Write the blob's rows back into a batched EnvState: the pose rows,
    the moving NPCs' rows into states.dyn (time and traffic-light phase
    rebuilt from the env's step time) and, with domain_rand, the
    randomization rows (texture variants re-hashed from the seed). On a
    stack an NPC's rows and an optional bit are written back only into the
    envs on its member map (two members can share a slot index)."""
    npcs = sk.moving_npcs(maps.numpy())
    mi = states.map_idx
    if domain_rand:
        drb = sk.dr_base(len(npcs))
        r = lambda k: blob[drb + k]
        seed = r(sk.DR_TEXSEED).to(torch.int32)
        vis = states.obj_visible.clone()
        for k, (m, s) in enumerate(_opt_bits(maps)):
            bit = (torch.floor(r(sk.DR_OBJVIS) / float(1 << k))
                   .to(torch.int32) & 1) > 0
            vis[:, s] = bit if m is None else torch.where(mi == m, bit,
                                                          vis[:, s])
        states = states.replace(
            cam_fov_y=r(sk.DR_FOV), cam_height=r(sk.DR_CAMH),
            cam_angle=r(sk.DR_CAMA), cam_fwd_dist=r(sk.DR_CAMF),
            light_dir=torch.stack([r(sk.DR_LX), r(sk.DR_LY), r(sk.DR_LZ)],
                                  -1),
            light_ambient=r(sk.DR_AMB),
            ground_color=torch.stack(
                [r(sk.DR_GR), r(sk.DR_GG), r(sk.DR_GB)], -1),
            horizon_color=torch.stack(
                [r(sk.DR_HR), r(sk.DR_HG), r(sk.DR_HB)], -1),
            tex_seed=seed,
            tex_variant=randomization.tex_variants(
                seed, states.tex_variant.shape[-2:]),
            robot_speed=blob[sk.F_ROBOT_SPEED],
            wheel_dist=blob[sk.F_WHEEL_DIST],
            obj_visible=vis)
    dyn = states.dyn
    if npcs:
        pos, ang = dyn.pos.clone(), dyn.angle.clone()
        walk, vel = dyn.walk_dist.clone(), dyn.vel.clone()
        for i, npc in enumerate(npcs):
            base = sk.F_NPC_BASE + sk.NPC_ROWS * i
            s = npc["slot"]
            if npc["map"] is None:
                put = lambda cur, v: v
            else:
                on = mi == npc["map"]
                put = lambda cur, v: torch.where(on, v, cur)
            pos[:, s, 0] = put(pos[:, s, 0], blob[base + 0])
            pos[:, s, 2] = put(pos[:, s, 2], blob[base + 1])
            ang[:, s] = put(ang[:, s], blob[base + 2])
            walk[:, s] = put(walk[:, s], blob[base + 3])
            vel[:, s] = put(vel[:, s], blob[base + 4])
        t_env = blob[sk.F_TIME][:, None]
        period = torch.full((), C.TRAFFICLIGHT_PERIOD, device=blob.device)
        dyn = dyn.replace(
            pos=pos, angle=ang, walk_dist=walk, vel=vel,
            time=t_env.expand_as(dyn.time).clone(),
            phase=(torch.floor(t_env / period).to(torch.int32) % 2)
            .expand_as(dyn.phase).clone())
    return states.replace(
        pos=torch.stack([blob[sk.F_POS_X], blob[sk.F_POS_Y],
                         blob[sk.F_POS_Z]], -1),
        angle=blob[sk.F_ANGLE], speed=blob[sk.F_SPEED],
        wheel_vels=torch.stack([blob[sk.F_WVL], blob[sk.F_WVR]], -1),
        step_count=blob[sk.F_STEP].to(torch.int32), dyn=dyn)


def _state_obs(blob, dist, dot_dir, angle_rad, inlane):
    """The 11-column state observation f32 [B, 11] (env.render_obs
    layout) from the blob's pose rows and lane features."""
    a = blob[sk.F_ANGLE]
    return torch.stack([
        blob[sk.F_POS_X], blob[sk.F_POS_Z], torch.cos(a), torch.sin(a),
        blob[sk.F_SPEED], dist * inlane, dot_dir * inlane,
        angle_rad * inlane, inlane, blob[sk.F_WVL], blob[sk.F_WVR]], -1)


def state_obs_from_blob(blob):
    """The fused step's state observation f32 [B, 11] from the blob: pose
    rows and the observation-side lane rows (F_O*), which on a done step
    hold the fresh spawn's lane features while F_L* keep the dying step's
    for the outputs."""
    inlane = blob[sk.F_OINLANE]
    return _state_obs(blob, blob[sk.F_OLDIST], blob[sk.F_OLDOT],
                      blob[sk.F_OLDEG] * _DEG2RAD, inlane)


def template_states(cfg, maps, num_envs: int):
    """The EnvState that the planless render reads besides the blob rows:
    nominal reset-time fields (camera, light, colours, texture variants;
    with domain randomization the blob's rows overwrite them) and each
    env's initial object poses on its member (env b on member b % n_maps),
    on the map's device. The pose, NPC and randomization fields come from
    the blob at every step (update_states_from_blob).

    The reference builds the whole template from member 0 of a stack, so
    an env on another member would draw that member's static objects at
    member 0's slot poses; here each env takes its own member's poses,
    which is the same on a stack of one map repeated."""
    dev = maps.obj_pos.device
    gen = torch.Generator(device=dev).manual_seed(0)

    def one(m):
        rand = randomization.draw(cfg, num_envs, maps.grid_shape,
                                  maps.max_objects, dev, generator=gen)
        zero = torch.zeros((num_envs,), dtype=torch.float32, device=dev)
        return EnvState(
            pos=torch.zeros((num_envs, 3), device=dev), angle=zero,
            step_count=torch.zeros((num_envs,), dtype=torch.int32,
                                   device=dev),
            speed=zero, wheel_vels=torch.zeros((num_envs, 2), device=dev),
            last_action=torch.zeros((num_envs, 2), device=dev),
            map_idx=env.initial_map_indices(maps, num_envs, dev),
            dyn=objlib.init_dyn_state(m, num_envs), **rand)

    return env.per_member(
        maps, env.initial_map_indices(maps, num_envs, dev), one)


def render_rgb_from_blob(cfg, maps, blob, pk):
    """Frames of the blob's current state: through the blob render with a
    packed plan, or, with the planless pack (``planless_pack``), through
    K4 on one map (planes uint8 [B, 3, S, 128]) or the XLA ray-caster on a
    stack (uint8 [B, H, W, C]). ``maps`` is the map on the blob's
    device."""
    if not pk.get("planless"):
        return br.render_frames_from_blob(blob, pk)
    states = update_states_from_blob(pk["template"], blob, maps,
                                     cfg.domain_rand)
    if maps.is_stack:
        return raster.render_frame(cfg, maps, states)
    return row_raster.render_frames_rows(cfg, maps, states, pack=pk["rows"])


def planless_pack(cfg, maps, num_envs: int):
    """What render_rgb_from_blob needs for a scene without a render plan
    (``maps`` on the device): the template states and, on one map, K4's
    row-render pack."""
    return dict(planless=True, template=template_states(cfg, maps, num_envs),
                rows=None if maps.is_stack
                else row_raster.pack_row_scene(cfg, maps))


def obs_from_blob(cfg, maps, blob, pk=None):
    """Observation of the blob's current state without stepping (the
    first observation of a rollout): frames through render_rgb_from_blob
    with the rollout's pack ``pk`` (fused_step.pack), or state vectors
    whose lane features come from geometry.get_lane_pos2 on the blob's
    pose, each env on its own member of a stack. ``maps`` is the map on
    the blob's device."""
    if cfg.obs_type == "rgb":
        return render_rgb_from_blob(cfg, maps, blob, pk)
    pos = torch.stack([blob[sk.F_POS_X], blob[sk.F_POS_Y],
                       blob[sk.F_POS_Z]], -1)
    if maps.is_stack:
        mi = blob[sk.F_MAPID].to(torch.int32)
        lp = None
        for m in range(maps.n_maps):
            lp_m = get_lane_pos2(maps.map_at(m), pos, blob[sk.F_ANGLE])
            lp = lp_m if lp is None else tree_where(mi == m, lp_m, lp)
    else:
        lp = get_lane_pos2(maps, pos, blob[sk.F_ANGLE])
    inlane = lp.in_lane.to(torch.float32)
    return _state_obs(blob, lp.dist, lp.dot_dir, lp.angle_rad, inlane)


def nav_goal_features_from_blob(cfg, maps, blob):
    """The Nav goal in the agent's frame from the blob's goal and pose rows
    (tasks.goal_features without a lane query): the goal tile centre's
    offset (forward, right) and its distance, three f32 [B] columns."""
    navb = sk.nav_base(len(sk.moving_npcs(maps.numpy())), cfg.domain_rand)
    ts = torch.as_tensor(np.asarray(maps.numpy().tile_size, np.float32),
                         device=blob.device)
    return _goal_features(blob, navb, ts)


def _goal_features(blob, navb, ts):
    """nav_goal_features_from_blob with the Nav rows' base and the tile
    size (a 0-d tensor, or one per member of a stack) given."""
    if ts.dim() == 1:   # a stack: the env's member's tile size
        ts = ts[blob[sk.F_MAPID].long()]
    dx = (blob[navb + sk.NAV_GI] + 0.5) * ts - blob[sk.F_POS_X]
    dz = (blob[navb + sk.NAV_GJ] + 0.5) * ts - blob[sk.F_POS_Z]
    c = torch.cos(blob[sk.F_ANGLE])
    s = torch.sin(blob[sk.F_ANGLE])
    return dx * c - dz * s, dx * s + dz * c, torch.sqrt(dx * dx + dz * dz)


def _setup(cfg, maps, num_envs, device, nav):
    """What both fused rollouts build once: the device, the state kernel's
    tables (with the goal table under Nav), the render pack (the packed
    blob-render plan, or planless_pack past the plan's budget; None for
    state observations) and the map on the device."""
    dev = resolve_device(device)
    if num_envs % 8 != 0:
        raise ValueError(f"num_envs must be divisible by 8; got {num_envs}")
    # the render options are the blob render's to refuse (pack_plan)
    env.check_scope(cfg, maps)
    tables = sk.build_tables(cfg, maps)
    st = sk.device_tables(cfg, tables, dev,
                          sk.build_goal_table(maps) if nav else None)
    maps_d = maps.to(dev)
    pk = None
    if cfg.obs_type == "rgb":
        plan = br.build_render_plan(cfg, maps)
        pk = (br.pack_plan(cfg, plan, dev) if plan is not None
              else planless_pack(cfg, maps_d, num_envs))
    return dev, st, pk, maps_d


def make_fused_rollout(cfg: EnvConfig, maps, num_envs: int,
                       device="cuda"):
    """(init_blob, fused_step, rollout) of the fused rollout on one map or
    a stack of maps (map_loader.stack_maps).

    init_blob(generator) -> blob f32 [nf, B]: fresh states from env.reset
    (bank spawns, NPC speeds, randomization draws; on a stack env b on
    member b % n_maps) and the hash counters, all drawn from
    ``generator``, a torch.Generator on the rollout's device.
    fused_step(blob, actions[B, 2]) -> (blob, StepOutput, obs): obs is u8
    [B, C, S, 128] frames (C = 1 under grayscale; past the render plan's
    budget K4's 3 planes on one map, u8 [B, H, W, C] on a stack) or f32
    [B, 11] state vectors. fused_step.tables and fused_step.pack are the
    kernels' device tables and the render pack (the packed plan or
    planless_pack; None for state observations).
    rollout(blob, actions, n_iters) -> (blob, reward_sum, obs_checksum):
    n_iters fused steps with fixed actions; reward_sum is the last step's
    reward summed over envs, obs_checksum the sum of the last frame's
    first plane row (int64), or of the last state vectors (int32), as in
    the reference.
    """
    return _make_rollout(cfg, maps, num_envs, device, nav=False,
                         goal_in_obs=False)


def make_fused_nav_rollout(cfg: EnvConfig, maps, num_envs: int,
                           goal_in_obs: bool = False, device="cuda"):
    """(init_blob, fused_step, rollout) of the Nav task on the fused
    rollout (dtown's DuckietownNav / tasks.nav_step): each env carries a
    goal tile in its blob rows; entering it scores +NAV_GOAL_REWARD (plus
    the optional distance shaping, cfg.nav_shaping_coef) and ends the
    episode, and the reset draws a fresh goal on the env's map, all inside
    the state kernel. ``maps`` is one map or a stack.

    init_blob(generator) -> blob: fresh states and first goals
    (tasks.draw_goal), drawn from ``generator``. fused_step(blob, actions)
    -> (blob, StepOutput, obs) with make_fused_rollout's observations; with
    goal_in_obs the goal in the agent's frame (forward, right, distance)
    joins them: state vectors grow to f32 [B, 14], and frames become the
    tuple (planes, goal f32 [B, 3]). fused_step.tables, fused_step.pack and
    rollout as in make_fused_rollout (the checksum reads the planes)."""
    return _make_rollout(cfg, maps, num_envs, device, nav=True,
                         goal_in_obs=goal_in_obs)


def _make_rollout(cfg, maps, num_envs, device, nav, goal_in_obs):
    """Both fused rollouts: the Nav task (``nav``) adds the goal draw at
    init and, with ``goal_in_obs``, the goal features to the observation."""
    dev, st, pk, maps_d = _setup(cfg, maps, num_envs, device, nav)
    # the goal features' constants, once: no host work per step
    navb = sk.nav_base(st["n_npc"], cfg.domain_rand)
    ts = maps_d.tile_size.to(torch.float32)

    def init_blob(generator: torch.Generator):
        states = env.reset(cfg, maps_d, generator, num_envs)
        rng = torch.randint(0, 65536, (num_envs,), generator=generator,
                            device=dev)
        goal = (tasks.draw_goal(maps_d, states.map_idx, generator) if nav
                else None)
        return pack_blob(states, maps_d, cfg.domain_rand, rng,
                         nav_goal=goal)

    def fused_step(blob, actions):
        with span("fused_step"):
            with span("state_step"):
                blob = sk.state_step(blob, actions, st)
            with span("render"):
                if pk is not None:
                    obs = render_rgb_from_blob(cfg, maps_d, blob, pk)
                    if goal_in_obs:
                        obs = (obs, torch.stack(
                            _goal_features(blob, navb, ts), -1))
                else:
                    obs = state_obs_from_blob(blob)
                    if goal_in_obs:
                        obs = torch.cat([obs, torch.stack(
                            _goal_features(blob, navb, ts), -1)], -1)
            with span("outputs"):
                out = unpack_outputs(blob)
        return blob, out, obs

    def rollout(blob, actions, n_iters: int):
        rsum = osum = None
        for _ in range(n_iters):
            blob, out, obs = fused_step(blob, actions)
            rsum = out.reward.sum()
            if pk is not None:
                planes = obs[0] if goal_in_obs else obs
                osum = planes[:, 0, 0, :].sum(dtype=torch.int64)
            else:
                osum = obs.sum().to(torch.int32)
        return blob, rsum, osum

    fused_step.tables, fused_step.pack = st, pk
    return init_blob, fused_step, rollout
