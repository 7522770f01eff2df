"""Scripted dynamic world objects as batched state machines (torch).

Counterpart of dtown/objects.py: walking duckies, traffic-light phases
and scripted duckiebots (pure pursuit on the lane bezier), one masked
update over the object slots of every env. Which species a map has is a
host-side decision on the numpy map, taken once per call shape; the
per-slot arithmetic runs only on the slots of that species, which gives
those slots the same values as the reference's all-slot update.
"""
import math

import numpy as np
import torch

from simbench.reference.frozen import constants as C
from simbench.reference.frozen import types as T
from simbench.reference.frozen.geometry import div, get_dir_vec, get_right_vec, sincos


def init_dyn_state(maps, num_envs, noise=None) -> T.DynObjState:
    """Initial dynamic-object state of ``num_envs`` envs.

    noise: standard-normal draws [B, M] for the walking duckies' speeds,
    ~N(0.02, 0.005) clipped at 0.001 as in the reference; None gives the
    nominal mean. The draw itself is the caller's (env.reset)."""
    B, M = num_envs, maps.max_objects
    dev = maps.obj_pos.device
    f = lambda v: torch.full((B, M), v, dtype=torch.float32, device=dev)
    is_duckie = maps.obj_kind == T.OBJ_KIND_IDS["duckie"]
    if noise is None:
        duckie_vel = torch.full((B, M), C.DUCKIE_WALK_SPEED,
                                dtype=torch.float32, device=dev)
    else:
        duckie_vel = torch.clamp(C.DUCKIE_WALK_SPEED + 0.005 * noise,
                                 min=0.001)
    vel = torch.where(maps.obj_is_dynamic & is_duckie, duckie_vel,
                      C.DUCKIEBOT_VEL)
    return T.DynObjState(
        pos=maps.obj_pos.expand(B, M, 3).clone(),
        angle=maps.obj_y_rot.expand(B, M).clone(),
        vel=vel, walk_dist=f(0.0), wiggle=f(C.DUCKIE_WIGGLE),
        phase=torch.zeros((B, M), dtype=torch.int32, device=dev),
        time=f(0.0),
    )


def render_angles(maps, dyn):
    """Render-time headings [B, M]: walking duckies get the gait wiggle
    (mesh only, not the collision footprint)."""
    is_walk_duckie = maps.obj_is_dynamic & (
        maps.obj_kind == T.OBJ_KIND_IDS["duckie"])
    wob = dyn.wiggle * sincos(C.DUCKIE_WIGGLE_FREQ * dyn.time)[0]
    return torch.where(is_walk_duckie, dyn.angle + wob, dyn.angle)


def _duckie_step(walk_dist_limit, pos, angle, vel, walk_dist, dt):
    """Pedestrian walk of the duckie slots: advance along the heading,
    reverse after the slot's walk distance."""
    step_len = vel * dt
    new_pos = pos + step_len[..., None] * get_dir_vec(angle)
    new_walk = walk_dist + step_len
    reverse = new_walk > walk_dist_limit
    angle = torch.where(reverse, angle + math.pi, angle)
    walk = torch.where(reverse, 0.0, new_walk)
    return new_pos, angle, walk


def _pursuit_lane_query(maps, ts_inv, qx, qz, qdx, qdz):
    """The scripted duckiebot's lane query, op for op the reference's
    (2D math, clamp forms, -1e30 sentinel). Queries of any shape.
    Returns (point_x, point_z, tan_x, tan_z, best_dot, drivable)."""
    H, W = maps.grid_shape
    where = torch.where
    fi = torch.floor(qx * ts_inv)
    fj = torch.floor(qz * ts_inv)
    ing = (fi >= 0) & (fi < W) & (fj >= 0) & (fj < H)
    ii = torch.clamp(fi.to(torch.int32), 0, W - 1).long()
    jj = torch.clamp(fj.to(torch.int32), 0, H - 1).long()
    q_driv = ing & maps.drivable[jj, ii]
    curves = maps.curves[jj, ii]       # [..., Cmax, 4, 3]
    cmask = maps.curve_mask[jj, ii]    # [..., Cmax]

    best_dot = torch.full_like(qx, -1e30)
    cps = [torch.zeros_like(qx) for _ in range(8)]
    for c in range(curves.shape[-3]):
        chx = curves[..., c, 3, 0] - curves[..., c, 0, 0]
        chz = curves[..., c, 3, 2] - curves[..., c, 0, 2]
        n2 = chx * chx + chz * chz
        n = torch.clamp(torch.sqrt(n2), min=1e-12)
        dot = (chx / n) * qdx + (chz / n) * qdz
        dot = where(cmask[..., c], dot, -1e30)
        better = dot > best_dot
        best_dot = where(better, dot, best_dot)
        vals = (curves[..., c, 0, 0], curves[..., c, 0, 2],
                curves[..., c, 1, 0], curves[..., c, 1, 2],
                curves[..., c, 2, 0], curves[..., c, 2, 2],
                curves[..., c, 3, 0], curves[..., c, 3, 2])
        cps = [where(better, v, k) for v, k in zip(vals, cps)]
    x0, z0, x1, z1, x2, z2, x3, z3 = cps

    def bz_point(t):
        u = 1.0 - t
        w0 = u * u * u
        w1 = 3.0 * t * u * u
        w2 = 3.0 * t * t * u
        w3 = t * t * t
        return (w0 * x0 + w1 * x1 + w2 * x2 + w3 * x3,
                w0 * z0 + w1 * z1 + w2 * z2 + w3 * z3)

    t_bot = torch.zeros_like(qx)
    t_top = torch.ones_like(qx)
    for _ in range(C.BEZIER_CLOSEST_ITERS):
        mid = 0.5 * (t_bot + t_top)
        bx, bz_ = bz_point(t_bot)
        tx, tz = bz_point(t_top)
        db = (bx - qx) ** 2 + (bz_ - qz) ** 2
        dtp = (tx - qx) ** 2 + (tz - qz) ** 2
        keep_bot = db < dtp
        t_bot, t_top = (where(keep_bot, t_bot, mid),
                        where(keep_bot, mid, t_top))
    t_star = 0.5 * (t_bot + t_top)
    px_c, pz_c = bz_point(t_star)
    u = 1.0 - t_star
    tanx = (3 * u * u * (x1 - x0) + 6 * u * t_star * (x2 - x1)
            + 3 * t_star * t_star * (x3 - x2))
    tanz = (3 * u * u * (z1 - z0) + 6 * u * t_star * (z2 - z1)
            + 3 * t_star * t_star * (z3 - z2))
    tinv = 1.0 / torch.sqrt(torch.clamp(tanx * tanx + tanz * tanz,
                                        min=1e-24))
    return px_c, pz_c, tanx * tinv, tanz * tinv, best_dot, q_driv


def _duckiebot_step(maps, ts_inv, pos, angle, vel, dt):
    """Scripted lane follower of the duckiebot slots: pure pursuit on the
    lane bezier, then differential drive about WHEEL_DIST."""
    nx, nz, na, nv = pos[..., 0], pos[..., 2], angle, vel
    s_n, c_n = sincos(na)
    bdx, bdz = c_n, -s_n
    cpx, cpz, ctx, ctz, bd1, drv1 = _pursuit_lane_query(
        maps, ts_inv, nx, nz, bdx, bdz)
    fpx = cpx + C.DUCKIEBOT_FOLLOW_DIST * ctx
    fpz = cpz + C.DUCKIEBOT_FOLLOW_DIST * ctz
    gpx, gpz, _, _, bd2, drv2 = _pursuit_lane_query(
        maps, ts_inv, fpx, fpz, bdx, bdz)
    pvx = gpx - nx
    pvz = gpz - nz
    pinv = 1.0 / torch.sqrt(torch.clamp(pvx * pvx + pvz * pvz, min=1e-18))
    dotr = (s_n * pvx + c_n * pvz) * pinv
    steering = C.DUCKIEBOT_GAIN * (-dotr)
    ok = drv1 & (bd1 > 0.0) & drv2 & (bd2 > 0.0)
    steering = torch.where(ok, steering, 0.0)
    bvl = nv - steering
    bvr = nv + steering
    straight_b = bvl == bvr
    npx_s = nx + dt * bvl * bdx
    npz_s = nz + dt * bvl * bdz
    denom_b = torch.where(straight_b, 1.0, bvl - bvr)
    w_b = div(bvr - bvl, C.WHEEL_DIST)
    r_b = C.WHEEL_DIST * (bvl + bvr) / (2.0 * denom_b)
    rot_b = w_b * dt
    cx_b = nx + r_b * s_n
    cz_b = nz + r_b * c_n
    s_rb, c_rb = sincos(rot_b)
    dx_b = nx - cx_b
    dz_b = nz - cz_b
    npx_a = cx_b + dx_b * c_rb + dz_b * s_rb
    npz_a = cz_b + dz_b * c_rb - dx_b * s_rb
    new_x = torch.where(straight_b, npx_s, npx_a)
    new_z = torch.where(straight_b, npz_s, npz_a)
    new_angle = na + torch.where(straight_b, 0.0, rot_b)
    return torch.stack([new_x, pos[..., 1], new_z], dim=-1), new_angle


def species_slots(maps_np):
    """Host-side slot indices of a numpy map's walking duckies and
    scripted duckiebots (dynamic slots of each kind)."""
    dyn = np.asarray(maps_np.obj_is_dynamic)
    kind = np.asarray(maps_np.obj_kind)
    duckies = np.nonzero(dyn & (kind == T.OBJ_KIND_IDS["duckie"]))[0]
    bots = np.nonzero(dyn & (kind == T.OBJ_KIND_IDS["duckiebot"]))[0]
    return duckies, bots


def step_dynamic_objects(maps, dyn, dt) -> T.DynObjState:
    """One update of every dynamic object slot of every env. ``maps`` is
    the tensor map (with its numpy host copy); dt a Python float."""
    host = maps.numpy()
    duckies, bots = species_slots(host)
    pos, angle, walk = dyn.pos, dyn.angle, dyn.walk_dist
    if len(duckies):
        d = torch.as_tensor(duckies, device=pos.device)
        d_pos, d_angle, d_walk = _duckie_step(
            maps.obj_walk_dist[d], dyn.pos[:, d], dyn.angle[:, d],
            dyn.vel[:, d], dyn.walk_dist[:, d], dt)
        pos, angle, walk = pos.clone(), angle.clone(), walk.clone()
        pos[:, d], angle[:, d], walk[:, d] = d_pos, d_angle, d_walk
    if len(bots):
        # the f32 reciprocal of the tile size, rounded once from a double
        ts_inv = float(np.float32(1.0 / float(host.tile_size)))
        b = torch.as_tensor(bots, device=pos.device)
        b_pos, b_angle = _duckiebot_step(maps, ts_inv, dyn.pos[:, b],
                                         dyn.angle[:, b], dyn.vel[:, b], dt)
        if not len(duckies):
            pos, angle = pos.clone(), angle.clone()
        pos[:, b], angle[:, b] = b_pos, b_angle
    time = dyn.time + dt
    phase = torch.floor(div(time, C.TRAFFICLIGHT_PERIOD)).to(torch.int32) % 2
    return dyn.replace(pos=pos, angle=angle, walk_dist=walk, time=time,
                       phase=phase)


def dynamic_corners(maps, dyn):
    """Footprint corners [B, M, 4, 2] and SAT axes [B, M, 2, 2] of every
    slot: static slots keep the map's, dynamic slots follow their pose.
    The map's object tables are [M, ...] or, one per env, [B, M, ...]."""
    hw = maps.obj_halfdims[..., 0]
    hl = maps.obj_halfdims[..., 1]
    f = get_dir_vec(dyn.angle)
    r = get_right_vec(dyn.angle)
    p = torch.stack([dyn.pos[..., 0], dyn.pos[..., 2]], dim=-1)
    fxz = torch.stack([f[..., 0], f[..., 2]], dim=-1)
    rxz = torch.stack([r[..., 0], r[..., 2]], dim=-1)
    hl_, hw_ = hl[..., None], hw[..., None]
    corners = torch.stack([p - hl_ * fxz - hw_ * rxz,
                           p + hl_ * fxz - hw_ * rxz,
                           p + hl_ * fxz + hw_ * rxz,
                           p - hl_ * fxz + hw_ * rxz], dim=-2)
    norms = torch.stack([rxz, fxz], dim=-2)
    sel = maps.obj_is_dynamic[..., None, None]
    return (torch.where(sel, corners, maps.obj_corners),
            torch.where(sel, norms, maps.obj_norms))
