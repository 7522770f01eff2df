"""Collision, pose validity, proximity penalty and reward, batched (torch).

Counterpart of dtown/physics.py: the agent footprint, the separating-axis
(SAT) test against every object footprint, drivability of the points
around the agent, the safety-circle penalty and the reward. Every
function takes a batch of B envs; object tables are [M, ...] for the
map's static footprints or [B, M, ...] for live NPC footprints.
"""
import torch

from simbench.reference.frozen import constants as C
from simbench.reference.frozen.geometry import get_dir_vec, get_grid_coords, \
    get_right_vec, norm3


def actual_center(pos, angle):
    """Geometric centre of the agent (pos is the centre of rotation)."""
    return pos + (C.CAMERA_FORWARD_DIST - 0.5 * C.ROBOT_LENGTH) \
        * get_dir_vec(angle)


def agent_boundbox(center, width, length, f_vec, r_vec):
    """Footprint corners [..., 4, 2] in (x, z)."""
    p = torch.stack([center[..., 0], center[..., 2]], dim=-1)
    f = torch.stack([f_vec[..., 0], f_vec[..., 2]], dim=-1)
    r = torch.stack([r_vec[..., 0], r_vec[..., 2]], dim=-1)
    hw = 0.5 * width
    hl = 0.5 * length
    return torch.stack([p - hl * f + hw * r, p + hl * f + hw * r,
                        p + hl * f - hw * r, p - hl * f - hw * r], dim=-2)


def get_agent_corners(pos, angle):
    return agent_boundbox(actual_center(pos, angle), C.ROBOT_WIDTH,
                          C.ROBOT_LENGTH, get_dir_vec(angle),
                          get_right_vec(angle))


def _project_interval(corners, axes):
    """Corners [..., 4, 2] on axes [..., K, 2] -> (min, max) [..., K]."""
    dots = (axes[..., :, None, 0] * corners[..., None, :, 0]
            + axes[..., :, None, 1] * corners[..., None, :, 1])
    return dots.amin(dim=-1), dots.amax(dim=-1)


def sat_intersects(corners_a, norms_a, corners_b, norms_b):
    """SAT of each env's rectangle A ([B, 4, 2], axes [B, 2, 2]) against
    the rectangles B ([M, 4, 2] or [B, M, 4, 2]). Returns bool [B, M]."""
    Bn = corners_a.shape[0]
    M = corners_b.shape[-3]
    corners_b = corners_b.expand(Bn, M, 4, 2)
    norms_b = norms_b.expand(Bn, M, 2, 2)
    axes = torch.cat([norms_a[:, None].expand(Bn, M, 2, 2), norms_b], dim=-2)
    a_min, a_max = _project_interval(
        corners_a[:, None].expand(Bn, M, 4, 2), axes)
    b_min, b_max = _project_interval(corners_b, axes)
    separated = (a_max < b_min) | (b_max < a_min)     # [B, M, 4]
    return ~separated.any(dim=-1)


def drivable_at(maps, point):
    """Is the tile under each point [..., 3] drivable? bool [...]."""
    H, W = maps.grid_shape
    i, j = get_grid_coords(point, maps.tile_size)
    in_grid = (i >= 0) & (i < W) & (j >= 0) & (j < H)
    ci = torch.clamp(i, 0, W - 1).long()
    cj = torch.clamp(j, 0, H - 1).long()
    return in_grid & maps.drivable[cj, ci]


def _all_drivable(maps, pos, angle, safety_factor):
    center = actual_center(pos, angle)
    f_vec = get_dir_vec(angle)
    r_vec = get_right_vec(angle)
    l_pos = center - (safety_factor * 0.5 * C.ROBOT_WIDTH) * r_vec
    r_pos = center + (safety_factor * 0.5 * C.ROBOT_WIDTH) * r_vec
    f_pos = center + (safety_factor * 0.5 * C.ROBOT_LENGTH) * f_vec
    ok = (drivable_at(maps, center) & drivable_at(maps, l_pos)
          & drivable_at(maps, r_pos) & drivable_at(maps, f_pos))
    return ok, f_vec, r_vec


def valid_pose(maps, pos, angle, obj_corners, obj_norms, obj_active,
               safety_factor=1.0):
    """Drivable centre, wheel and front points and no object collision.
    obj_active bool [B, M]. Returns (valid, collided), each bool [B]."""
    all_drivable, f_vec, r_vec = _all_drivable(maps, pos, angle,
                                               safety_factor)
    agent_corners = get_agent_corners(pos, angle)
    # the unit (f, r) vectors are the agent's SAT axes, as in the reference
    agent_norms = torch.stack(
        [torch.stack([f_vec[..., 0], f_vec[..., 2]], dim=-1),
         torch.stack([r_vec[..., 0], r_vec[..., 2]], dim=-1)], dim=-2)
    hits = sat_intersects(agent_corners, agent_norms, obj_corners, obj_norms)
    collided = (hits & obj_active).any(dim=-1)
    return all_drivable & ~collided, collided


def valid_pose_no_objects(maps, pos, angle, safety_factor=1.0):
    """valid_pose for maps without collidable objects."""
    all_drivable, _, _ = _all_drivable(maps, pos, angle, safety_factor)
    return all_drivable, torch.zeros_like(all_drivable)


def proximity_penalty(pos, angle, obj_pos, obj_safety_rad, obj_active,
                      obj_is_dynamic):
    """Safety-circle overlap penalty (<= 0) of every env [B]: the worst
    static overlap plus the sum of dynamic overlaps. obj_pos [B, M, 3]."""
    center = actual_center(pos, angle)
    scores = norm3(obj_pos - center[:, None, :]) - C.AGENT_SAFETY_RAD \
        - obj_safety_rad
    static_mask = obj_active & ~obj_is_dynamic
    static_scores = torch.where(static_mask, scores, torch.inf)
    static_pen = torch.clamp(static_scores.amin(dim=-1), max=0.0)
    dyn_mask = obj_active & obj_is_dynamic
    dyn_pen = torch.where(dyn_mask, torch.clamp(scores, max=0.0),
                          0.0).sum(dim=-1)
    return static_pen + dyn_pen


def compute_reward(speed, lane_pos, col_penalty):
    """In lane: speed*dot_dir - 10|dist| + 40*penalty; else 40*penalty."""
    full = (C.REWARD_SPEED_COEF * speed * lane_pos.dot_dir
            + C.REWARD_DIST_COEF * torch.abs(lane_pos.dist)
            + C.REWARD_COLLISION_COEF * col_penalty)
    return torch.where(lane_pos.in_lane, full,
                       C.REWARD_COLLISION_COEF * col_penalty)
