"""Differential-drive kinematics, batched over envs (torch).

Counterpart of dtown/dynamics.py: the wheel-model inverse kinematics and
the Euler substeps of the reference's update_physics, with the straight
(Vl == Vr) case taken on exact float equality. Same float32 operation
order as the reference.
"""
import torch

from dtown_torch.geometry import div, get_dir_vec, get_right_vec, norm3, \
    sincos


def wheel_model(action, gain, trim, radius, k, limit, wheel_dist):
    """[B, 2] (velocity, steering) -> clipped wheel commands [B, 2]
    (u_l, u_r). gain/trim/radius/k/limit are Python floats, wheel_dist a
    [B] tensor."""
    vel = action[..., 0]
    steer = action[..., 1]
    k_r_inv = (gain + trim) / k
    k_l_inv = (gain - trim) / k
    omega_r = div(vel + 0.5 * steer * wheel_dist, radius)
    omega_l = div(vel - 0.5 * steer * wheel_dist, radius)
    u_r = torch.clamp(omega_r * k_r_inv, -limit, limit)
    u_l = torch.clamp(omega_l * k_l_inv, -limit, limit)
    return torch.stack([u_l, u_r], dim=-1)


def rotate_point_xz(px, pz, cx, cz, theta):
    """Rotate (px, pz) about (cx, cz) by +theta about the +y axis."""
    dx = px - cx
    dz = pz - cz
    s, c = sincos(theta)
    return cx + dx * c + dz * s, cz + dz * c - dx * s


def update_pos(pos, angle, wheel_dist, wheel_vels, dt):
    """One Euler substep. pos [B, 3], angle [B], wheel_dist [B],
    wheel_vels [B, 2], dt a Python float -> (pos, angle)."""
    vl = wheel_vels[..., 0]
    vr = wheel_vels[..., 1]
    straight = vl == vr

    pos_straight = pos + dt * vl[..., None] * get_dir_vec(angle)

    denom = torch.where(straight, torch.ones_like(vl), vl - vr)
    w = (vr - vl) / wheel_dist
    r = wheel_dist * (vl + vr) / (2.0 * denom)
    rot = w * dt
    right = get_right_vec(angle)
    cx = pos[..., 0] + r * right[..., 0]
    cz = pos[..., 2] + r * right[..., 2]
    npx, npz = rotate_point_xz(pos[..., 0], pos[..., 2], cx, cz, rot)
    pos_arc = torch.stack([npx, pos[..., 1], npz], dim=-1)

    new_pos = torch.where(straight[..., None], pos_straight, pos_arc)
    new_angle = angle + torch.where(straight, torch.zeros_like(rot), rot)
    return new_pos, new_angle


def physics_substep(pos, angle, action, robot_speed, wheel_dist, dt):
    """One update_physics iteration; action [B, 2] in [-1, 1]. Returns
    (pos, angle, speed, wheel_vels) with speed = |delta_pos| / dt."""
    wheel_vels = action * robot_speed[..., None]
    new_pos, new_angle = update_pos(pos, angle, wheel_dist, wheel_vels, dt)
    return new_pos, new_angle, div(norm3(new_pos - pos), dt), wheel_vels


def integrate(pos, angle, action, robot_speed, wheel_dist, dt,
              frame_skip: int):
    """frame_skip physics substeps."""
    speed = torch.zeros_like(angle)
    wheel_vels = action * robot_speed[..., None]
    for _ in range(frame_skip):
        pos, angle, speed, wheel_vels = physics_substep(
            pos, angle, action, robot_speed, wheel_dist, dt)
    return pos, angle, speed, wheel_vels
