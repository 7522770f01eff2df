"""Randomization fields of a reset, identity draw only (torch).

Counterpart of dtown/randomization.py::draw with ``domain_rand=False``:
every env gets the nominal robot speed, camera, light and colours, texture
variant 0 everywhere and every optional object visible. Domain
randomization is not ported yet and raises.
"""
import numpy as np
import torch

from dtown_torch import constants as C


def draw(cfg, num_envs, grid_shape, n_objects, device):
    """Randomization fields of ``num_envs`` fresh envs (dict of [B, ...]
    tensors, the EnvState field names)."""
    if cfg.domain_rand:
        raise NotImplementedError("domain randomization is not ported yet")
    B = num_envs
    H, W = grid_shape
    f32 = torch.float32

    def full(v):
        return torch.full((B,), float(np.float32(v)), dtype=f32,
                          device=device)

    def rows(a):
        return torch.as_tensor(np.asarray(a, np.float32),
                               device=device).expand(B, 3).clone()

    light = np.asarray(C.NOMINAL_LIGHT_DIR, np.float32)
    light = light / np.sqrt((light[0] * light[0] + light[1] * light[1])
                            + light[2] * light[2])
    return dict(
        robot_speed=full(cfg.robot_speed),
        cam_fov_y=full(C.CAMERA_FOV_Y),
        cam_height=full(C.CAMERA_FLOOR_DIST),
        cam_angle=full(C.CAMERA_ANGLE),
        cam_fwd_dist=full(C.CAMERA_FORWARD_DIST),
        wheel_dist=full(C.WHEEL_DIST),
        light_dir=rows(light),
        light_ambient=full(C.NOMINAL_AMBIENT),
        ground_color=rows(C.NOMINAL_GROUND_COLOR),
        horizon_color=rows(C.NOMINAL_HORIZON_COLOR),
        tex_seed=torch.zeros((B,), dtype=torch.int32, device=device),
        tex_variant=torch.zeros((B, H, W), dtype=torch.int32,
                                device=device),
        obj_visible=torch.ones((B, n_objects), dtype=torch.bool,
                               device=device),
    )
