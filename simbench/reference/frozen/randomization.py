"""Randomization fields of a reset: identity draws and domain randomization.

Counterpart of dtown/randomization.py. ``variant_hash`` is the per-tile
texture-variant hash shared with the render kernels; ``draw_from_uniforms``
is the deterministic core of a domain-randomized draw (the reference's
``jax.random.uniform`` ranges applied to uniforms in [0, 1)), so the tests
can feed both packages the same uniforms; ``draw`` makes the uniforms
with a torch.Generator on the state's device.
"""
import numpy as np
import torch

from simbench.reference.frozen import constants as C
from simbench.reference.frozen.geometry import fma32

N_TEX_VARIANTS = 4

# (field, lo, hi) of each scalar uniform draw, in the reference's order;
# "add"/"mul" fields are a nominal constant plus / times the draw
_SCALAR_DRAWS = (
    ("cam_fov_y", "add", C.CAMERA_FOV_Y, -5.0, 5.0),
    ("cam_height", "mul", C.CAMERA_FLOOR_DIST, 0.92, 1.08),
    ("cam_angle", "add", C.CAMERA_ANGLE, -3.0, 3.0),
    ("cam_fwd_dist", "mul", C.CAMERA_FORWARD_DIST, 0.9, 1.1),
    ("wheel_dist", "mul", C.WHEEL_DIST, 0.95, 1.05),
)
# names of the uniforms a domain-randomized draw takes, with their
# per-env shapes (M = object slots)
UNIFORM_SHAPES = dict(
    robot_speed=(), cam_fov_y=(), cam_height=(), cam_angle=(),
    cam_fwd_dist=(), wheel_dist=(), light=(3,), light_ambient=(),
    ground_color=(3,), horizon_color=(3,), obj_visible=("M",),
)


def variant_hash(tile_id, seed):
    """Per-tile texture variant (0..3) as an integer hash of (tile, seed),
    int32 tensors. int32 wraparound and arithmetic >> are part of the
    definition (torch's >> on int32 is arithmetic, like jnp's)."""
    h = (tile_id ^ (seed << 13)) + seed
    h = h + (h << 10)
    h = h ^ (h >> 6)
    h = h + (h << 3)
    h = h ^ (h >> 11)
    h = h + (h << 15)
    h = h ^ (h >> 7)
    return h & (N_TEX_VARIANTS - 1)


def tex_variants(tex_seed, grid_shape):
    """Texture variant of every tile, int32 [B, H, W], from the per-env
    seeds int32 [B]."""
    H, W = grid_shape
    tile_ids = torch.arange(H * W, dtype=torch.int32,
                            device=tex_seed.device).reshape(1, H, W)
    return variant_hash(tile_ids, tex_seed.to(torch.int32)[:, None, None])


def _f32(v):
    return float(np.float32(v))


def _uniform(u, lo, hi):
    """jax.random.uniform's range map of uniforms u in [0, 1): bounds
    rounded to float32 first, then max(lo, u * (hi - lo) + lo), the
    multiply-add rounded once as the reference's XLA build contracts it
    into an FMA (geometry.fma32)."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return torch.clamp(fma32(u, float(hi32 - lo32), float(lo32)),
                       min=float(lo32))


def draw_from_uniforms(cfg, u, tex_seed, grid_shape):
    """Domain-randomized fields of B envs from their draws: ``u`` maps each
    name of UNIFORM_SHAPES to float32 uniforms in [0, 1) of shape
    [B, *shape]; tex_seed int32 [B] in [0, 2^23). Float32 operation order
    of dtown.randomization.draw."""
    out = dict(robot_speed=_uniform(u["robot_speed"], 0.9 * cfg.robot_speed,
                                    1.1 * cfg.robot_speed))
    for name, how, nominal, lo, hi in _SCALAR_DRAWS:
        d = _uniform(u[name], lo, hi)
        out[name] = d + _f32(nominal) if how == "add" else _f32(nominal) * d
    light = _uniform(u["light"], -1.0, -0.2).clone()
    light[:, 1] = -1.0
    # the squared norm as XLA contracts it: x0^2, then two FMAs
    n2 = fma32(light[:, 1], light[:, 1], light[:, 0] * light[:, 0])
    n = torch.sqrt(fma32(light[:, 2], light[:, 2], n2))
    out["light_dir"] = light / n[:, None]
    out["light_ambient"] = _uniform(u["light_ambient"], 0.35, 0.7)
    g0 = torch.as_tensor(C.NOMINAL_GROUND_COLOR, device=light.device)
    h0 = torch.as_tensor(C.NOMINAL_HORIZON_COLOR, device=light.device)
    out["ground_color"] = torch.clamp(
        g0 + _uniform(u["ground_color"], -0.08, 0.08), 0.0, 1.0)
    out["horizon_color"] = torch.clamp(
        h0 + _uniform(u["horizon_color"], -0.2, 0.2), 0.0, 1.0)
    tex_seed = tex_seed.to(torch.int32)
    out["tex_seed"] = tex_seed
    out["tex_variant"] = tex_variants(tex_seed, grid_shape)
    out["obj_visible"] = u["obj_visible"] < 0.5
    return out


def draw(cfg, num_envs, grid_shape, n_objects, device, generator=None):
    """Randomization fields of ``num_envs`` fresh envs (dict of [B, ...]
    tensors, the EnvState field names). Without domain randomization every
    env gets the nominal values; with it the uniforms and texture seeds
    are drawn from ``generator`` (a torch.Generator on ``device``)."""
    B = num_envs
    if cfg.domain_rand:
        if generator is None:
            raise ValueError("domain randomization draws from a "
                             "torch.Generator: pass the batch's generator")
        u = {}
        for name, shape in UNIFORM_SHAPES.items():
            shape = tuple(n_objects if s == "M" else s for s in shape)
            u[name] = torch.rand((B,) + shape, generator=generator,
                                 device=device)
        seed = torch.randint(0, 1 << 23, (B,), generator=generator,
                             device=device, dtype=torch.int32)
        return draw_from_uniforms(cfg, u, seed, grid_shape)
    H, W = grid_shape
    f32 = torch.float32

    def full(v):
        return torch.full((B,), _f32(v), dtype=f32, device=device)

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
