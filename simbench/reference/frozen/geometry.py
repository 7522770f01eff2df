"""Polynomial sincos, heading vectors and bezier lane geometry (torch).

Counterpart of dtown/geometry.py. ``sincos``: Cody-Waite 3-part pi/2
argument reduction + the fdlibm kernel polynomials, evaluated in float32
with the same operation order, so the plain versions and the CUDA kernels
(csrc/sincos.cuh) reproduce the reference's bits. ``torch.round`` rounds
half to even like ``jnp.round`` (``rintf`` on the device side). The lane
queries are batched over envs.
"""
import torch

_PIO2_HI = 1.57079632673412561417e+00
_PIO2_MID = 6.07710050650619224932e-11
_PIO2_LO = 2.02226624879595063154e-21
_TWO_OVER_PI = 0.636619772367581343076

_S = (-1.66666666666666324348e-01, 8.33333333332248946124e-03,
      -1.98412698298579493134e-04, 2.75573137070700676789e-06,
      -2.50507602534068634195e-08, 1.58969099521155010221e-10)
_C = (4.16666666666666019037e-02, -1.38888888888741095749e-03,
      2.48015872894767294178e-05, -2.75573143513906633035e-07,
      2.08757232129817482790e-09, -1.13596475577881948265e-11)


def _kernel_sin(r, z):
    p = torch.full_like(z, _S[5])
    for s in (_S[4], _S[3], _S[2], _S[1], _S[0]):
        p = p * z + s
    return r + r * z * p


def _kernel_cos(z):
    p = torch.full_like(z, _C[5])
    for c in (_C[4], _C[3], _C[2], _C[1], _C[0]):
        p = p * z + c
    return 1.0 - 0.5 * z + z * z * p


def sincos(x: torch.Tensor):
    """(sin x, cos x) of a float32 tensor, ~1 ulp."""
    k = torch.round(x * _TWO_OVER_PI)
    r = ((x - k * _PIO2_HI) - k * _PIO2_MID) - k * _PIO2_LO
    z = r * r
    s = _kernel_sin(r, z)
    c = _kernel_cos(z)
    n = k.to(torch.int32) & 3
    sin_x = torch.where(
        n == 0, s, torch.where(n == 1, c, torch.where(n == 2, -s, -c)))
    cos_x = torch.where(
        n == 0, c, torch.where(n == 1, -s, torch.where(n == 2, -c, s)))
    return sin_x, cos_x


# --- Heading vectors, bezier lane geometry (dtown/geometry.py:80-254) -------
# Batched over any leading dimensions. Every function keeps the
# reference's float32 operation order.


def div(a, b):
    """``a / b`` with ``b`` a Python scalar, divided and not multiplied by
    the reciprocal: torch's CUDA divide by a Python scalar multiplies by
    1/b, which rounds differently from the reference's (and the CPU's)
    division."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def fma32(a, b, c):
    """a * b + c of float32 values, rounded once to float32, as an FMA
    rounds it: computed in float64 and rounded at the end. Exact whenever
    the product (at most 48 significant bits) and the sum fit float64's 53
    bits, which holds for the draws this port feeds it; otherwise only a
    double-rounding tie could differ by one float32 ulp. The reference's
    XLA build contracts such multiply-adds into FMAs, and the CUDA kernels
    call fmaf at the same places. Any argument may be a Python float."""
    d = lambda v: v.double() if isinstance(v, torch.Tensor) else float(v)
    return (d(a) * d(b) + d(c)).float()


def get_dir_vec(angle):
    """Heading unit vector (cos a, 0, -sin a), [..., 3]."""
    s, c = sincos(angle)
    return torch.stack([c, torch.zeros_like(angle), -s], dim=-1)


def get_right_vec(angle):
    """Right-pointing unit vector (sin a, 0, cos a), [..., 3]."""
    s, c = sincos(angle)
    return torch.stack([s, torch.zeros_like(angle), c], dim=-1)


def norm3(v):
    """Euclidean norm over the last axis of length 3 (summed in order)."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def bezier_point(cps, t):
    """Cubic bezier at t. cps [..., 4, 3], t [...] -> [..., 3]."""
    t = t[..., None]
    u = 1.0 - t
    return ((u ** 3) * cps[..., 0, :]
            + 3.0 * t * (u ** 2) * cps[..., 1, :]
            + 3.0 * (t ** 2) * u * cps[..., 2, :]
            + (t ** 3) * cps[..., 3, :])


def bezier_tangent(cps, t):
    """Normalized tangent of a cubic bezier at t."""
    t = t[..., None]
    u = 1.0 - t
    d = (3.0 * (u ** 2) * (cps[..., 1, :] - cps[..., 0, :])
         + 6.0 * u * t * (cps[..., 2, :] - cps[..., 1, :])
         + 3.0 * (t ** 2) * (cps[..., 3, :] - cps[..., 2, :]))
    return d / torch.clamp(norm3(d), min=1e-12)[..., None]


def bezier_closest(cps, p, n_iters: int = 8):
    """Closest-parameter search by fixed-depth interval bisection.
    cps [..., 4, 3], p [..., 3] -> t [...]."""
    t_bot = torch.zeros(p.shape[:-1], dtype=cps.dtype, device=cps.device)
    t_top = torch.ones_like(t_bot)
    for _ in range(n_iters):
        mid = 0.5 * (t_bot + t_top)
        e_bot = bezier_point(cps, t_bot) - p
        e_top = bezier_point(cps, t_top) - p
        d_bot = (e_bot[..., 0] ** 2 + e_bot[..., 1] ** 2) + e_bot[..., 2] ** 2
        d_top = (e_top[..., 0] ** 2 + e_top[..., 1] ** 2) + e_top[..., 2] ** 2
        keep_bot = d_bot < d_top
        t_bot, t_top = (torch.where(keep_bot, t_bot, mid),
                        torch.where(keep_bot, mid, t_top))
    return 0.5 * (t_bot + t_top)


def get_grid_coords(pos, tile_size):
    """World position [..., 3] -> int32 tile coords (i along x, j along z).
    tile_size is the map's 0-d tensor."""
    i = torch.floor(pos[..., 0] / tile_size).to(torch.int32)
    j = torch.floor(pos[..., 2] / tile_size).to(torch.int32)
    return i, j


def closest_curve_point(maps, pos, angle):
    """Point [B, 3] and tangent [B, 3] of the lane curve best aligned with
    the heading, and whether the pose is on a lane (bool [B])."""
    H, W = maps.grid_shape
    i, j = get_grid_coords(pos, maps.tile_size)
    in_grid = (i >= 0) & (i < W) & (j >= 0) & (j < H)
    ci = torch.clamp(i, 0, W - 1).long()
    cj = torch.clamp(j, 0, H - 1).long()
    valid = in_grid & maps.drivable[cj, ci]

    curves = maps.curves[cj, ci]          # [B, C, 4, 3]
    cmask = maps.curve_mask[cj, ci]       # [B, C]
    chord = curves[..., -1, :] - curves[..., 0, :]
    chord = chord / torch.clamp(norm3(chord), min=1e-12)[..., None]
    dv = get_dir_vec(angle)[:, None, :]
    dots = (chord[..., 0] * dv[..., 0] + chord[..., 1] * dv[..., 1]
            + chord[..., 2] * dv[..., 2])
    dots = torch.where(cmask, dots, -torch.inf)
    best = torch.argmax(dots, dim=-1)     # first of equal maxima, like jnp
    valid = valid & (torch.gather(dots, 1, best[:, None])[:, 0] > 0.0)
    cps = curves[torch.arange(curves.shape[0], device=pos.device), best]
    t = bezier_closest(cps, pos)
    return bezier_point(cps, t), bezier_tangent(cps, t), valid


def get_lane_pos2(maps, pos, angle):
    """Lane-relative position of every env (LanePosition of [B] tensors):
    signed distance (left +, right -), heading alignment and angle."""
    from simbench.reference.frozen.types import LanePosition

    point, tangent, valid = closest_curve_point(maps, pos, angle)
    dir_vec = get_dir_vec(angle)
    dot_dir = torch.clamp(
        (dir_vec[:, 0] * tangent[:, 0] + dir_vec[:, 1] * tangent[:, 1])
        + dir_vec[:, 2] * tangent[:, 2], -1.0, 1.0)
    up = torch.zeros_like(tangent)
    up[:, 1] = 1.0
    right_of_curve = torch.linalg.cross(tangent, up)
    e = (pos - point) * right_of_curve
    signed_dist = (e[:, 0] + e[:, 1]) + e[:, 2]
    angle_rad = torch.acos(dot_dir)
    r = dir_vec * right_of_curve
    angle_rad = torch.where((r[:, 0] + r[:, 1]) + r[:, 2] < 0.0,
                            -angle_rad, angle_rad)
    return LanePosition(
        dist=signed_dist, dot_dir=dot_dir,
        angle_deg=torch.rad2deg(angle_rad), angle_rad=angle_rad,
        in_lane=valid)
