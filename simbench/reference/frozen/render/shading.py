"""Analytic tile shading constants and marking coverage (torch).

Counterpart of dtown/render/shading.py: the road surface is shaded
procedurally, with lane markings as analytic functions of the in-tile
(u, v) coordinate and surface noise from an integer hash of the texel.
``shade_tile`` is the XLA ray-caster's form (render/raster.py).
"""
import torch

from simbench.reference.frozen import types as T

# Marking geometry (tile fractions), consistent with curves.LANE_OFFSET
EDGE_INSET = 0.035
LINE_W = 0.025
DASH_PERIOD = 0.125
DASH_DUTY = 0.5

# Colors (0..1)
YELLOW = (0.82, 0.68, 0.10)
WHITE = (0.88, 0.88, 0.88)
ASPHALT = (0.155, 0.155, 0.16)
GRASS = (0.22, 0.46, 0.18)
FLOOR = (0.62, 0.60, 0.58)
EMPTY = (0.13, 0.28, 0.11)

NOISE_AMP = 0.012
NOISE_CELLS = 128  # hash lattice per tile edge


def line_coverage(d, inv_fw, half_w=LINE_W / 2, cap=None):
    """Exact box-filter coverage of the band |d| < half_w under a pixel
    footprint of width 1/inv_fw (tile units):
    clamp(min((half_w - |d|) * inv_fw + 0.5, 2 * half_w * inv_fw), 0, 1).
    """
    tent = (half_w - torch.abs(d)) * inv_fw + 0.5
    if cap is None:
        cap = (2.0 * half_w) * inv_fw
    return torch.clamp(torch.minimum(tent, cap), 0.0, 1.0)


def _hash_noise(ix, iy, seed):
    """Per-texel noise in [-1, 1] from the integer hash of (ix, iy, seed),
    int32 [...] each; int32 wraparound and arithmetic >> are part of the
    definition."""
    h = ix | (iy << 7) | (seed << 14)
    h = h + (h << 10)
    h = h ^ (h >> 6)
    h = h + (h << 3)
    h = h ^ (h >> 11)
    h = h + (h << 15)
    h = h ^ (h >> 7)
    return (h & 0xFFFF).to(torch.float32) / 32768.0 - 1.0


def _dashed(arc_pos):
    return torch.remainder(arc_pos / DASH_PERIOD, 1.0) < DASH_DUTY


def _col(c3, like):
    return torch.tensor(c3, dtype=torch.float32, device=like.device)


def shade_tile(kind, angle_idx, variant, u, v, inv_fw=None):
    """Tile colour f32 [..., 3] at in-tile coordinates (u, v) in [0, 1)
    (world orientation; the markings are drawn in the tile's base
    orientation, (u, v) turned back by -angle_idx * 90 degrees). kind,
    angle_idx and variant are int32 [...]. With inv_fw (the per-pixel
    reciprocal ground footprint, tile units) the markings are box-filter
    coverages (line_coverage), else hard bands. The XLA ray-caster's
    shading (dtown/render/shading.py::shade_tile), whose arcs use the exact
    hypot / atan2 and which always composites white over yellow; the
    row-fed and blob renders shade with tile_shading._shade_pixels."""
    ai = angle_idx.long()
    c = torch.tensor([1.0, 0.0, -1.0, 0.0], device=u.device)[ai]
    s = torch.tensor([0.0, 1.0, 0.0, -1.0], device=u.device)[ai]
    du = u - 0.5
    dv = v - 0.5
    bu = du * c - dv * s + 0.5
    bv = dv * c + du * s + 0.5
    aa = inv_fw is not None

    def line(d, half_w=LINE_W / 2):
        return line_coverage(d, inv_fw, half_w) if aa \
            else torch.abs(d) < half_w

    def edge_pair(x):
        return line(torch.abs(x - 0.5) - (0.5 - EDGE_INSET))

    def gate(cov, b):
        return cov * b if aa else (cov & b)

    def bor(a, b):
        return a + b if aa else (a | b)

    straight_center = gate(line(bu - 0.5), _dashed(bv))
    straight_edge = edge_pair(bu)

    def arc(cu, cv):
        r = torch.hypot(bu - cu, bv - cv)
        theta = torch.atan2(bv - cv, bu - cu)
        return (gate(line(r - 0.5), _dashed(r * torch.abs(theta))),
                edge_pair(r))

    cl_center, cl_edge = arc(1.0, 0.0)
    cr_center, cr_edge = arc(0.0, 0.0)

    zm_m = gate(line(bu - 0.5), bv < 0.5)
    zp_m = gate(line(bu - 0.5), bv >= 0.5)
    xm_m = gate(line(bv - 0.5), bu < 0.5)
    xp_m = gate(line(bv - 0.5), bu >= 0.5)
    zm_s = gate(line(bv - 0.08, 0.02), (bu > 0.5) & (bu < 0.8))
    zp_s = gate(line(bv - 0.92, 0.02), (bu > 0.2) & (bu < 0.5))
    xm_s = gate(line(bu - 0.08, 0.02), (bv > 0.2) & (bv < 0.5))
    xp_s = gate(line(bu - 0.92, 0.02), (bv > 0.5) & (bv < 0.8))
    dash_uv = _dashed(bu + bv)
    k3l_center = gate(bor(bor(zm_m, zp_m), xp_m), dash_uv)
    k3l_stop = bor(bor(zm_s, zp_s), xp_s)
    k3r_center = gate(bor(bor(zm_m, zp_m), xm_m), dash_uv)
    k3r_stop = bor(bor(zm_s, zp_s), xm_s)
    k4_center = gate(bor(bor(zm_m, zp_m), bor(xm_m, xp_m)), dash_uv)
    k4_stop = bor(bor(zm_s, zp_s), bor(xm_s, xp_s))

    is_road = (kind >= T.TILE_STRAIGHT) & (kind <= T.TILE_ASPHALT)

    def ksel(pairs):
        if aa:
            out = torch.zeros_like(bu)
            for kk, cv in pairs:
                out = torch.where(kind == kk, cv, out)
            return out
        out = None
        for kk, cv in pairs:
            t_ = (kind == kk) & cv
            out = t_ if out is None else out | t_
        return out

    yellow = ksel([
        (T.TILE_STRAIGHT, straight_center), (T.TILE_CURVE_LEFT, cl_center),
        (T.TILE_CURVE_RIGHT, cr_center), (T.TILE_3WAY_LEFT, k3l_center),
        (T.TILE_3WAY_RIGHT, k3r_center), (T.TILE_4WAY, k4_center)])
    white = ksel([
        (T.TILE_STRAIGHT, straight_edge), (T.TILE_CURVE_LEFT, cl_edge),
        (T.TILE_CURVE_RIGHT, cr_edge), (T.TILE_3WAY_LEFT, k3l_stop),
        (T.TILE_3WAY_RIGHT, k3r_stop), (T.TILE_4WAY, k4_stop)])

    col = lambda c3: _col(c3, u)
    k = kind[..., None]
    base = torch.where(
        (is_road)[..., None], col(ASPHALT),
        torch.where(k == T.TILE_GRASS, col(GRASS),
                    torch.where(k == T.TILE_FLOOR, col(FLOOR), col(EMPTY))))
    if aa:
        wcov = torch.clamp(white, 0.0, 1.0)
        ycov = torch.clamp(yellow, 0.0, 1.0) * (1.0 - wcov)
        rgb = (base + ycov[..., None] * (col(YELLOW) - col(ASPHALT))
               + wcov[..., None] * (col(WHITE) - col(ASPHALT)))
    else:
        rgb = torch.where(yellow[..., None], col(YELLOW), base)
        rgb = torch.where(white[..., None], col(WHITE), rgb)

    tx = torch.clamp((bu * NOISE_CELLS).to(torch.int32), 0, NOISE_CELLS - 1)
    ty = torch.clamp((bv * NOISE_CELLS).to(torch.int32), 0, NOISE_CELLS - 1)
    amp = torch.where(kind == T.TILE_GRASS, 0.03,
                      torch.where(is_road, NOISE_AMP, 0.015)).to(u.dtype)
    n = _hash_noise(tx, ty, variant + 7 * kind)
    brightness = 0.94 + 0.04 * variant.to(torch.float32)
    rgb = rgb * brightness[..., None] + (amp * n)[..., None]
    return torch.clamp(rgb, 0.0, 1.0)
