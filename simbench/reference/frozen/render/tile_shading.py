"""Ground-tile shading helpers of the blob render (torch plain versions).

Counterpart of the helpers that dtown/render/blob_raster.py takes from
dtown/render/pallas_raster.py: ``_select_word``, ``_tile_masks``,
``_noise_h16f`` and ``_shade_pixels``. The same math is written once more
for the device as ``__device__`` functions in csrc/tile_shading.cuh; the
two keep one operation order so they agree to the float32 bit.

Differences from the Pallas helpers, none of which changes a pixel:
 * the packed-word select chain is an indexed load;
 * marking terms are computed for every kind instead of only the kinds
   present in the map (a pixel only ever takes its own kind's term); the
   map's kind set still decides whether yellow is composited under white
   (``any_x``, intersections present), as in the reference.
"""
import torch

from simbench.reference.frozen import types as T
from simbench.reference.frozen.render.shading import (
    ASPHALT, DASH_DUTY, DASH_PERIOD, EDGE_INSET, EMPTY, FLOOR, GRASS,
    LINE_W, NOISE_AMP, NOISE_CELLS, WHITE, YELLOW,
)

INTERSECTION_KINDS = (T.TILE_3WAY_LEFT, T.TILE_3WAY_RIGHT, T.TILE_4WAY)


def _select_word(words, widx):
    """Word of the packed tile table at per-pixel index widx (int32).
    Out-of-range indices read word 0; callers mask those pixels."""
    n = words.shape[0]
    ok = (widx >= 0) & (widx < n)
    return words[torch.where(ok, widx, 0).long()]


def _tile_masks(kind, angle_idx, u, v, any_x, inv_fw=None):
    """Marking/base-kind masks in base orientation.

    Returns (yellow, white, is_road, is_grass, is_floor, bu, bv); with
    inv_fw (per-pixel reciprocal ground footprint, tile units) yellow and
    white are box-filter coverages in [0, 1], else booleans. any_x: the
    map has intersection tiles (decides the yellow-under-white composite).
    """
    aa = inv_fw is not None
    zero = torch.zeros_like(u)
    c = torch.where(angle_idx == 0, 1.0,
                    torch.where(angle_idx == 2, -1.0, 0.0)).to(u.dtype)
    s = torch.where(angle_idx == 1, 1.0,
                    torch.where(angle_idx == 3, -1.0, 0.0)).to(u.dtype)
    du = u - 0.5
    dv = v - 0.5
    bu = du * c - dv * s + 0.5
    bv = dv * c + du * s + 0.5

    half_w = LINE_W / 2
    if aa:
        cap_l = LINE_W * inv_fw

    def line(d, hw=half_w):
        if aa:
            cap = cap_l if hw == half_w else (2.0 * hw) * inv_fw
            return torch.clamp(torch.minimum(
                (hw - torch.abs(d)) * inv_fw + 0.5, cap), min=0.0)
        return torch.abs(d) < hw

    def edge_pair(x):
        return line(torch.abs(x - 0.5) - (0.5 - EDGE_INSET))

    def gate(cov, b):
        return cov * b.to(cov.dtype) if aa else (cov & b)

    def bor(a, b):
        return a + b if aa else (a | b)

    def dashed(p):
        return torch.remainder(p / DASH_PERIOD, 1.0) < DASH_DUTY

    straight_center = gate(line(bu - 0.5), dashed(bv))
    straight_edge = edge_pair(bu)

    def arc(cu, cv):
        dx = bu - cu
        dz = bv - cv
        r = torch.sqrt(dx * dx + dz * dz)
        center = gate(line(r - 0.5), dashed(
            (r + (torch.abs(dz) - torch.abs(dx))) * 0.78539816))
        return center, edge_pair(r)

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
    dash_uv = dashed(bu + bv)
    k3l_center = gate(bor(bor(zm_m, zp_m), xp_m), dash_uv)
    k3r_center = gate(bor(bor(zm_m, zp_m), xm_m), dash_uv)
    k4_center = gate(bor(bor(zm_m, zp_m), bor(xm_m, xp_m)), dash_uv)
    k3l_stop = bor(bor(zm_s, zp_s), xp_s)
    k3r_stop = bor(bor(zm_s, zp_s), xm_s)
    k4_stop = bor(bor(zm_s, zp_s), bor(xm_s, xp_s))

    k = kind

    def by_kind(terms):
        out = zero if aa else torch.zeros_like(u, dtype=torch.bool)
        for kk, mask in terms:
            out = torch.where(k == kk, mask, out)
        return out

    yellow = by_kind([
        (T.TILE_STRAIGHT, straight_center), (T.TILE_CURVE_LEFT, cl_center),
        (T.TILE_CURVE_RIGHT, cr_center), (T.TILE_3WAY_LEFT, k3l_center),
        (T.TILE_3WAY_RIGHT, k3r_center), (T.TILE_4WAY, k4_center),
    ])
    white = by_kind([
        (T.TILE_STRAIGHT, straight_edge), (T.TILE_CURVE_LEFT, cl_edge),
        (T.TILE_CURVE_RIGHT, cr_edge), (T.TILE_3WAY_LEFT, k3l_stop),
        (T.TILE_3WAY_RIGHT, k3r_stop), (T.TILE_4WAY, k4_stop),
    ])
    if aa:
        white = torch.clamp(white, max=1.0)
        yellow = torch.clamp(yellow, max=1.0)
        if any_x:
            yellow = yellow * (1.0 - white)

    is_road = (k >= T.TILE_STRAIGHT) & (k <= T.TILE_ASPHALT)
    is_grass = k == T.TILE_GRASS
    is_floor = k == T.TILE_FLOOR
    return yellow, white, is_road, is_grass, is_floor, bu, bv


def _noise_h16f(bu, bv, kind, variant):
    """Low 16 bits of the texel hash as float32 in [0, 65536) (the front
    of shading._hash_noise). int32 wraparound and arithmetic >> are part
    of the definition."""
    tx = torch.clamp((bu * NOISE_CELLS).to(torch.int32), max=NOISE_CELLS - 1)
    ty = torch.clamp((bv * NOISE_CELLS).to(torch.int32), max=NOISE_CELLS - 1)
    h = tx | (ty << 7) | ((variant + ((kind << 3) - kind)) << 14)
    h = h + (h << 10)
    h = h ^ (h >> 6)
    h = h + (h << 3)
    h = h ^ (h >> 11)
    h = h + (h << 15)
    h = h ^ (h >> 7)
    return (h & 0xFFFF).to(torch.float32)


def _shade_pixels(kind, angle_idx, u, v, any_x, inv_fw=None, variant=None):
    """Tile color (r, g, b): base color, markings (coverage blend under
    AA), hash noise. ``variant`` is the per-pixel texture variant (int32,
    0..3, from the packed tile byte) with brightness 0.94 + 0.04*variant;
    None is variant 0, the blob render's no-randomization path."""
    yellow, white, is_road, is_grass, is_floor, bu, bv = _tile_masks(
        kind, angle_idx, u, v, any_x, inv_fw=inv_fw)

    def chan(ci):
        base = torch.where(
            is_road, ASPHALT[ci],
            torch.where(is_grass, GRASS[ci],
                        torch.where(is_floor, FLOOR[ci], EMPTY[ci])),
        ).to(u.dtype)
        if inv_fw is not None:
            return (base + yellow * (YELLOW[ci] - ASPHALT[ci])
                    + white * (WHITE[ci] - ASPHALT[ci]))
        out = torch.where(yellow, YELLOW[ci], base)
        return torch.where(white, WHITE[ci], out)

    r_, g_, b_ = chan(0), chan(1), chan(2)
    n = _noise_h16f(bu, bv, kind, 0 if variant is None else variant) \
        / 32768.0 - 1.0
    amp = torch.where(is_grass, 0.03,
                      torch.where(is_road, NOISE_AMP, 0.015)).to(u.dtype)
    noise = amp * n
    if variant is None:
        bright = 0.94
    else:
        bright = 0.94 + 0.04 * variant.to(u.dtype)
    return r_ * bright + noise, g_ * bright + noise, b_ * bright + noise
