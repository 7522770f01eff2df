"""Map compiler: YAML -> MapArrays of numpy arrays (host-side, init-time).

Counterpart of dtown/map_loader.py. The map YAMLs are data shared with
the JAX package and are read by path from ``dtown/maps/``; nothing of that
package is imported. The compiled arrays stay numpy; ``MapArrays.to``
moves them to a device. ``stack_maps`` stacks several compiled maps into
one multimap for the fused rollout's curriculum.
"""
from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import yaml

from simbench.reference.frozen import assets
from simbench.reference.frozen import constants as C
from simbench.reference.frozen import curves as curves_lib
from simbench.reference.frozen import types as T
from simbench.reference.frozen.spawn_bank import compute_spawn_bank
from simbench.reference.frozen.types import MapArrays

MAPS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "maps")

# object budgets are rounded up to a multiple of this (masked padding)
OBJECT_BUDGET_QUANTUM = 8
DYNAMIC_KINDS = ("duckie", "duckiebot", "trafficlight")


def list_maps():
    return sorted(
        f[:-5] for f in os.listdir(MAPS_DIR) if f.endswith(".yaml")
    )


def _parse_tile(token: str):
    token = token.strip()
    if "/" in token:
        kind, orient = token.split("/")
        angle = ["S", "E", "N", "W"].index(orient.strip())
    else:
        kind, angle = token, 0
    return T.TILE_KINDS[kind.strip()], angle


def _footprint_corners(pos_xz, y_rot, width, length):
    """Rectangle corners (x, z) of an object footprint rotated by y_rot;
    length runs along the facing axis (local x), width along local z."""
    hw, hl = 0.5 * width, 0.5 * length
    local = np.array(
        [[-hl, -hw], [hl, -hw], [hl, hw], [-hl, hw]], dtype=np.float64
    )
    c, s = np.cos(y_rot), np.sin(y_rot)
    world = local @ np.array([[c, s], [-s, c]]).T
    return world + np.asarray(pos_xz, dtype=np.float64)


def _norms_from_corners(corners):
    e0 = corners[1] - corners[0]
    e1 = corners[2] - corners[1]
    n = np.stack([[-e0[1], e0[0]], [-e1[1], e1[0]]])
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)


@functools.lru_cache(maxsize=None)
def load_map(map_name: str, max_objects: Optional[int] = None) -> MapArrays:
    """Compile ``dtown/maps/<map_name>.yaml`` into MapArrays (cached; the
    result is immutable)."""
    path = os.path.join(MAPS_DIR, map_name + ".yaml")
    with open(path) as f:
        data = yaml.safe_load(f)
    return compile_map(data, max_objects=max_objects)


def compile_map(data: dict, max_objects: Optional[int] = None) -> MapArrays:
    tile_size = float(data.get("tile_size", C.DEFAULT_TILE_SIZE))
    rows = data["tiles"]
    H = len(rows)
    W = len(rows[0])

    tile_kind = np.zeros((H, W), dtype=np.int32)
    tile_angle = np.zeros((H, W), dtype=np.int32)
    drivable = np.zeros((H, W), dtype=bool)
    curves = np.zeros((H, W, curves_lib.MAX_CURVES, 4, 3), dtype=np.float64)
    curve_mask = np.zeros((H, W, curves_lib.MAX_CURVES), dtype=bool)

    for j, row in enumerate(rows):
        if len(row) != W:
            raise ValueError("ragged tile rows")
        for i, token in enumerate(row):
            kind, angle = _parse_tile(str(token))
            tile_kind[j, i] = kind
            tile_angle[j, i] = angle
            if kind in T.DRIVABLE_KINDS:
                drivable[j, i] = True
                world = curves_lib.rotate_curves(
                    curves_lib.tile_curves(kind), angle) * tile_size
                world[..., 0] += (i + 0.5) * tile_size
                world[..., 2] += (j + 0.5) * tile_size
                n = world.shape[0]
                curves[j, i, :n] = world
                curve_mask[j, i, :n] = True

    tile_tex = tile_kind.copy()

    # --- Objects -------------------------------------------------------
    objs = data.get("objects", []) or []
    q = OBJECT_BUDGET_QUANTUM
    M = max_objects or max(q, -(-len(objs) // q) * q)
    if len(objs) > M:
        raise ValueError(f"map has {len(objs)} objects > budget {M}")

    obj_pos = np.zeros((M, 3), dtype=np.float64)
    obj_y_rot = np.zeros((M,), dtype=np.float64)
    obj_scale = np.ones((M,), dtype=np.float64)
    obj_kind = np.zeros((M,), dtype=np.int32)
    obj_corners = np.zeros((M, 4, 2), dtype=np.float64)
    obj_norms = np.tile(np.array([[1.0, 0.0], [0.0, 1.0]]), (M, 1, 1))
    obj_safety_rad = np.zeros((M,), dtype=np.float64)
    obj_height = np.zeros((M,), dtype=np.float64)
    obj_halfdims = np.zeros((M, 2), dtype=np.float64)
    obj_mask = np.zeros((M,), dtype=bool)
    obj_optional = np.zeros((M,), dtype=bool)
    obj_is_dynamic = np.zeros((M,), dtype=bool)
    obj_walk_dist = np.full((M,), C.DUCKIE_WALK_DISTANCE, dtype=np.float64)

    for m, ob in enumerate(objs):
        kind = ob["kind"]
        pos = list(ob["pos"])
        x = float(pos[0]) * tile_size
        z = float(pos[1]) * tile_size
        y = float(pos[2]) if len(pos) > 2 else 0.0
        y_rot = np.deg2rad(float(ob.get("rotate", 0.0)))
        if "height" in ob:
            scale = float(ob["height"]) / assets.natural_height(kind)
        else:
            scale = float(ob.get("scale", 1.0))
        ow, oh, ol = assets.object_extents(kind, scale)
        static = bool(ob.get("static", kind not in ("duckie", "duckiebot")))
        is_dynamic = (not static) and kind in DYNAMIC_KINDS
        if kind == "trafficlight":
            is_dynamic = True  # animated phase, immobile

        obj_pos[m] = (x, y, z)
        obj_y_rot[m] = y_rot
        obj_scale[m] = scale
        obj_kind[m] = T.OBJ_KIND_IDS[kind]
        obj_corners[m] = _footprint_corners((x, z), y_rot, ow, ol)
        obj_norms[m] = _norms_from_corners(obj_corners[m])
        obj_safety_rad[m] = assets.safety_radius(kind, scale)
        obj_height[m] = oh
        obj_halfdims[m] = (0.5 * ow, 0.5 * ol)
        obj_mask[m] = True
        obj_optional[m] = bool(ob.get("optional", False))
        obj_is_dynamic[m] = is_dynamic
        obj_walk_dist[m] = float(ob.get("walk_distance", obj_walk_dist[m]))

    driv_flat = drivable.reshape(-1).astype(np.float64)
    total = max(driv_flat.sum(), 1.0)

    sp_pos, sp_angle, sp_deg, sp_mask = compute_spawn_bank(
        tile_size, drivable, curves, curve_mask, obj_corners, obj_norms,
        obj_pos, obj_safety_rad, obj_mask,
    )

    f32 = lambda a: np.asarray(a, dtype=np.float32)
    return MapArrays(
        tile_kind=tile_kind,
        tile_angle=tile_angle,
        drivable=drivable,
        tile_tex=tile_tex,
        curves=f32(curves),
        curve_mask=curve_mask,
        obj_pos=f32(obj_pos),
        obj_y_rot=f32(obj_y_rot),
        obj_scale=f32(obj_scale),
        obj_kind=obj_kind,
        obj_corners=f32(obj_corners),
        obj_norms=f32(obj_norms),
        obj_safety_rad=f32(obj_safety_rad),
        obj_height=f32(obj_height),
        obj_halfdims=f32(obj_halfdims),
        obj_mask=obj_mask,
        obj_optional=obj_optional,
        obj_is_dynamic=obj_is_dynamic,
        obj_walk_dist=f32(obj_walk_dist),
        tile_size=f32(tile_size),
        drivable_frac=f32(driv_flat / total),
        spawn_pos=f32(sp_pos),
        spawn_angle=f32(sp_angle),
        spawn_lane_deg=f32(sp_deg),
        spawn_mask=sp_mask,
    )


def stack_maps(map_names) -> MapArrays:
    """Stack several compiled maps along a leading map axis (a multimap).

    Every map is padded with zeros to the largest member's grid and object
    budget; the tile size becomes one per map and the spawn banks stack as
    they are. Envs pick their member by a per-env map
    index (the blob's F_MAPID row)."""
    compiled = [load_map(n) for n in map_names]
    H = max(m.tile_kind.shape[0] for m in compiled)
    W = max(m.tile_kind.shape[1] for m in compiled)
    M = max(m.obj_pos.shape[0] for m in compiled)
    grid = ("tile_kind", "tile_angle", "drivable", "tile_tex", "curves",
            "curve_mask")
    objects = ("obj_pos", "obj_y_rot", "obj_scale", "obj_kind",
               "obj_corners", "obj_norms", "obj_safety_rad", "obj_height",
               "obj_halfdims", "obj_mask", "obj_optional", "obj_is_dynamic",
               "obj_walk_dist")

    def pad(a, first, last):
        pads = [(0, 0)] * a.ndim
        pads[0] = first
        if last is not None:
            pads[1] = last
        return np.pad(a, pads)

    def pad_map(m):
        h, w = m.tile_kind.shape
        out = {f: getattr(m, f) for f in T.MAP_FIELDS}
        for f in grid:
            out[f] = pad(out[f], (0, H - h), (0, W - w))
        for f in objects:
            out[f] = pad(out[f], (0, M - m.obj_pos.shape[0]), None)
        out["drivable_frac"] = pad(m.drivable_frac.reshape(h, w),
                                   (0, H - h), (0, W - w)).reshape(-1)
        return out

    padded = [pad_map(m) for m in compiled]
    return MapArrays(**{f: np.stack([p[f] for p in padded])
                        for f in T.MAP_FIELDS})
