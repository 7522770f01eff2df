"""Size-aware primitive LOD culling (counterpart of dtown/render/lod.py).

    cull_dist(prim) = min(cfg.obj_cull_dist,
                          r_model * scale / tan(q * fov_y / H))

with q = cfg.obj_lod_px (0 disables LOD) and r_model the prim's own
bounding radius (box: |half_extents|, sphere: radius). The angular
threshold uses the nominal vertical fov.
"""
import math

import numpy as np

from simbench.reference.frozen import constants as C
from simbench.reference.frozen.render import meshes as meshlib


def lod_tan(cfg) -> float:
    """tan of the angular cull threshold; 0.0 when LOD is disabled."""
    q = float(getattr(cfg, "obj_lod_px", 0.0) or 0.0)
    if q <= 0.0:
        return 0.0
    return math.tan(q * math.radians(float(C.CAMERA_FOV_Y))
                    / float(cfg.camera_height))


def prim_radii() -> np.ndarray:
    """[n_kinds, P_MAX] model-space bounding radius of each primitive
    (0 where the slot is unused)."""
    t = meshlib.prim_tables()
    Kn, P = t["mask"].shape
    r = np.zeros((Kn, P), dtype=np.float64)
    for k in range(Kn):
        for p in range(P):
            if not t["mask"][k, p]:
                continue
            if int(t["type"][k, p]) == meshlib.BOX:
                r[k, p] = float(np.linalg.norm(t["param"][k, p]))
            else:
                r[k, p] = float(t["param"][k, p][0])
    return r


def prim_culld_base(cfg) -> np.ndarray:
    """[n_kinds, P_MAX] f32 base cull distances in model units; +inf where
    LOD is off or the slot is unused."""
    tq = lod_tan(cfg)
    if tq <= 0.0:
        shape = meshlib.prim_tables()["mask"].shape
        return np.full(shape, np.inf, dtype=np.float32)
    r = prim_radii()
    with np.errstate(divide="ignore"):
        base = np.where(r > 0.0, r / tq, np.inf)
    return base.astype(np.float32)


def kind_culld_max(cfg) -> np.ndarray:
    """[n_kinds] f32 max base cull distance over a kind's primitives: the
    distance beyond which the whole object is invisible (the object-level
    cull of the row-fed renders). +inf when LOD is off."""
    base = prim_culld_base(cfg)
    mask = meshlib.prim_tables()["mask"]
    b = np.where(mask, base, 0.0)
    out = b.max(axis=1)
    return np.where(out > 0.0, out, np.inf).astype(np.float32)
