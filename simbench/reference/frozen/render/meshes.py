"""Procedural object geometry: primitive-soup models per object kind.

Counterpart of dtown/render/meshes.py. Each kind is a few spheres and
boxes in model space (facing +x, ground at y=0, meters at scale 1), which
the per-pixel ray caster intersects directly.
"""
import functools

import numpy as np

from simbench.reference.frozen import types as T

P_MAX = 4

SPHERE = 0
BOX = 1

# kind -> list of (type, center(3), param(3: r or half-extents), color(3),
#                  phase_sensitive)
_PRIMS = {
    "duckie": [
        (SPHERE, (0.0, 0.035, 0.0), (0.040, 0, 0), (0.95, 0.78, 0.09), 0),
        (SPHERE, (0.035, 0.075, 0.0), (0.026, 0, 0), (0.96, 0.80, 0.10), 0),
        (BOX, (0.068, 0.072, 0.0), (0.016, 0.008, 0.010), (0.90, 0.45, 0.08), 0),
        (SPHERE, (-0.038, 0.052, 0.0), (0.018, 0, 0), (0.97, 0.83, 0.12), 0),
    ],
    "duckiebot": [
        (BOX, (0.0, 0.045, 0.0), (0.090, 0.045, 0.065), (0.16, 0.16, 0.20), 0),
        (BOX, (0.02, 0.10, 0.0), (0.045, 0.012, 0.045), (0.25, 0.35, 0.60), 0),
        (BOX, (-0.02, 0.028, 0.0), (0.034, 0.028, 0.072), (0.05, 0.05, 0.06), 0),
        (BOX, (0.085, 0.115, 0.0), (0.008, 0.022, 0.010), (0.10, 0.10, 0.12), 0),
    ],
    "cone": [
        (BOX, (0.0, 0.012, 0.0), (0.032, 0.012, 0.032), (0.90, 0.35, 0.10), 0),
        (BOX, (0.0, 0.048, 0.0), (0.016, 0.030, 0.016), (0.95, 0.38, 0.10), 0),
    ],
    "barrier": [
        (BOX, (0.0, 0.045, 0.0), (0.040, 0.035, 0.250), (0.85, 0.82, 0.80), 0),
        (BOX, (0.0, 0.012, 0.0), (0.044, 0.012, 0.260), (0.70, 0.20, 0.15), 0),
    ],
    "tree": [
        (BOX, (0.0, 0.06, 0.0), (0.020, 0.060, 0.020), (0.38, 0.26, 0.13), 0),
        (SPHERE, (0.0, 0.170, 0.0), (0.095, 0, 0), (0.13, 0.42, 0.12), 0),
    ],
    "house": [
        (BOX, (0.0, 0.20, 0.0), (0.240, 0.200, 0.240), (0.73, 0.53, 0.35), 0),
        (BOX, (0.0, 0.44, 0.0), (0.255, 0.045, 0.255), (0.55, 0.18, 0.12), 0),
    ],
    "truck": [
        (BOX, (0.13, 0.085, 0.0), (0.065, 0.085, 0.095), (0.30, 0.32, 0.40), 0),
        (BOX, (-0.08, 0.10, 0.0), (0.120, 0.100, 0.100), (0.78, 0.79, 0.82), 0),
    ],
    "bus": [
        (BOX, (0.0, 0.085, 0.0), (0.220, 0.085, 0.095), (0.85, 0.70, 0.15), 0),
        (BOX, (0.0, 0.155, 0.0), (0.200, 0.022, 0.090), (0.70, 0.58, 0.12), 0),
    ],
    "building": [
        (BOX, (0.0, 0.30, 0.0), (0.290, 0.300, 0.290), (0.62, 0.60, 0.58), 0),
    ],
    "trafficlight": [
        (BOX, (0.0, 0.105, 0.0), (0.014, 0.105, 0.014), (0.22, 0.22, 0.22), 0),
        (BOX, (0.0, 0.225, 0.0), (0.045, 0.028, 0.045), (0.10, 0.10, 0.10), 0),
        # phase-sensitive lamp: red when phase 0, green when phase 1
        (BOX, (0.046, 0.225, 0.0), (0.006, 0.018, 0.018), (0.9, 0.1, 0.1), 1),
    ],
}

_SIGN_FACE_COLORS = {
    "sign_stop": (0.80, 0.12, 0.10),
    "sign_T_intersect": (0.90, 0.90, 0.90),
    "sign_yield": (0.85, 0.80, 0.20),
    "sign_left_T_intersect": (0.90, 0.90, 0.90),
    "sign_right_T_intersect": (0.90, 0.90, 0.90),
    "sign_4_way_intersect": (0.90, 0.90, 0.90),
    "sign_do_not_enter": (0.85, 0.15, 0.15),
    "sign_oneway_left": (0.20, 0.30, 0.80),
    "sign_oneway_right": (0.20, 0.30, 0.80),
    "sign_duck_crossing": (0.90, 0.80, 0.20),
    "sign_pedestrian": (0.90, 0.90, 0.30),
}
_SIGN_GLYPH_COLORS = {
    "sign_stop": (0.95, 0.95, 0.95),
    "sign_T_intersect": (0.10, 0.10, 0.10),
    "sign_yield": (0.80, 0.15, 0.12),
    "sign_left_T_intersect": (0.10, 0.10, 0.10),
    "sign_right_T_intersect": (0.10, 0.10, 0.10),
    "sign_4_way_intersect": (0.15, 0.15, 0.60),
    "sign_do_not_enter": (0.95, 0.95, 0.95),
    "sign_oneway_left": (0.90, 0.90, 0.90),
    "sign_oneway_right": (0.90, 0.90, 0.90),
    "sign_duck_crossing": (0.15, 0.12, 0.10),
    "sign_pedestrian": (0.15, 0.15, 0.18),
}
for _name, _color in _SIGN_FACE_COLORS.items():
    _PRIMS[_name] = [
        (BOX, (0.0, 0.065, 0.0), (0.006, 0.065, 0.006), (0.45, 0.45, 0.45), 0),
        (BOX, (0.0, 0.145, 0.0), (0.010, 0.035, 0.045), _color, 0),
        (BOX, (0.011, 0.145, 0.0), (0.0015, 0.012, 0.022),
         _SIGN_GLYPH_COLORS[_name], 0),
    ]


# kinds registered from OBJ files (objmesh.register_custom_object):
# kind -> (tris [T, 3, 3] f32 in model space, colours [T, 3] f32), ray-cast
# by the blob render under mesh_fidelity="triangles"
TRI_MESHES = {}


@functools.lru_cache(maxsize=1)
def prim_tables():
    """Static arrays indexed by object-kind id: type [K, P] int32,
    center/param/color [K, P, 3] f32, mask/phase [K, P] bool. The result
    is shared between callers: do not write to it."""
    K = len(T.OBJ_KINDS)
    t = np.zeros((K, P_MAX), dtype=np.int32)
    c = np.zeros((K, P_MAX, 3), dtype=np.float32)
    p = np.zeros((K, P_MAX, 3), dtype=np.float32)
    col = np.zeros((K, P_MAX, 3), dtype=np.float32)
    mask = np.zeros((K, P_MAX), dtype=bool)
    phase = np.zeros((K, P_MAX), dtype=bool)
    for kind, prims in _PRIMS.items():
        k = T.OBJ_KIND_IDS[kind]
        for i, (pt, pc, pp, pcol, pph) in enumerate(prims):
            t[k, i] = pt
            c[k, i] = pc
            p[k, i] = pp
            col[k, i] = pcol
            mask[k, i] = True
            phase[k, i] = bool(pph)
    return dict(type=t, center=c, param=p, color=col, mask=mask, phase=phase)
