"""Procedural asset metadata: nominal object dimensions and colors.

Counterpart of dtown/assets.py (same table; native/mapc.cpp mirrors it).
Each kind maps to (width, height, length) in meters at scale 1 and a base
RGB color; ``length`` runs along the facing direction.
"""
import numpy as np

from simbench.reference.frozen import constants as C

OBJECT_DIMS = {
    "duckie":        ((0.090, 0.090, 0.120), (0.95, 0.78, 0.09)),
    "duckiebot":     ((0.130, 0.120, 0.180), (0.20, 0.20, 0.25)),
    "cone":          ((0.080, 0.080, 0.080), (0.95, 0.35, 0.10)),
    "barrier":       ((0.500, 0.080, 0.080), (0.85, 0.85, 0.85)),
    "tree":          ((0.250, 0.250, 0.250), (0.13, 0.42, 0.12)),
    "house":         ((0.500, 0.500, 0.500), (0.73, 0.53, 0.35)),
    "truck":         ((0.200, 0.200, 0.400), (0.70, 0.72, 0.78)),
    "bus":           ((0.200, 0.180, 0.450), (0.85, 0.70, 0.15)),
    "building":      ((0.600, 0.600, 0.600), (0.62, 0.60, 0.58)),
    "sign_stop":     ((0.180, 0.180, 0.030), (0.80, 0.12, 0.10)),
    "sign_T_intersect": ((0.180, 0.180, 0.030), (0.90, 0.90, 0.90)),
    "sign_yield":    ((0.180, 0.180, 0.030), (0.85, 0.80, 0.20)),
    "sign_left_T_intersect": ((0.180, 0.180, 0.030), (0.90, 0.90, 0.90)),
    "sign_right_T_intersect": ((0.180, 0.180, 0.030), (0.90, 0.90, 0.90)),
    "sign_4_way_intersect": ((0.180, 0.180, 0.030), (0.90, 0.90, 0.90)),
    "sign_do_not_enter": ((0.180, 0.180, 0.030), (0.85, 0.15, 0.15)),
    "sign_oneway_left": ((0.180, 0.180, 0.030), (0.20, 0.30, 0.80)),
    "sign_oneway_right": ((0.180, 0.180, 0.030), (0.20, 0.30, 0.80)),
    "sign_duck_crossing": ((0.180, 0.180, 0.030), (0.90, 0.80, 0.20)),
    "sign_pedestrian": ((0.180, 0.180, 0.030), (0.90, 0.90, 0.30)),
    "trafficlight":  ((0.150, 0.250, 0.150), (0.25, 0.25, 0.25)),
}


def object_extents(kind: str, scale: float):
    """Scaled (width, height, length) for an object kind."""
    dims, _ = OBJECT_DIMS[kind]
    return tuple(scale * d for d in dims)


def natural_height(kind: str) -> float:
    return OBJECT_DIMS[kind][0][1]


def safety_radius(kind: str, scale: float) -> float:
    """SAFETY_RAD_MULT * half-diagonal of the footprint * scale."""
    (w, _, l), _ = OBJECT_DIMS[kind]
    half_diag = 0.5 * float(np.hypot(w, l))
    return C.SAFETY_RAD_MULT * half_diag * scale
