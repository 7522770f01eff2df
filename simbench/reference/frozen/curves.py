"""Per-tile-kind lane centerline control points (numpy).

Counterpart of dtown/curves.py: each maneuver is a cubic bezier between an
entry and an exit lane port, LANE_OFFSET tile fractions right of the road
center, in tile-local fraction units (tile center at the origin).
"""
import numpy as np

from simbench.reference.frozen import constants as C
from simbench.reference.frozen import types as T

LANE = C.LANE_OFFSET
MAX_CURVES = 12  # 4way: 4 entries x 3 maneuvers


def _right(d):
    dx, dz = d
    return np.array([-dz, dx], dtype=np.float64)


def _left(d):
    return -_right(d)


def _entry(d):
    d = np.asarray(d, dtype=np.float64)
    return -0.5 * d + LANE * _right(d)


def _straight_cps(d):
    d = np.asarray(d, dtype=np.float64)
    p0 = _entry(d)
    p3 = 0.5 * d + LANE * _right(d)
    return np.stack([p0, p0 + 0.25 * d, p3 - 0.25 * d, p3])


def _left_cps(d):
    d = np.asarray(d, dtype=np.float64)
    l = _left(d)
    p0 = _entry(d)
    p3 = 0.5 * l + LANE * d
    return np.stack([p0, p0 + 0.5 * d, p3 - 0.5 * l, p3])


def _right_cps(d):
    d = np.asarray(d, dtype=np.float64)
    r = _right(d)
    p0 = _entry(d)
    p3 = 0.5 * r - LANE * d
    return np.stack([p0, p0 + 0.3 * d, p3 - 0.2 * r, p3])


_ZP = (0.0, 1.0)
_ZM = (0.0, -1.0)
_XP = (1.0, 0.0)
_XM = (-1.0, 0.0)


def _lift(cps_xz):
    """[4, 2] (x, z) -> [4, 3] (x, 0, z)."""
    out = np.zeros((4, 3), dtype=np.float64)
    out[:, 0] = cps_xz[:, 0]
    out[:, 2] = cps_xz[:, 1]
    return out


def tile_curves(kind: int) -> np.ndarray:
    """Base-orientation curves for a tile kind -> [n_curves, 4, 3]."""
    if kind == T.TILE_STRAIGHT:
        sets = [_straight_cps(_ZP), _straight_cps(_ZM)]
    elif kind == T.TILE_CURVE_LEFT:
        sets = [_left_cps(_ZP), _right_cps(_XM)]
    elif kind == T.TILE_CURVE_RIGHT:
        sets = [_right_cps(_ZP), _left_cps(_XP)]
    elif kind == T.TILE_3WAY_LEFT:
        sets = [
            _straight_cps(_ZP), _left_cps(_ZP),
            _straight_cps(_ZM), _right_cps(_ZM),
            _left_cps(_XM), _right_cps(_XM),
        ]
    elif kind == T.TILE_3WAY_RIGHT:
        sets = [
            _straight_cps(_ZP), _right_cps(_ZP),
            _straight_cps(_ZM), _left_cps(_ZM),
            _left_cps(_XP), _right_cps(_XP),
        ]
    elif kind == T.TILE_4WAY:
        sets = []
        for d in (_ZP, _ZM, _XP, _XM):
            sets += [_straight_cps(d), _left_cps(d), _right_cps(d)]
    else:
        return np.zeros((0, 4, 3), dtype=np.float64)
    return np.stack([_lift(s) for s in sets])


def rotate_curves(cps: np.ndarray, angle_idx: int) -> np.ndarray:
    """Rotate tile-local curves by angle_idx * 90 deg about +y:
    (x, z) -> (x cos + z sin, z cos - x sin)."""
    theta = angle_idx * np.pi / 2.0
    c, s = np.cos(theta), np.sin(theta)
    x = cps[..., 0]
    z = cps[..., 2]
    out = cps.copy()
    out[..., 0] = x * c + z * s
    out[..., 2] = z * c - x * s
    return out
