"""The town as the map YAML states it, worked out here alone, and the
checks of a compiled map and of spawn poses against it.

The rules are gym-duckietown's (github.com/duckietown/gym-duckietown,
``simulator.py``), written from what they state and not from the program:

- ``tiles`` is a grid of rows; row j, column i spans x in [i, i+1) and z in
  [j, j+1) tiles of ``tile_size`` metres (0.585 unless the YAML says); a
  token is ``kind`` or ``kind/orientation``;
- straight, curve_left, curve_right, 3way_left, 3way_right and 4way tiles
  are drivable; every other kind is not;
- traffic keeps right: a lane runs 0.2 tile right of the road's centre
  line, so a car that crosses a tile edge in direction d crosses it at the
  edge's midpoint plus 0.2 tile to the right of d;
- the lanes of a tile are cubic Beziers from an entry port to an exit port,
  tangent to the direction of travel at both; a straight tile carries 2
  (straight on, each way), a curve 2 (a left and a right turn), a 3-way
  tile 6 (2 straight, 2 left, 2 right) and a 4-way tile 12 (4 of each);
- a lane that leaves a tile enters the neighbouring tile there: the road
  network is closed;
- an object's ``pos`` is in tiles (x, z, optionally y in metres), its
  ``rotate`` in degrees; it is static unless the YAML says otherwise, and
  duckies and duckiebots that are not static move;
- a spawn pose is valid where the robot's centre (``CAMERA_FORWARD_DIST -
  ROBOT_LENGTH / 2`` ahead of the axle), the wheels either side of it and
  its front, at a safety factor of 1.3, all lie on drivable tiles.
"""
from __future__ import annotations

import os

import numpy as np
import yaml

MAPS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "maps")
DEFAULT_TILE_SIZE = 0.585
DRIVABLE = ("straight", "curve_left", "curve_right", "3way_left",
            "3way_right", "4way")
LANE = 0.2
# (straight, left, right) turns each drivable kind carries
MANEUVERS = {"straight": (2, 0, 0), "curve_left": (0, 1, 1),
             "curve_right": (0, 1, 1), "3way_left": (2, 2, 2),
             "3way_right": (2, 2, 2), "4way": (4, 4, 4)}
MOVING = ("duckie", "duckiebot")
# the Duckiebot's footprint (m): camera ahead of the axle, body, wheel base
CAMERA_FORWARD_DIST = 0.066
ROBOT_LENGTH = 0.18
ROBOT_WIDTH = 0.13 + 0.02
SPAWN_SAFETY = 1.3
# the four directions of travel across a tile edge, (dx, dz)
AXES = np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]])


class Town:
    """The grid and the objects of one map YAML."""

    def __init__(self, name):
        with open(os.path.join(MAPS, name + ".yaml")) as f:
            data = yaml.safe_load(f)
        self.ts = float(data.get("tile_size", DEFAULT_TILE_SIZE))
        self.kind = [[str(t).split("/")[0].strip() for t in row]
                     for row in data["tiles"]]
        self.drivable = np.array([[k in DRIVABLE for k in row]
                                  for row in self.kind])
        self.objects = []
        for ob in data.get("objects") or []:
            pos = [float(v) for v in ob["pos"]]
            static = bool(ob.get("static", ob["kind"] not in MOVING))
            self.objects.append(dict(
                kind=ob["kind"],
                pos=(pos[0] * self.ts, pos[2] if len(pos) > 2 else 0.0,
                     pos[1] * self.ts),
                rot=np.deg2rad(float(ob.get("rotate", 0.0))),
                optional=bool(ob.get("optional", False)),
                moves=not static and ob["kind"] in MOVING))

    def on_road(self, x, z):
        """Whether points (x, z) [N] lie on drivable tiles."""
        i = np.floor(x / self.ts).astype(np.int64)
        j = np.floor(z / self.ts).astype(np.int64)
        H, W = self.drivable.shape
        inside = (i >= 0) & (i < W) & (j >= 0) & (j < H)
        return inside & self.drivable[np.clip(j, 0, H - 1),
                                      np.clip(i, 0, W - 1)]


def _axis(v):
    """The index in AXES of the direction nearest v, and the sine of the
    angle between them."""
    n = v / max(np.linalg.norm(v), 1e-30)
    k = int(np.argmax(AXES @ n))
    return k, abs(AXES[k][0] * n[1] - AXES[k][1] * n[0])


def _right(d):
    """The right of a direction of travel (dx, dz), seen from above with y
    up: a quarter turn clockwise in (x, z)."""
    return np.array([-d[1], d[0]])


def _port(town, i, j, d, side):
    """The lane's crossing of tile (i, j)'s edge in direction of travel d:
    the edge behind the car (side -1, entering) or ahead (+1, leaving)."""
    c = (np.array([i, j], dtype=np.float64) + 0.5) * town.ts
    return c + side * 0.5 * town.ts * d + LANE * town.ts * _right(d)


def map_gap(town, kinds, m):
    """The worst gap (metres, radians or 0/1) between a compiled map and
    the town: ``m`` holds numpy arrays drivable [H, W], curves [H, W, C,
    4, 3], curve_mask [H, W, C], obj_pos [M, 3], obj_y_rot [M], obj_mask,
    obj_optional and obj_is_dynamic [M]; ``kinds`` names each object's
    kind. A structural mismatch (a tile, a lane, a count) reads inf."""
    inf = float("inf")
    if m["drivable"].shape != town.drivable.shape or \
            not np.array_equal(m["drivable"], town.drivable):
        return inf
    gap = abs(float(m["tile_size"]) - town.ts)
    H, W = town.drivable.shape
    entries, exits = set(), []
    for j in range(H):
        for i in range(W):
            cps = m["curves"][j, i][m["curve_mask"][j, i]].astype(np.float64)
            if not town.drivable[j, i]:
                if len(cps):
                    return inf
                continue
            turns = [0, 0, 0]
            for c in cps[:, :, [0, 2]]:
                kin, s_in = _axis(c[1] - c[0])
                kout, s_out = _axis(c[3] - c[2])
                d_in, d_out = AXES[kin], AXES[kout]
                turn = (kout - kin) % 4     # +1: a right turn, 3: a left
                if turn == 2:
                    return inf
                turns[{0: 0, 3: 1, 1: 2}[turn]] += 1
                p0, p3 = _port(town, i, j, d_in, -1), _port(town, i, j,
                                                           d_out, 1)
                gap = max(gap, s_in, s_out, float(np.abs(c[0] - p0).max()),
                          float(np.abs(c[3] - p3).max()))
                entries.add((i, j, kin))
                exits.append((i + int(d_out[0]), j + int(d_out[1]), kout))
            if tuple(turns) != MANEUVERS[town.kind[j][i]]:
                return inf
    # every lane that leaves a tile enters the next one there
    if any(e not in entries for e in exits):
        return inf
    M = len(town.objects)
    if int(m["obj_mask"].sum()) != M or not m["obj_mask"][:M].all() or \
            list(kinds[:M]) != [o["kind"] for o in town.objects]:
        return inf
    for k, o in enumerate(town.objects):
        gap = max(gap, float(np.abs(m["obj_pos"][k] - o["pos"]).max()),
                  abs(float(m["obj_y_rot"][k]) - o["rot"]),
                  float(bool(m["obj_optional"][k]) != o["optional"]))
        # a moving object is dynamic; a traffic light is too (its phase)
        if o["moves"] and not m["obj_is_dynamic"][k]:
            return inf
    return gap


def off_road(town, x, z, angle):
    """How many of the poses (axle x, z and heading angle [N], the heading
    (cos a, -sin a) in (x, z)) are not valid spawns: the robot's centre,
    the wheels either side and its front not all on drivable tiles."""
    x, z, a = (np.asarray(v, dtype=np.float64) for v in (x, z, angle))
    f = np.stack([np.cos(a), -np.sin(a)], -1)
    r = np.stack([np.sin(a), np.cos(a)], -1)
    c = np.stack([x, z], -1) + (CAMERA_FORWARD_DIST - 0.5 * ROBOT_LENGTH) * f
    ok = town.on_road(c[:, 0], c[:, 1])
    for p in (c - SPAWN_SAFETY * 0.5 * ROBOT_WIDTH * r,
              c + SPAWN_SAFETY * 0.5 * ROBOT_WIDTH * r,
              c + SPAWN_SAFETY * 0.5 * ROBOT_LENGTH * f):
        ok &= town.on_road(p[:, 0], p[:, 1])
    return int((~ok).sum())
