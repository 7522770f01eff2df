"""Wavefront OBJ meshes as object kinds.

Counterpart of dtown/render/objmesh.py. ``ObjMesh`` parses v / f / usemtl
/ mtllib and the .mtl Kd colours, with a class-level cache (``get``); it
gives a fixed-budget triangle buffer (``to_triangles``, largest faces
first, ground-normalized) and a box per material group (``to_prims``).
``register_custom_object`` installs a mesh as a new object kind usable
from map YAMLs: its boxes render on every path, and with
``mesh_fidelity="triangles"`` the fused rollout's blob render ray-casts
its largest triangles instead.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

GREY = (0.6, 0.6, 0.6)


class ObjMesh:
    """Parsed OBJ with per-material bounding boxes and its triangles."""

    _cache: Dict[str, "ObjMesh"] = {}

    @classmethod
    def get(cls, mesh_path: str) -> "ObjMesh":
        key = os.path.abspath(mesh_path)
        if key not in cls._cache:
            cls._cache[key] = cls(mesh_path)
        return cls._cache[key]

    def __init__(self, path: str):
        self.path = path
        verts: List[List[float]] = []
        groups: Dict[Optional[str], List[int]] = {}
        mtl_colors = {}
        tri_list: List[List[int]] = []
        tri_mtls: List[Optional[str]] = []
        cur_mtl = None

        def load_mtl(p):
            name = None
            if not os.path.exists(p):
                return
            with open(p) as f:
                for line in f:
                    t = line.split()
                    if not t:
                        continue
                    if t[0] == "newmtl":
                        name = t[1]
                    elif t[0] == "Kd" and name:
                        mtl_colors[name] = np.array(
                            [float(x) for x in t[1:4]])

        with open(path) as f:
            for line in f:
                t = line.split()
                if not t or t[0].startswith("#"):
                    continue
                if t[0] == "v":
                    verts.append([float(x) for x in t[1:4]])
                elif t[0] == "usemtl":
                    cur_mtl = t[1]
                elif t[0] == "mtllib":
                    load_mtl(os.path.join(os.path.dirname(path), t[1]))
                elif t[0] == "f":
                    idxs = [int(w.split("/")[0]) for w in t[1:]]
                    idxs = [i - 1 if i > 0 else len(verts) + i for i in idxs]
                    groups.setdefault(cur_mtl, []).extend(idxs)
                    # fan-triangulate the face
                    for a in range(1, len(idxs) - 1):
                        tri_list.append([idxs[0], idxs[a], idxs[a + 1]])
                        tri_mtls.append(cur_mtl)
        load_mtl(os.path.splitext(path)[0] + ".mtl")

        self.verts = np.asarray(verts, dtype=np.float64)
        if len(self.verts) == 0:
            raise ValueError(f"no vertices in {path}")
        self.min_coords = self.verts.min(axis=0)
        self.max_coords = self.verts.max(axis=0)
        if tri_list:
            self.triangles = self.verts[np.asarray(tri_list)]   # [T, 3, 3]
            self.tri_colors = np.stack([
                mtl_colors.get(m, np.array(GREY)) for m in tri_mtls])
        else:
            self.triangles = np.zeros((0, 3, 3))
            self.tri_colors = np.zeros((0, 3))
        # one box per material group: (centre, half extents, colour)
        self.group_boxes = []
        for mtl, idxs in groups.items():
            used = self.verts[np.unique(np.asarray(idxs))]
            lo, hi = used.min(axis=0), used.max(axis=0)
            self.group_boxes.append((0.5 * (lo + hi), 0.5 * (hi - lo),
                                     mtl_colors.get(mtl, np.array(GREY))))
        if not self.group_boxes:
            lo, hi = self.min_coords, self.max_coords
            self.group_boxes = [(0.5 * (lo + hi), 0.5 * (hi - lo),
                                 np.array(GREY))]

    def to_triangles(self, max_tris: int = 64):
        """(tris [max_tris, 3, 3] f32, colours [max_tris, 3] f32): the
        largest-area triangles first, min y moved to 0, padded with
        degenerate (zero) triangles."""
        tris = self.triangles.copy()
        cols = self.tri_colors.copy()
        if len(tris):
            tris[:, :, 1] -= self.min_coords[1]
            e1 = tris[:, 1] - tris[:, 0]
            e2 = tris[:, 2] - tris[:, 0]
            area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
            order = np.argsort(-area)[:max_tris]
            tris, cols = tris[order], cols[order]
        pad = max_tris - len(tris)
        if pad > 0:
            tris = np.concatenate([tris, np.zeros((pad, 3, 3))])
            cols = np.concatenate([cols, np.zeros((pad, 3))])
        return tris.astype(np.float32), cols.astype(np.float32)

    def to_prims(self, max_prims: int = 3):
        """The largest-volume material boxes as renderer primitives
        (meshes._PRIMS entries), min y moved to 0."""
        from simbench.reference.frozen.render import meshes as meshlib

        boxes = sorted(
            self.group_boxes,
            key=lambda b: -float(np.prod(np.maximum(b[1], 1e-9))),
        )[:max_prims]
        y0 = self.min_coords[1]
        prims = []
        for center, he, color in boxes:
            c = center.copy()
            c[1] -= y0
            prims.append((meshlib.BOX, tuple(c),
                          tuple(np.maximum(he, 1e-4)), tuple(color), 0))
        return prims


def register_custom_object(kind: str, mesh_path: str):
    """Install an OBJ mesh as object kind ``kind`` for map YAMLs: its
    footprint and colour (assets.OBJECT_DIMS), a kind id, its boxes
    (meshes._PRIMS) and its triangle buffer (meshes.TRI_MESHES). Clears
    the primitive tables cached over the kind list."""
    from simbench.reference.frozen import assets, types as T
    from simbench.reference.frozen.render import meshes as meshlib

    mesh = ObjMesh.get(mesh_path)
    dims = mesh.max_coords - mesh.min_coords
    assets.OBJECT_DIMS[kind] = (
        (float(dims[2]), float(dims[1]), float(dims[0])),
        tuple(float(x) for x in mesh.group_boxes[0][2]),
    )
    if kind not in T.OBJ_KIND_IDS:
        T.OBJ_KINDS.append(kind)
        T.OBJ_KIND_IDS[kind] = len(T.OBJ_KINDS) - 1
    meshlib._PRIMS[kind] = mesh.to_prims()
    meshlib.TRI_MESHES[kind] = mesh.to_triangles()
    meshlib.prim_tables.cache_clear()
