"""Blob-fed render: camera frames straight from the state blob.

Counterpart of dtown/render/blob_raster.py. Each step of the fused
rollout renders every env's camera frame directly from the state blob
[nf, B]: camera basis from the pose rows, ray-ground hit, tile lookup in
the packed tile words, analytic markings with box-filter AA, hash noise,
then the scene's sphere/box primitives with size-aware LOD culls, and the
sky. Moving NPCs take their poses from the blob's NPC rows (walking
duckies with their gait wiggle); under domain randomization the camera,
light, colours, texture variants and optional objects come from the
blob's DR rows, and the rays are built per env; grayscale renders one
luma plane.

``build_render_plan`` bakes the scene on the host (same plan as the
reference); ``pack_plan`` flattens it into float32/int32 tables for the
kernel, so one compiled kernel serves every scene. On a CUDA blob
``render_frames_from_blob`` launches csrc/blob_render.cu; on a CPU blob it
runs ``render_frames_reference``, the plain torch version with the same
float32 operation order.

A stack of maps (map_loader.stack_maps) renders through one merged plan:
each env reads its map row (F_MAPID) once, offsets its tile-word index
into its member's segment and skips the objects of other members.

Fisheye (cfg.distortion) is baked at ray level, as in the reference: the
static ray planes are built from the inverted lens model's NDC table
(render/distortion.py), and under domain randomization the kernel reads
that table where it reads the linear ramps otherwise. Kinds registered
from OBJ files (render/objmesh.py) render as their largest triangles under
``mesh_fidelity="triangles"`` (Moeller-Trumbore in model space, flat
two-sided shading), else as their material boxes. Any frame with
H*W % 128 == 0 renders; one block per env and pixel block needs no row
tiling at the reference's native 640x480.

Differences from the TPU kernel, none beyond rounding: the static RGB
ground is shaded in float32 and quantized once (the TPU default carries
packed u8 bytes; the two differ by <= ~2 counts), prims fold sequentially
instead of pair-combined (same winner), objects are visited in plan order,
and the TPU kernel's conservative cluster culls become, in the CUDA
kernel, one per-object view cull (``pack_plan``'s ``view_cull``) and a
per-pixel bounding-sphere test (``kept`` and ``sphere_pass`` mirror them):
they never change a pixel, so the plain version renders every object; the
moving NPCs' view half-plane cull is kept in both.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from dtown_torch import _build
from dtown_torch import constants as Cc
from dtown_torch import types as T
from dtown_torch.geometry import sincos
from dtown_torch.ops import state_kernel as sk
from dtown_torch.render import lod as lodlib
from dtown_torch.render import meshes as meshlib
from dtown_torch.render.shading import (
    ASPHALT, EMPTY, FLOOR, GRASS, NOISE_AMP, WHITE, YELLOW,
)
from dtown_torch.randomization import variant_hash
from dtown_torch.render.distortion import undistorted_ndc
from dtown_torch.render.tile_shading import (
    INTERSECTION_KINDS, _noise_h16f, _select_word, _shade_pixels,
    _tile_masks,
)

LANE_N = 128  # pixel lane width of the [S, 128] frame layout

# Triangles per OBJ-registered object on the fused path (largest first;
# each costs about two box primitives in the kernel)
KERNEL_TRI_BUDGET = 8
# Primitives a box/sphere object holds at most (meshes.P_MAX): with
# KERNEL_TRI_BUDGET, the capacity of the kernel's compacted list
MAX_OBJ_PRIMS = meshlib.P_MAX
# The margin (world units) beyond an object's bounding radius of the
# kernel's view cull and bounding-sphere test, so that float32 rounding of
# a hit near the plane or the sphere cannot show an object they skip; and
# the least horizontal forward component of a unit ray with which
# pack_plan turns the view cull on
VIEW_PAD = 0.01
VIEW_MIN_FWD = 0.01


def pack_tile_words(kind, ang):
    """Pack flattened tile (kind, angle) grids into int32 words, 4 tiles
    per word: byte = kind | angle << 4, little-endian within the word."""
    kind = np.asarray(kind).reshape(-1).astype(np.int64)
    ang = np.asarray(ang).reshape(-1).astype(np.int64)
    byte = (kind & 0xF) | ((ang & 0x3) << 4)
    n_tiles = byte.shape[0]
    n_words = -(-n_tiles // 4)
    b = np.zeros(n_words * 4, dtype=np.int64)
    b[:n_tiles] = byte
    b4 = b.reshape(n_words, 4)
    words = (
        b4[:, 0] | (b4[:, 1] << 8) | (b4[:, 2] << 16) | (b4[:, 3] << 24)
    ).astype(np.int64)
    return [int(np.int32(w)) for w in words]


def build_render_plan(cfg, maps):
    """Bake the scene plan of one map or a stack of maps (dict), or None
    when the scene is past the budget (the reference's planless fallback):
    more than 48 real objects or 8 moving NPCs, or a stack of more than 8
    maps or of maps that differ in tile size."""
    if maps.is_stack:
        return _stack_plan(cfg, maps)
    obj_mask = np.asarray(maps.obj_mask)
    kinds = np.asarray(maps.obj_kind)
    if not cfg.render_objects:
        obj_mask = np.zeros_like(obj_mask)
    n_objects = int(obj_mask.sum())
    if n_objects > 48:
        return None
    clustered = n_objects > 24
    # moving NPCs: geometry baked per slot, pose read from the blob rows
    npcs = sk.moving_npcs(maps)
    slot_to_npc = {npc["slot"]: i for i, npc in enumerate(npcs)}
    if len(npcs) > 8:
        return None

    light = np.asarray(Cc.NOMINAL_LIGHT_DIR, np.float64)
    light = light / np.linalg.norm(light)
    amb = float(Cc.NOMINAL_AMBIENT)
    diffuse_g = max(0.0, -light[1])
    shade_g = amb + (1.0 - amb) * diffuse_g

    tan_half = math.tan(0.5 * math.radians(float(Cc.CAMERA_FOV_Y)))
    pitch = math.radians(float(Cc.CAMERA_ANGLE))

    kind = np.asarray(maps.tile_kind).reshape(-1).astype(np.int64)
    ang = np.asarray(maps.tile_angle).reshape(-1).astype(np.int64)
    words = pack_tile_words(kind, ang)
    present = frozenset(int(x) for x in np.unique(kind))

    tables = meshlib.prim_tables()
    cull_d = float(cfg.obj_cull_dist)
    lod_base = lodlib.prim_culld_base(cfg)
    pos = np.asarray(maps.obj_pos, np.float64)
    rot = np.asarray(maps.obj_y_rot, np.float64)
    scale = np.asarray(maps.obj_scale, np.float64)
    fid_tris = cfg.mesh_fidelity == "triangles"
    objs = []
    for m in np.nonzero(obj_mask)[0]:
        k = int(kinds[m])
        s_r = math.sin(-float(rot[m]))
        c_r = math.cos(-float(rot[m]))
        # world->model rotation of the light direction
        lmx = light[0] * c_r + light[2] * s_r
        lmy = light[1]
        lmz = light[2] * c_r - light[0] * s_r
        sc = float(scale[m])
        kind_name = T.OBJ_KINDS[k]
        if fid_tris and kind_name in meshlib.TRI_MESHES:
            # an OBJ kind at triangle fidelity: its largest faces, static
            # (even in an NPC slot, as in the reference)
            objs.append(dict(
                pos=tuple(float(x) for x in pos[m]),
                s_r=s_r, c_r=c_r, inv_s=1.0 / max(sc, 1e-6), scale=sc,
                l_model=(float(lmx), float(lmy), float(lmz)),
                prims=_tri_prims(meshlib.TRI_MESHES[kind_name], cull_d),
                npc_idx=None, wiggle=False, slot=int(m), map=None,
            ))
            continue
        prims = []
        for p in range(meshlib.P_MAX):
            if not tables["mask"][k, p]:
                continue
            prims.append(dict(
                is_box=int(tables["type"][k, p]) == meshlib.BOX,
                center=tuple(float(x) for x in tables["center"][k, p]),
                param=tuple(float(x) for x in tables["param"][k, p]),
                color=tuple(float(x) for x in tables["color"][k, p]),
                lamp=bool(tables["phase"][k, p]),
                culld=min(cull_d, float(lod_base[k, p]) * sc),
            ))
        npc_idx = slot_to_npc.get(int(m))
        objs.append(dict(
            pos=tuple(float(x) for x in pos[m]),
            s_r=s_r, c_r=c_r, inv_s=1.0 / max(sc, 1e-6), scale=sc,
            l_model=(float(lmx), float(lmy), float(lmz)),
            prims=prims, npc_idx=npc_idx,
            wiggle=(npc_idx is not None
                    and k == T.OBJ_KIND_IDS["duckie"]),
            slot=int(m), map=None,
        ))
    optional = np.asarray(maps.obj_optional)
    opt_bit = {}
    kbit = 0
    for s in np.nonzero(np.asarray(maps.obj_mask))[0]:
        if bool(optional[int(s)]):
            opt_bit[int(s)] = kbit
            kbit += 1
    for ob in objs:
        ob["opt_bit"] = opt_bit.get(ob["slot"])
    if clustered:
        for ob in objs:
            ob["culld"] = max(p.get("culld", cull_d) for p in ob["prims"])
            ob["lod_band"] = _lod_band(ob["culld"], cull_d)
    else:
        objs = _lod_split(objs, cull_d)

    Hg, Wg = maps.grid_shape
    return dict(
        domain_rand=bool(cfg.domain_rand),
        aa=bool(getattr(cfg, "marking_aa", True)),
        n_real=n_objects, n_npc=len(npcs), n_opt=kbit, multi=None,
        Hg=int(Hg), Wg=int(Wg), n_words=len(words), words=words,
        present=present, ts_inv=1.0 / float(maps.tile_size),
        tan_half=tan_half, sin_pitch=math.sin(pitch),
        cos_pitch=math.cos(pitch),
        cam_height=float(Cc.CAMERA_FLOOR_DIST),
        cam_fwd=float(Cc.CAMERA_FORWARD_DIST),
        light=tuple(float(x) for x in light), ambient=amb,
        shade=float(shade_g),
        ground=tuple(float(x) for x in np.asarray(Cc.NOMINAL_GROUND_COLOR)),
        horizon=tuple(float(x)
                      for x in np.asarray(Cc.NOMINAL_HORIZON_COLOR)),
        cull2=float(cfg.obj_cull_dist) ** 2,
        dt=float(cfg.delta_time),
        tl_period=float(Cc.TRAFFICLIGHT_PERIOD),
        objs=objs,
        cluster=2 if clustered else 0,
    )


def _tri_prims(mesh, cull_d):
    """Triangle prims of a registered mesh (tris, colours): the first
    KERNEL_TRI_BUDGET of its area-sorted buffer, degenerate ones skipped,
    each with v0, edges e1/e2, unit normal n and colour; LOD-exempt (cull
    distance obj_cull_dist)."""
    tris, cols = mesh
    prims = []
    for ti in range(min(KERNEL_TRI_BUDGET, len(tris))):
        v0, v1, v2 = (np.asarray(v, np.float64) for v in tris[ti])
        e1v, e2v = v1 - v0, v2 - v0
        nrm = np.cross(e1v, e2v)
        nn = float(np.linalg.norm(nrm))
        if nn < 1e-12:
            continue
        nrm = nrm / nn
        prims.append(dict(
            is_box=False, is_tri=True,
            v0=tuple(float(x) for x in v0),
            e1=tuple(float(x) for x in e1v),
            e2=tuple(float(x) for x in e2v),
            n=tuple(float(x) for x in nrm),
            color=tuple(float(x) for x in cols[ti]),
            lamp=False,
            center=tuple(float(x) for x in (v0 + v1 + v2) / 3),
            param=(0.0, 0.0, 0.0),
            culld=cull_d,
        ))
    return prims


def _stack_plan(cfg, maps):
    """The members' plans merged: objects concatenated map-major, each with
    its ``map``, NPC indices and optional bits made global; the tile words
    concatenated in ``npw``-word segments (``multi``); the cluster size
    the reference's kernel predicates the stack's object pass with."""
    n_maps = maps.n_maps
    if n_maps > 8:
        return None
    per = [build_render_plan(cfg, maps.map_at(m)) for m in range(n_maps)]
    if any(p is None for p in per):
        return None
    if any(p["ts_inv"] != per[0]["ts_inv"] for p in per):
        return None
    if sum(p["n_npc"] for p in per) > 8:
        return None
    npw = -(-(per[0]["Hg"] * per[0]["Wg"]) // 4)
    words, objs = [], []
    present = frozenset()
    npc_off = opt_off = 0
    for m, p in enumerate(per):
        words.extend(p["words"])
        present = present | p["present"]
        for ob in p["objs"]:
            ob = dict(ob, map=m)
            if ob["npc_idx"] is not None:
                ob["npc_idx"] += npc_off
            if ob.get("opt_bit") is not None:
                ob["opt_bit"] += opt_off
            objs.append(ob)
        npc_off += p["n_npc"]
        opt_off += p["n_opt"]
    if sum(p["n_real"] for p in per) > 48:
        return None
    plan = dict(per[0])   # n_opt stays the first member's, as in dtown
    plan.update(
        words=words, n_words=n_maps * npw, present=present, objs=objs,
        n_npc=npc_off, n_real=sum(p["n_real"] for p in per),
        multi=dict(n_maps=n_maps, npw=npw),
        cluster=(min(p["cluster"] for p in per if p["cluster"])
                 if any(p["cluster"] for p in per)
                 else max(1, max(len(p["objs"]) for p in per))),
    )
    return plan


def _lod_band(cd, cull_d):
    """LOD band of a cull distance: -1 = full range, else the halving
    octave below obj_cull_dist (capped at 2)."""
    if cd >= cull_d * 0.999:
        return -1
    return min(2, int(math.floor(math.log2(cull_d / cd))))


def _lod_split(objs, cull_d):
    """Split each static object's prims into per-LOD-band pseudo-objects
    (shared pose) and annotate culld = max member prim cull distance.
    Moving NPCs stay whole."""
    out = []
    for ob in objs:
        prims = ob["prims"]
        if not prims:
            continue
        if ob["npc_idx"] is not None:
            o2 = dict(ob)
            o2["culld"] = max(p.get("culld", cull_d) for p in prims)
            o2["lod_band"] = _lod_band(o2["culld"], cull_d)
            out.append(o2)
            continue
        bands = {}
        for p in prims:
            bands.setdefault(
                _lod_band(p.get("culld", cull_d), cull_d), []).append(p)
        for b in sorted(bands):
            o2 = dict(ob)
            o2["prims"] = bands[b]
            o2["lod_band"] = b
            o2["culld"] = max(p.get("culld", cull_d) for p in bands[b])
            out.append(o2)
    return out


def _bound_radius(ob):
    """World-space bounding radius of an object's prims around its
    position (model extents times the object scale)."""
    r = 0.0
    for pr in ob["prims"]:
        if pr.get("is_tri"):
            v0 = pr["v0"]
            for e in ((0.0,) * 3, pr["e1"], pr["e2"]):
                v = tuple(v0[i] + e[i] for i in range(3))
                r = max(r, math.sqrt(sum(x * x for x in v)))
            continue
        c, p = pr["center"], pr["param"]
        pr_r = (math.sqrt(p[0] * p[0] + p[1] * p[1] + p[2] * p[2])
                if pr["is_box"] else p[0])
        r = max(r, math.sqrt(c[0] ** 2 + c[1] ** 2 + c[2] ** 2) + pr_r)
    return r * ob["scale"]


def _npc_view_radius(plan):
    """{object index: r_vis} of the moving NPCs that the reference kernel
    wraps in a singleton cluster with a view half-plane cull: every NPC of
    a clustered (> 24 object) plan, and on smaller maps an NPC whose own
    cull distance puts it among the LOD clusters and stays under half the
    map's diagonal. The cull skips an NPC whose bounding circle lies
    wholly behind the camera's flat forward half-plane."""
    objs = plan["objs"]
    cull_w = math.sqrt(plan["cull2"])
    is_lod = lambda o: o.get("culld", cull_w) < cull_w * 0.999
    diag = math.hypot(plan["Hg"], plan["Wg"]) / plan["ts_inv"]
    any_lod = any(is_lod(o) for o in objs)
    out = {}
    for i, ob in enumerate(objs):
        if ob["npc_idx"] is None:
            continue
        if plan["cluster"] or (any_lod and is_lod(ob)
                               and ob.get("culld", cull_w) < 0.5 * diag):
            out[i] = _bound_radius(ob)
    return out


def _static_ray_planes(H, W, plan, fisheye=False, grayscale=False):
    """[5, S, 128] float32 static per-pixel ray planes [A, B, D, E, F]
    (no domain randomization): the first five planes of the reference's.
    Per env the ray is a yaw rotation of two planes: dx = c*A + s*B,
    dz = c*B - s*A, dy = D; E = -1/D on ground lanes (0 on sky lanes),
    F = the clamped 1/D of the box y-slab. Fisheye builds them from the
    inverted lens model's NDC table instead of the linear ramps. With
    grayscale a sixth plane carries the reference's baked sky luma; the
    RGB float path computes the sky from D instead of the reference's
    packed plane."""
    S = H * W // LANE_N
    if fisheye:
        xb, yb = undistorted_ndc(W, H)
        xn_b = np.asarray(xb, np.float64).reshape(S, LANE_N)
        yn_b = np.asarray(yb, np.float64).reshape(S, LANE_N)
    else:
        p = np.arange(S * LANE_N, dtype=np.int64).reshape(S, LANE_N)
        y = p // W
        x = p - y * W
        xn_b = ((x + 0.5) * (1.0 / W) - 0.5) * 2.0
        yn_b = (0.5 - (y + 0.5) * (1.0 / H)) * 2.0
    aspect = W / H
    xn = xn_b * (plan["tan_half"] * aspect)
    yn = yn_b * plan["tan_half"]
    sp, cp = plan["sin_pitch"], plan["cos_pitch"]
    ws = 1.0 / np.sqrt(1.0 + xn * xn + yn * yn)
    A = ((cp + yn * sp) * ws).astype(np.float32)
    B = (xn * ws).astype(np.float32)
    D = ((-sp + yn * cp) * ws).astype(np.float32)
    ground = D < -1e-6
    E = np.where(ground, -1.0 / np.where(ground, D.astype(np.float64),
                                         1.0), 0.0).astype(np.float32)
    Dc = np.where(np.abs(D) < 1e-9, np.where(D >= 0, 1e-9, -1e-9),
                  D.astype(np.float64))
    F = (1.0 / Dc).astype(np.float32)
    if not grayscale:
        return np.stack([A, B, D, E, F])
    skyf = 1.0 - 0.35 * np.maximum(0.0, D.astype(np.float64))
    sky = (_lum(plan["horizon"]) * skyf).astype(np.float32)
    return np.stack([A, B, D, E, F, sky])


def _ndc_table(H, W, fisheye):
    """[2, H*W] float32 per-pixel NDC factors (xb, yb) that the domain-
    randomized rays scale by the env's tan(fov/2): the inverted lens
    model's table under fisheye, else the linear ramps
    xb = ((x + .5) * (1/W) - .5) * 2, yb = (.5 - (y + .5) * (1/H)) * 2 in
    float32, each operation rounded as the reference's kernel rounds it."""
    if fisheye:
        xb, yb = undistorted_ndc(W, H)
        return np.stack([xb.reshape(-1), yb.reshape(-1)])
    f = np.float32
    p = np.arange(H * W, dtype=np.int64)
    y = p // W
    x = (p - y * W).astype(f)
    y = y.astype(f)
    xb = ((x + f(0.5)) * f(1.0 / W) - f(0.5)) * f(2.0)
    yb = (f(0.5) - (y + f(0.5)) * f(1.0 / H)) * f(2.0)
    return np.stack([xb, yb]).astype(f)


def _lum(c3):
    """Luma of an RGB triple of Python floats (a double fold)."""
    return 0.299 * c3[0] + 0.587 * c3[1] + 0.114 * c3[2]


# ---- flat kernel tables ---------------------------------------------------
# scene floats (csrc/blob_render.cu S_* indices)
_SCENE_NAMES = (
    "cam_fwd", "cam_height", "ts_inv", "k_fw", "shade", "gr", "gg", "gb",
    "hr", "hg", "hb", "ambient", "k_diff", "lwx", "lwy", "lwz", "dt",
    "inv_tl",
    # per-env rays under domain randomization
    "aspect", "deg", "half_h",
    # luma ground: base lumas by kind, marking terms, noise amplitudes by
    # kind, off-map ground (static shade folded in; scale 1 under DR)
    "l_empty", "l_road", "l_grass", "l_floor", "l_y", "l_w",
    "a_other", "a_grass", "a_road", "l_out",
    # traffic-light lamp lumas, green and red
    "l_green", "l_red",
    # 1.0: the kernel skips objects wholly behind the camera's forward
    # half-plane (pack_plan's view_cull), else 0.0
    "view_cull",
)
# per-object floats (O_*) and ints (OI_*). O_RV: the view radius of the
# NPCs the reference culls by the camera's half-plane (OI_PRED); O_RB: the
# bounding radius and VIEW_PAD, of the kernel's view cull and its per-pixel
# bounding-sphere test
OBJ_F = 13
(O_X, O_Y, O_Z, O_SR, O_CR, O_INVS, O_SC, O_LMX, O_LMY, O_LMZ,
 O_CULL2, O_RV, O_RB) = range(13)
OBJ_I = 8
# OI_MODEL: the object has a box or a triangle (its rays go to model space)
OI_P0, OI_NP, OI_MODEL, OI_NPC, OI_OPT, OI_WIG, OI_PRED, OI_MAP = range(8)
# per-prim floats (P_*) and ints (PI_*). A triangle keeps v0 in P_C*, the
# edge e1 in P_P*, the edge e2, its unit normal and the nominal light's
# n . l_model in P_E2*, P_N* and P_NDL
PRIM_F = 20
(P_CX, P_CY, P_CZ, P_P0, P_P1, P_P2, P_CD2, P_CWX, P_CWY, P_CWZ, P_RW2,
 P_NDV, P_LUMA, P_E2X, P_E2Y, P_E2Z, P_NX, P_NY, P_NZ, P_NDL) = range(20)
PRIM_I = 4
PI_TYPE, PI_LAMP, PI_COLOR, PI_OWN = range(4)
SPHERE_T, BOX_T, TRI_T = 0, 1, 2   # PI_TYPE values

B0 = 0.94  # texture variant 0's brightness
AMP_GRASS, AMP_OTHER = 0.03, 0.015


def _q8(c):
    return max(0, min(255, int(round(c * 255.0))))


def _packed(c3):
    return (_q8(c3[0]) << 16) | (_q8(c3[1]) << 8) | _q8(c3[2])


LAMP_GREEN_RGB = (0.1, 0.85, 0.15)
LAMP_RED_RGB = (0.9, 0.1, 0.1)
LAMP_GREEN = _packed(LAMP_GREEN_RGB)
LAMP_RED = _packed(LAMP_RED_RGB)


def _lum32(c3):
    """Luma of an RGB triple in float32 arithmetic (the reference computes
    the lamp lumas from per-env selects)."""
    f = np.float32
    return float(f(f(f(0.299) * f(c3[0])) + f(f(0.587) * f(c3[1])))
                 + f(f(0.114) * f(c3[2])))


def _luma_consts(plan, aa, dr):
    """The luma ground's constants: base lumas by kind, marking terms
    (deltas from asphalt under AA, else the marking lumas), noise
    amplitudes by kind and the off-map ground luma. The static path folds
    brightness and shade into them; under DR they are unscaled."""
    shade = plan["shade"]
    scale = 1.0 if dr else B0 * shade
    nsc = 1.0 if dr else shade
    lum_a = _lum(ASPHALT)
    return dict(
        l_empty=_lum(EMPTY) * scale, l_road=lum_a * scale,
        l_grass=_lum(GRASS) * scale, l_floor=_lum(FLOOR) * scale,
        l_y=((_lum(YELLOW) - lum_a) * scale if aa
             else _lum(YELLOW) * scale),
        l_w=((_lum(WHITE) - lum_a) * scale if aa
             else _lum(WHITE) * scale),
        a_other=AMP_OTHER * nsc, a_grass=AMP_GRASS * nsc,
        a_road=NOISE_AMP * nsc,
        l_out=_lum(plan["ground"]) * shade,
        l_green=_lum32(LAMP_GREEN_RGB), l_red=_lum32(LAMP_RED_RGB),
    )


def rays_face_forward(cfg, plan, dr_ranges=None):
    """Whether every ray of cfg's frame has a horizontal forward component
    of at least VIEW_MIN_FWD (unit rays), which makes the kernel's view cull
    exact. Without domain randomization: the static planes' A (the forward
    component after the yaw rotation). Under it: the NDC table's yb at every
    draw of the fov and pitch ranges (``dr_ranges``: ((fov lo, hi), (pitch
    lo, hi)) in degrees, the state kernel's redraw ranges by default), where
    the forward component is cos p + yb tan(fov / 2) sin p over the ray's
    length, at most sqrt(1 + xn^2 + yn^2)."""
    H, W, fisheye = cfg.camera_height, cfg.camera_width, cfg.distortion
    if not plan["domain_rand"]:
        A = _static_ray_planes(H, W, plan, fisheye)[0]
        return bool(A.min() >= VIEW_MIN_FWD)
    if dr_ranges is None:
        rng = sk._dr_ranges(cfg)
        dr_ranges = (rng[2], rng[4])
    (f_lo, f_hi), (p_lo, p_hi) = dr_ranges
    xb, yb = (np.asarray(v, np.float64) for v in _ndc_table(H, W, fisheye))
    worst = math.inf
    for f in np.linspace(f_lo, f_hi, 9):
        th = math.tan(0.5 * math.radians(f))
        norm = math.sqrt(1.0 + (np.abs(xb).max() * th * (W / H)) ** 2
                         + (np.abs(yb).max() * th) ** 2)
        for pd in np.linspace(p_lo, p_hi, 9):
            sp, cp = math.sin(math.radians(pd)), math.cos(math.radians(pd))
            fwd = cp + np.array([yb.min(), yb.max()]) * th * sp
            worst = min(worst, float(fwd.min()) / norm)
    return worst >= VIEW_MIN_FWD


def pack_plan(cfg, plan, device):
    """Flatten a render plan into the kernel's device tables.

    Every value is the reference's Python-double constant fold, rounded
    once to float32. Returns a dict of tensors and ints; ``view`` says
    whether the kernel's view cull is on (``rays_face_forward``)."""
    H, W = cfg.camera_height, cfg.camera_width
    if (H * W) % LANE_N:
        raise ValueError(f"H*W must be a multiple of {LANE_N}: {H}x{W}")
    gray = bool(cfg.grayscale)
    dr = bool(plan["domain_rand"])
    present = plan["present"]
    marking = any(k in present
                  for k in range(T.TILE_STRAIGHT, T.TILE_4WAY + 1))
    aa = bool(plan["aa"]) and marking
    amb = plan["ambient"]
    tany = plan["tan_half"]
    view = rays_face_forward(cfg, plan)
    scene = dict(
        cam_fwd=plan["cam_fwd"], cam_height=plan["cam_height"],
        ts_inv=plan["ts_inv"],
        k_fw=(H * 0.5) / tany / plan["ts_inv"],
        shade=plan["shade"],
        gr=plan["ground"][0], gg=plan["ground"][1], gb=plan["ground"][2],
        hr=plan["horizon"][0], hg=plan["horizon"][1],
        hb=plan["horizon"][2],
        ambient=amb, k_diff=1.0 - amb,
        lwx=plan["light"][0], lwy=plan["light"][1], lwz=plan["light"][2],
        dt=plan["dt"], inv_tl=1.0 / plan["tl_period"],
        aspect=W / H, deg=math.pi / 180.0, half_h=H * 0.5,
        **_luma_consts(plan, aa, dr),
        view_cull=1.0 if view else 0.0,
    )
    cull_w = math.sqrt(plan["cull2"])
    objs = plan["objs"]
    view_r = _npc_view_radius(plan)
    n_prims = sum(len(ob["prims"]) for ob in objs)
    of = np.zeros((max(len(objs), 1), OBJ_F), np.float32)
    oi = np.zeros((max(len(objs), 1), OBJ_I), np.int32)
    pf = np.zeros((max(n_prims, 1), PRIM_F), np.float32)
    pi = np.zeros((max(n_prims, 1), PRIM_I), np.int32)
    j = 0
    for i, ob in enumerate(objs):
        cap = KERNEL_TRI_BUDGET if any(p.get("is_tri") for p in ob["prims"]) \
            else MAX_OBJ_PRIMS
        if len(ob["prims"]) > cap:
            raise ValueError(f"object {i} has {len(ob['prims'])} primitives;"
                             f" the blob render kernel holds {cap}")
        ox, oy, oz = ob["pos"]
        s_r, c_r, sc = ob["s_r"], ob["c_r"], ob["scale"]
        culld_o = float(ob.get("culld", cull_w))
        of[i, [O_X, O_Y, O_Z, O_SR, O_CR, O_INVS, O_SC]] = (
            ox, oy, oz, s_r, c_r, ob["inv_s"], sc)
        of[i, [O_LMX, O_LMY, O_LMZ]] = ob["l_model"]
        of[i, O_CULL2] = culld_o * culld_o
        of[i, O_RV] = view_r.get(i, 0.0)
        of[i, O_RB] = _bound_radius(ob) + VIEW_PAD
        oi[i, OI_P0] = j
        oi[i, OI_NP] = len(ob["prims"])
        oi[i, OI_MODEL] = int(any(p["is_box"] or p.get("is_tri")
                                  for p in ob["prims"]))
        oi[i, OI_NPC] = -1 if ob["npc_idx"] is None else ob["npc_idx"]
        oi[i, OI_OPT] = (ob["opt_bit"] if dr and ob["opt_bit"] is not None
                         else -1)
        oi[i, OI_WIG] = int(ob["wiggle"])
        oi[i, OI_PRED] = int(i in view_r)
        oi[i, OI_MAP] = -1 if ob["map"] is None else ob["map"]
        for pr in ob["prims"]:
            cx, cy, cz = pr["center"]
            p0, p1, p2 = pr["param"]
            cd = pr.get("culld", culld_o)
            pf[j, [P_CX, P_CY, P_CZ, P_P0, P_P1, P_P2]] = (
                cx, cy, cz, p0, p1, p2)
            pf[j, P_CD2] = cd * cd
            tri = bool(pr.get("is_tri"))
            if tri:
                n = pr["n"]
                lm = ob["l_model"]
                pf[j, [P_CX, P_CY, P_CZ]] = pr["v0"]
                pf[j, [P_P0, P_P1, P_P2]] = pr["e1"]
                pf[j, [P_E2X, P_E2Y, P_E2Z]] = pr["e2"]
                pf[j, [P_NX, P_NY, P_NZ]] = n
                pf[j, P_NDL] = n[0] * lm[0] + n[1] * lm[1] + n[2] * lm[2]
            elif not pr["is_box"]:
                rw = p0 * sc
                pf[j, [P_CWX, P_CWY, P_CWZ]] = (
                    ox + sc * (cx * c_r - cz * s_r), oy + sc * cy,
                    oz + sc * (cx * s_r + cz * c_r))
                pf[j, P_RW2] = rw * rw
                pf[j, P_NDV] = -1.0 / max(rw, 1e-9)
            pf[j, P_LUMA] = _lum(pr["color"])
            pi[j, PI_TYPE] = (TRI_T if tri else BOX_T if pr["is_box"]
                              else SPHERE_T)
            pi[j, PI_LAMP] = int(pr["lamp"])
            pi[j, PI_COLOR] = _packed(pr["color"])
            pi[j, PI_OWN] = int(cd < culld_o * 0.999)
            j += 1
    # the output clamp is a no-op when every contribution is provably in
    # [0, 1]; domain randomization keeps it, as the reference does
    no_clamp = (not dr) and all(
        0.0 <= c <= 1.0 for ob in objs for pr in ob["prims"]
        for c in pr["color"]) and all(
        0.0 <= c <= 1.0 for c in tuple(plan["ground"])
        + tuple(plan["horizon"]))
    dev = torch.device(device)
    n_npc = int(plan["n_npc"])
    # the ray input: the static planes, or under domain randomization the
    # NDC table that the per-env rays scale
    fisheye = bool(cfg.distortion)
    if dr:
        rays = _ndc_table(H, W, fisheye)
    else:
        rays = _static_ray_planes(H, W, plan, fisheye, grayscale=gray)
        rays = rays.reshape(rays.shape[0], -1)
    words = np.asarray(plan["words"], np.int32)
    multi = plan["multi"]
    return dict(
        H=H, W=W, C=1 if gray else 3, gray=gray, dr=dr, n_npc=n_npc,
        drb=sk.dr_base(n_npc), nf=sk.nf_for(n_npc, dr),
        rays=torch.as_tensor(np.ascontiguousarray(rays), device=dev),
        words=torch.as_tensor(words, device=dev),
        scene=torch.as_tensor(
            np.array([scene[k] for k in _SCENE_NAMES], np.float32),
            device=dev),
        of=torch.as_tensor(of, device=dev), oi=torch.as_tensor(oi, device=dev),
        pf=torch.as_tensor(pf, device=dev), pi=torch.as_tensor(pi, device=dev),
        n_objs=len(objs), Hg=plan["Hg"], Wg=plan["Wg"],
        aa=aa, any_x=any(k in present for k in INTERSECTION_KINDS),
        no_clamp=no_clamp, view=view,
        tri=any(p.get("is_tri") for ob in objs for p in ob["prims"]),
        n_maps=multi["n_maps"] if multi else 1,
        npw=multi["npw"] if multi else 0,
    )


def _fdiv(a, b):
    """a / b with b a tensor and a a Python float: a full tensor divided,
    not a reciprocal multiplied (torch's scalar / tensor takes 1/b)."""
    return torch.full_like(b, a) / b


def _luma_ground(masks, sc, aa):
    """Luma of the ground texel before noise: the base luma of the pixel's
    kind, then the marking terms (AA coverage deltas, else the marking
    lumas over the base)."""
    yellow, white, is_road, is_grass, is_floor = masks
    l_ = torch.where(is_road, sc["l_road"], torch.where(
        is_grass, sc["l_grass"], torch.where(is_floor, sc["l_floor"],
                                             sc["l_empty"])))
    if aa:
        return l_ + yellow * sc["l_y"] + white * sc["l_w"]
    l_ = torch.where(yellow, sc["l_y"], l_)
    return torch.where(white, sc["l_w"], l_)


def render_frames_reference(blob, pk):
    """Plain torch version of the blob render kernel. blob f32 [nf, B];
    pk = pack_plan(...). Returns uint8 [B, C, S, 128]."""
    B = blob.shape[1]
    H, W = pk["H"], pk["W"]
    P = H * W
    sc_ = [float(v) for v in pk["scene"].cpu()]
    scene = dict(zip(_SCENE_NAMES, sc_))
    dr, gray, aa = pk["dr"], pk["gray"], pk["aa"]
    where = torch.where
    i32 = torch.int32
    f32 = torch.float32
    dev = blob.device
    rays = pk["rays"]

    col = lambda f: blob[f][:, None]                # [B, 1]
    px_s, py_s, pz_s = col(sk.F_POS_X), col(sk.F_POS_Y), col(sk.F_POS_Z)
    ang_s, step_s = col(sk.F_ANGLE), col(sk.F_STEP)
    s_a, c_a = sincos(ang_s)
    if dr:
        # per-env randomization scalars from the DR rows
        d = lambda k: col(pk["drb"] + k)
        s_h, c_h = sincos(0.5 * d(sk.DR_FOV) * scene["deg"])
        tany_e = s_h / c_h
        tanx_e = tany_e * scene["aspect"]
        sp_e, cp_e = sincos(d(sk.DR_CAMA) * scene["deg"])
        camh_e, camf_e = d(sk.DR_CAMH), d(sk.DR_CAMF)
        lw = (d(sk.DR_LX), d(sk.DR_LY), d(sk.DR_LZ))
        amb_e = d(sk.DR_AMB)
        kd_e = 1.0 - amb_e
        shade_e = amb_e + kd_e * torch.clamp(-lw[1], min=0.0)
        ground = (d(sk.DR_GR), d(sk.DR_GG), d(sk.DR_GB))
        horizon = (d(sk.DR_HR), d(sk.DR_HG), d(sk.DR_HB))
        seed_e = d(sk.DR_TEXSEED).to(i32)
        visbits = d(sk.DR_OBJVIS).to(i32)
    else:
        camh_e, camf_e = scene["cam_height"], scene["cam_fwd"]
        lw = (scene["lwx"], scene["lwy"], scene["lwz"])
        amb_e, kd_e, shade_e = (scene["ambient"], scene["k_diff"],
                                scene["shade"])
        ground = (scene["gr"], scene["gg"], scene["gb"])
        horizon = (scene["hr"], scene["hg"], scene["hb"])
    eye0 = px_s + camf_e * c_a
    eye1 = py_s + camh_e
    eye2 = pz_s + camf_e * (-s_a)

    if dr:
        # per-pixel camera basis from the NDC table, normalization and
        # ground divide
        xn = rays[0][None, :] * tanx_e               # [B, P]
        yn = rays[1][None, :] * tany_e
        fwd_x, fwd_y, fwd_z = cp_e * c_a, -sp_e, -cp_e * s_a
        up_x, up_y, up_z = sp_e * c_a, cp_e, -sp_e * s_a
        dx = fwd_x + xn * s_a + yn * up_x
        dy = fwd_y + yn * up_y
        dz = fwd_z + xn * c_a + yn * up_z
        inv_n = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
        dx, dy, dz = dx * inv_n, dy * inv_n, dz * inv_n
        gmask = dy < -1e-6
        t_g = where(gmask, -eye1 / where(gmask, dy, -1.0), 1e30)
        skyf = 1.0 - 0.35 * torch.clamp(dy, min=0.0)
        inv_dy = 1.0 / where(torch.abs(dy) < 1e-9,
                             where(dy >= 0, 1e-9, -1e-9), dy)
        k_fw = None
        if aa:
            k_fw = _fdiv(scene["half_h"], tany_e)
            k_fw = k_fw / torch.full_like(k_fw, scene["ts_inv"]) / eye1
    else:
        A_p, B_p, D_p, E_p, F_p = (rays[i][None, :] for i in range(5))
        dx = c_a * A_p + s_a * B_p                      # [B, P]
        dy = D_p.expand_as(dx)
        dz = c_a * B_p - s_a * A_p
        gmask = D_p < -1e-6
        t_g = eye1 * E_p
        skyf = 1.0 - 0.35 * torch.clamp(D_p, min=0.0)
        inv_dy = F_p
        k_fw = _fdiv(scene["k_fw"], eye1) if aa else None
    inv_fw = dy * dy * k_fw if aa else None
    ts_inv = scene["ts_inv"]
    fx = (eye0 + t_g * dx) * ts_inv
    fz = (eye2 + t_g * dz) * ts_inv
    ti = torch.floor(fx)
    tj = torch.floor(fz)
    in_grid = ((ti >= 0) & (ti < pk["Wg"]) & (tj >= 0) & (tj < pk["Hg"])
               & gmask)
    tid = tj.to(i32) * pk["Wg"] + ti.to(i32)
    widx = tid >> 2
    if pk["n_maps"] > 1:
        # the env's member segment of the stacked tile words
        mid = col(sk.F_MAPID).to(i32)
        widx = mid * pk["npw"] + widx
    word = _select_word(pk["words"], widx)
    byte = (word >> ((tid & 3) << 3)) & 0xFF
    kind = byte & 0xF
    angle_idx = (byte >> 4) & 0x3
    variant = variant_hash(tid, seed_e) if dr else None

    if gray:
        yellow, white, is_road, is_grass, is_floor, bu, bv = _tile_masks(
            kind, angle_idx, fx - ti, fz - tj, pk["any_x"], inv_fw=inv_fw)
        l_ = _luma_ground((yellow, white, is_road, is_grass, is_floor),
                          scene, aa)
        nrm = _noise_h16f(bu, bv, kind, variant if dr else 0) \
            * (1.0 / 32768.0) - 1.0
        ampv = where(is_road, scene["a_road"], where(
            is_grass, scene["a_grass"], scene["a_other"]))
        if dr:
            # luma-direct DR ground: brightness per texel, shade per env
            bright = 0.94 + 0.04 * variant.to(f32)
            l_ = l_ * bright + nrm * ampv
            lum_e = lambda c: 0.299 * c[0] + 0.587 * c[1] + 0.114 * c[2]
            l_ = where(in_grid, l_, lum_e(ground)) * shade_e
            l_ = where(gmask, l_, lum_e(horizon) * skyf)
        else:
            l_ = l_ + nrm * ampv
            l_ = where(in_grid, l_, scene["l_out"])
            l_ = where(gmask, l_, rays[5][None, :])
    else:
        r_, g_, b_ = _shade_pixels(kind, angle_idx, fx - ti, fz - tj,
                                   pk["any_x"], inv_fw=inv_fw,
                                   variant=variant)
        r_ = where(in_grid, r_, ground[0]) * shade_e
        g_ = where(in_grid, g_, ground[1]) * shade_e
        b_ = where(in_grid, b_, ground[2]) * shade_e
        r_ = where(gmask, r_, horizon[0] * skyf)
        g_ = where(gmask, g_, horizon[1] * skyf)
        b_ = where(gmask, b_, horizon[2] * skyf)

    # ---- object pass ------------------------------------------------------
    t_best = where(gmask, t_g, 1e30)
    pk_ = torch.full_like(t_best, -1, dtype=i32)
    dv_ = torch.zeros_like(t_best)
    if pk["n_objs"]:
        t_env = step_s * scene["dt"]
        green = (torch.floor(t_env * scene["inv_tl"]).to(i32) % 2) > 0
        lamp_pk = where(green, LAMP_GREEN, LAMP_RED).to(i32)    # [B, 1]
        lamp_l = where(green, scene["l_green"], scene["l_red"])
        dlw = dx * lw[0] + dy * lw[1] + dz * lw[2]
        of, oi = pk["of"].cpu(), pk["oi"].cpu().tolist()
        pf, pi = pk["pf"].cpu(), pk["pi"].cpu().tolist()
        for o in range(pk["n_objs"]):
            ov = of[o].to(dev)                       # 0-d f32 scalars
            p0_, n_p, model, npc, opt, wig, pred, omap = oi[o]
            if npc >= 0:
                # moving NPC: pose from the blob's NPC rows
                nbase = sk.F_NPC_BASE + sk.NPC_ROWS * npc
                ox, oz = col(nbase), col(nbase + 1)
                a_npc = col(nbase + 2)
                if wig:
                    a_npc = a_npc + Cc.DUCKIE_WIGGLE * sincos(
                        Cc.DUCKIE_WIGGLE_FREQ * t_env)[0]
                s_r, c_r = sincos(-a_npc)
            else:
                ox, oz = ov[O_X], ov[O_Z]
                s_r, c_r = ov[O_SR], ov[O_CR]
            oy = ov[O_Y]
            if npc >= 0 or dr:
                # the per-env light in the object's model space
                lm = (lw[0] * c_r + lw[2] * s_r, lw[1],
                      lw[2] * c_r - lw[0] * s_r)
            else:
                lm = (ov[O_LMX], ov[O_LMY], ov[O_LMZ])
            dxo = ox - eye0
            dzo = oz - eye2
            dist2 = dxo * dxo + dzo * dzo            # [B, 1]
            # gates beyond the distance: the stack member, the
            # optional-object bit, the NPC's view half-plane
            obj_on = None
            if omap >= 0 and pk["n_maps"] > 1:
                obj_on = mid == omap
            if opt >= 0:
                bit = ((visbits >> opt) & 1) > 0
                obj_on = bit if obj_on is None else obj_on & bit
            if pred:
                hp = dxo * c_a - dzo * s_a > -ov[O_RV]
                obj_on = hp if obj_on is None else obj_on & hp
            act = dist2 < ov[O_CULL2]
            if obj_on is not None:
                act = act & obj_on
            if model:
                # a box or triangle object: the rays in model space
                ex = (eye0 - ox) * ov[O_INVS]
                ey = (eye1 - oy) * ov[O_INVS]
                ez = (eye2 - oz) * ov[O_INVS]
                emx = ex * c_r + ez * s_r
                emz = ez * c_r - ex * s_r
                dmx = dx * c_r + dz * s_r
                dmz = dz * c_r - dx * s_r

                def safe_inv(dm):
                    return 1.0 / where(torch.abs(dm) < 1e-9,
                                       where(dm >= 0, 1e-9, -1e-9), dm)

                inv_dmx = safe_inv(dmx)
                inv_dmz = safe_inv(dmz)
                wx = where(dmx >= 0.0, lm[0], -lm[0])
                wy = where(dy >= 0.0, lm[1], -lm[1])
                wz = where(dmz >= 0.0, lm[2], -lm[2])
            for j in range(p0_, p0_ + n_p):
                pv = pf[j].to(dev)
                ptype, lamp, color, own = pi[j]
                if own:
                    gate = dist2 < pv[P_CD2]
                    if obj_on is not None:
                        gate = gate & obj_on
                else:
                    gate = act
                if ptype == TRI_T:
                    # Moeller-Trumbore in model space: the per-env tvec and
                    # qvec against the baked v0, e1, e2
                    v0x, v0y, v0z = pv[P_CX], pv[P_CY], pv[P_CZ]
                    e1x, e1y, e1z = pv[P_P0], pv[P_P1], pv[P_P2]
                    e2x, e2y, e2z = pv[P_E2X], pv[P_E2Y], pv[P_E2Z]
                    pvx = dy * e2z - dmz * e2y
                    pvy = dmz * e2x - dmx * e2z
                    pvz = dmx * e2y - dy * e2x
                    det = e1x * pvx + e1y * pvy + e1z * pvz
                    ok_det = torch.abs(det) > 1e-12
                    inv_det = (where(ok_det, 1.0, 0.0)
                               / where(ok_det, det, 1.0))
                    tvx = emx - v0x
                    tvy = ey - v0y
                    tvz = emz - v0z
                    u_b = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
                    qvx = tvy * e1z - tvz * e1y
                    qvy = tvz * e1x - tvx * e1z
                    qvz = tvx * e1y - tvy * e1x
                    v_b = (dmx * qvx + dy * qvy + dmz * qvz) * inv_det
                    t_m = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
                    ok_p = ((u_b >= 0.0) & (v_b >= 0.0)
                            & (u_b + v_b <= 1.0) & (t_m > 1e-4))
                    t_w = t_m * ov[O_SC]
                    # flat two-sided shading
                    nx_, ny_, nz_ = pv[P_NX], pv[P_NY], pv[P_NZ]
                    ndl = (nx_ * lm[0] + ny_ * lm[1] + nz_ * lm[2] if dr
                           else pv[P_NDL])
                    nd = nx_ * dmx + ny_ * dy + nz_ * dmz
                    dv = where(nd > 0.0, ndl, -ndl)
                elif ptype == BOX_T:
                    ocx = emx - pv[P_CX]
                    ocy = ey - pv[P_CY]
                    ocz = emz - pv[P_CZ]
                    t1 = (-pv[P_P0] - ocx) * inv_dmx
                    t2 = (pv[P_P0] - ocx) * inv_dmx
                    n1, x1 = torch.minimum(t1, t2), torch.maximum(t1, t2)
                    t1 = (-pv[P_P1] - ocy) * inv_dy
                    t2 = (pv[P_P1] - ocy) * inv_dy
                    n2, x2 = torch.minimum(t1, t2), torch.maximum(t1, t2)
                    t1 = (-pv[P_P2] - ocz) * inv_dmz
                    t2 = (pv[P_P2] - ocz) * inv_dmz
                    n3, x3 = torch.minimum(t1, t2), torch.maximum(t1, t2)
                    tmin = torch.maximum(torch.maximum(n1, n2), n3)
                    tmax = torch.minimum(torch.minimum(x1, x2), x3)
                    t_m = where(tmin > 1e-4, tmin, tmax)
                    ok_p = (tmax >= tmin) & (tmax > 1e-4)
                    t_w = t_m * ov[O_SC]
                    xb = (n1 >= n2) & (n1 >= n3)
                    yb = (n2 >= n3) & ~xb
                    dv = where(xb, wx, where(yb, wy, wz))
                else:
                    if npc >= 0:
                        # world centre of an NPC's sphere, in float32
                        cwx = ox + ov[O_SC] * (pv[P_CX] * c_r
                                               - pv[P_CZ] * s_r)
                        cwz = oz + ov[O_SC] * (pv[P_CX] * s_r
                                               + pv[P_CZ] * c_r)
                    else:
                        cwx, cwz = pv[P_CWX], pv[P_CWZ]
                    ocx = eye0 - cwx
                    ocy = eye1 - pv[P_CWY]
                    ocz = eye2 - cwz
                    bq = ocx * dx + ocy * dy + ocz * dz
                    cq = ocx * ocx + ocy * ocy + ocz * ocz - pv[P_RW2]
                    disc = bq * bq - cq
                    t_m = -bq - torch.sqrt(disc)
                    ok_p = t_m > 1e-4
                    t_w = t_m
                    k1 = ocx * lw[0] + ocy * lw[1] + ocz * lw[2]
                    dv = (k1 + t_m * dlw) * pv[P_NDV]
                closer = gate & ok_p & (t_w < t_best)
                if gray:
                    sh = amb_e + kd_e * torch.clamp(dv, min=0.0)
                    lum = lamp_l if lamp else pv[P_LUMA]
                    l_ = where(closer, lum * sh, l_)
                else:
                    pkc = lamp_pk if lamp else torch.tensor(
                        color, dtype=i32, device=dev)
                    pk_ = where(closer, pkc, pk_)
                    dv_ = where(closer, dv, dv_)
                t_best = where(closer, t_w, t_best)
        if not gray:
            obj_m = pk_ >= 0
            shn = (amb_e + kd_e * torch.clamp(dv_, min=0.0)) * (1.0 / 255.0)
            r_ = where(obj_m, ((pk_ >> 16) & 255).to(f32) * shn, r_)
            g_ = where(obj_m, ((pk_ >> 8) & 255).to(f32) * shn, g_)
            b_ = where(obj_m, (pk_ & 255).to(f32) * shn, b_)

    def to_u8(xv):
        if not pk["no_clamp"]:
            xv = torch.clamp(xv, 0.0, 1.0)
        return (xv * 255.0 + 0.5).to(i32).to(torch.uint8)

    planes = [l_] if gray else [r_, g_, b_]
    out = torch.stack([to_u8(v.expand(B, P)) for v in planes], dim=1)
    return out.reshape(B, len(planes), P // LANE_N, LANE_N)


def kept(blob, pk):
    """Plain torch mirror of the blob render kernel's keep predicate (the
    per-block prologue of csrc/blob_render.cu), in its float32 operations;
    used by tests and chip_smoke.py's bounds. Returns (objects bool [B,
    n_objs], primitives bool [B, n_prims]): what each env's pixel pass
    walks. An object is kept when it lies on the env's member map, within
    its cull distance, visible under the env's optional-object bits, not
    wholly behind the camera's forward half-plane (the NPCs the reference
    culls so, and every object when pk["view"]) and left with a primitive
    by the LOD culls; a primitive when its object passes those culls and
    its own LOD cull."""
    b = blob.detach().cpu()
    B = b.shape[1]
    scene = dict(zip(_SCENE_NAMES, [float(v) for v in pk["scene"].cpu()]))
    s_a, c_a = sincos(b[sk.F_ANGLE])
    camf = b[pk["drb"] + sk.DR_CAMF] if pk["dr"] else scene["cam_fwd"]
    eye0 = b[sk.F_POS_X] + camf * c_a
    eye2 = b[sk.F_POS_Z] + camf * (-s_a)
    vis = b[pk["drb"] + sk.DR_OBJVIS].to(torch.int32) if pk["dr"] else None
    mid = b[sk.F_MAPID].to(torch.int32)
    of, oi = pk["of"].cpu(), pk["oi"].cpu().tolist()
    pf, pi = pk["pf"].cpu(), pk["pi"].cpu().tolist()
    n_o = pk["n_objs"]
    keep_o = torch.zeros((B, n_o), dtype=torch.bool)
    keep_p = torch.zeros((B, len(pi)), dtype=torch.bool)
    for o in range(n_o):
        p0, n_p, _, npc, opt, _, pred, omap = oi[o]
        if npc >= 0:
            base = sk.F_NPC_BASE + sk.NPC_ROWS * npc
            ox, oz = b[base], b[base + 1]
        else:
            ox, oz = of[o, O_X], of[o, O_Z]
        dxo = ox - eye0
        dzo = oz - eye2
        dist2 = dxo * dxo + dzo * dzo
        k = dist2 < of[o, O_CULL2]
        if pk["n_maps"] > 1:
            k = k & (mid == omap)
        if opt >= 0:
            k = k & (((vis >> opt) & 1) > 0)
        fwd = dxo * c_a - dzo * s_a
        if pred:
            k = k & (fwd > -of[o, O_RV])
        if pk["view"]:
            k = k & (fwd > -of[o, O_RB])
        for j in range(p0, p0 + n_p):
            keep_p[:, j] = k & (dist2 < pf[j, P_CD2]) if pi[j][PI_OWN] else k
        if n_p:
            keep_o[:, o] = keep_p[:, p0:p0 + n_p].any(1)
    return keep_o, keep_p


def sphere_pass(blob, pk):
    """Plain torch mirror of the kernel's per-pixel bounding-sphere test,
    in its float32 operations, on the blob's device: bool [B, n_objs, P],
    True where the object is kept (``kept``) and the pixel's ray meets the
    object's bounding sphere (radius O_RB around its position) or starts
    inside it. The kernel skips the object's primitives on every other
    pixel: none of them can be hit there."""
    dev = blob.device
    b = blob.detach()
    B = b.shape[1]
    scene = dict(zip(_SCENE_NAMES, [float(v) for v in pk["scene"].cpu()]))
    col = lambda f: b[f][:, None]                        # [B, 1]
    s_a, c_a = sincos(col(sk.F_ANGLE))
    rays = pk["rays"].to(dev)
    if pk["dr"]:
        d = lambda k: col(pk["drb"] + k)
        s_h, c_h = sincos(0.5 * d(sk.DR_FOV) * scene["deg"])
        tany = s_h / c_h
        tanx = tany * scene["aspect"]
        sp, cp = sincos(d(sk.DR_CAMA) * scene["deg"])
        camh, camf = d(sk.DR_CAMH), d(sk.DR_CAMF)
        xn = rays[0][None, :] * tanx
        yn = rays[1][None, :] * tany
        dx = cp * c_a + xn * s_a + yn * (sp * c_a)
        dy = -sp + yn * cp
        dz = -cp * s_a + xn * c_a + yn * (-sp * s_a)
        inv_n = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
        dx, dy, dz = dx * inv_n, dy * inv_n, dz * inv_n
    else:
        camh, camf = scene["cam_height"], scene["cam_fwd"]
        A, Bp, D = (rays[i][None, :] for i in range(3))
        dx = c_a * A + s_a * Bp
        dy = D.expand_as(dx)
        dz = c_a * Bp - s_a * A
    eye0 = col(sk.F_POS_X) + camf * c_a
    eye1 = col(sk.F_POS_Y) + camh
    eye2 = col(sk.F_POS_Z) + camf * (-s_a)
    keep_o, _ = kept(blob, pk)
    of, oi = pk["of"].to(dev), pk["oi"].cpu().tolist()
    out = torch.zeros((B, pk["n_objs"], dx.shape[1]), dtype=torch.bool,
                      device=dev)
    for o in range(pk["n_objs"]):
        npc = oi[o][OI_NPC]
        if npc >= 0:
            base = sk.F_NPC_BASE + sk.NPC_ROWS * npc
            ox, oz = col(base), col(base + 1)
        else:
            ox, oz = of[o, O_X], of[o, O_Z]
        bx, by, bz = ox - eye0, of[o, O_Y] - eye1, oz - eye2
        c2 = bx * bx + by * by + bz * bz - of[o, O_RB] * of[o, O_RB]
        bq = bx * dx + by * dy + bz * dz
        miss = (c2 > 0.0) & ((bq < 0.0) | (bq * bq < c2))
        out[:, o] = ~miss & keep_o[:, o].to(dev)[:, None]
    return out


def compact(blob, pk):
    """The compacted lists the kernel's prologue builds from ``kept``: per
    env (objects, primitives, ends), each kept object at its rank (the
    count of kept objects before it) and its kept primitives at the sum of
    the kept primitive counts of the kept objects before it; ends[i] is
    the end of object i's primitives."""
    keep_o, keep_p = kept(blob, pk)
    oi = pk["oi"].cpu()
    p0, n_p = oi[:pk["n_objs"], OI_P0].tolist(), oi[:pk["n_objs"],
                                                      OI_NP].tolist()
    count = torch.stack([keep_p[:, a:a + n].sum(1) for a, n in zip(p0, n_p)],
                        1) if pk["n_objs"] else keep_o.long()
    count = torch.where(keep_o, count, 0)
    rank = torch.cumsum(keep_o.long(), 1) - keep_o.long()
    off = torch.cumsum(count, 1) - count
    lists = []
    for e in range(keep_o.shape[0]):
        n_k = int(keep_o[e].sum())
        objs, ends = [-1] * n_k, [0] * n_k
        prims = [-1] * int(count[e].sum())
        for o in torch.nonzero(keep_o[e]).flatten().tolist():
            objs[rank[e, o]] = o
            k = int(off[e, o])
            ends[rank[e, o]] = k + int(count[e, o])
            for j in range(p0[o], p0[o] + n_p[o]):
                if keep_p[e, j]:
                    prims[k] = j
                    k += 1
        lists.append((objs, prims, ends))
    return lists


_blob_render = _build.kernel("blob_render", "dtown_blob_render",
                            "P" * 9 + "i" * 19, "blob_render")


def render_frames_from_blob(blob, pk):
    """Batched render from the state blob [nf, B] with the packed plan
    ``pk`` (pack_plan, on the blob's device). Returns uint8 planes
    [B, C, S, 128] (C = 1 luma plane under grayscale, else 3),
    byte-identical to [B, C, H, W].

    A CUDA blob goes through the hand-written kernel (csrc/blob_render.cu)
    and a CPU blob through ``render_frames_reference``."""
    nf = pk["nf"]
    if blob.dtype != torch.float32 or blob.dim() != 2 \
            or blob.shape[0] < nf:
        raise ValueError(f"blob must be float32 [>={nf}, B], got "
                         f"{tuple(blob.shape)} {blob.dtype}")
    if pk["rays"].device != blob.device:
        raise ValueError("blob and render tables must share one device")
    if blob.device.type == "cpu":
        return render_frames_reference(blob, pk)
    if blob.device.type != "cuda":
        raise ValueError(f"unsupported device {blob.device}")
    blob = blob.contiguous()
    B = blob.shape[1]
    H, W = pk["H"], pk["W"]
    out = torch.empty((B, pk["C"], H * W // LANE_N, LANE_N),
                      dtype=torch.uint8, device=blob.device)
    _blob_render(blob.data_ptr(), pk["rays"].data_ptr(),
                 pk["words"].data_ptr(), pk["scene"].data_ptr(),
                 pk["of"].data_ptr(), pk["oi"].data_ptr(),
                 pk["pf"].data_ptr(), pk["pi"].data_ptr(), out.data_ptr(),
                 B, H, W, pk["words"].shape[0], pk["Hg"], pk["Wg"],
                 pk["n_objs"], int(pk["aa"]), int(pk["any_x"]),
                 int(pk["no_clamp"]), LAMP_GREEN, LAMP_RED, int(pk["dr"]),
                 int(pk["gray"]), int(pk["n_npc"] > 0), pk["drb"],
                 pk["n_maps"], pk["npw"], int(pk["tri"]), blob.device)
    return out
