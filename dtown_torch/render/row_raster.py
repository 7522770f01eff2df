"""Row-fed render: camera frames from per-env camera and object rows.

Counterpart of dtown/render/pallas_raster.py (``render_frames_pallas``
and its two TPU kernels). Each env's frame is computed from small per-env
rows: a camera row (eye, basis, intrinsics, light and colours), the
packed tile words of the map (kind | angle << 4 | variant << 6, 4 tiles
per int32 word) and the object data, in one of two forms:

* K3, the static scene (``_build_static_scene`` accepts the map: at most
  16 objects, none moving, no domain randomization): the scene's objects
  and primitives are a table shared by every env (``pack_static_scene``),
  and each env brings only a cull flag and a lamp phase per object
  (``_static_flags``). Launched through ``row_render_static``
  (csrc/row_render.cu), plain version ``render_frames_static_reference``.
* K4, every other map: each env brings its Kvis = min(max_visible, M)
  nearest objects and their primitives as dense rows
  (``prepare_object_blocks``). Launched through ``row_render``, plain
  version ``render_frames_rows_reference``.

Both kernels read the pixel's NDC ray factors from a table
(``_ndc_table``): the linear ramps, or under fisheye (cfg.distortion) the
inverted lens model's table, as the reference's ``_ndc_planes``. The
reference ignores ``mesh_fidelity`` here: kinds registered from OBJ files
render as their material boxes, on both sides.

The dispatcher ``render_frames_rows`` keeps the reference's branch
choice, including its quirk: with ``render_objects=False`` the reference
skips the static scene and takes K4, whose object rows ignore the flag,
so objects are still drawn.

A wrapper takes its plain version only for CPU tensors; on CUDA tensors it
launches the kernel or raises. The plain versions keep the kernels'
float32 operation order (no FMA, divisions by tensors, 1/sqrt for the
reference's rsqrt), so on the card the two agree to the bit. The kernels
skip objects by a keep flag and a per-pixel bounding-sphere test, which
change no pixel; ``row_kept``, ``row_bound_spheres`` and
``row_sphere_pass`` mirror those culls for the tests and chip_smoke.py's
bounds, and nothing on the main path calls them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from dtown_torch import _build
from dtown_torch import types as T
from dtown_torch.geometry import get_dir_vec, get_right_vec, norm3, sincos
from dtown_torch.objects import render_angles
from dtown_torch.render import lod as lodlib
from dtown_torch.render import meshes as meshlib
from dtown_torch.render.distortion import undistorted_ndc
from dtown_torch.render.tile_shading import INTERSECTION_KINDS, _shade_pixels

LANE_N = 128  # pixel lane width of the [S, 128] frame layout

# camera/scene row layout (per env)
CAM_F = 32
(C_EYE, C_FWD, C_RIGHT, C_UP, C_TANX, C_TANY, C_SHADE, C_GND, C_HOR,
 C_TSINV, C_LIGHT, C_AMB) = (0, 3, 6, 9, 12, 13, 14, 15, 18, 21, 22, 25)

# K4 object row: pos(3) sin cos inv_scale scale active
OBJ_F = 8
# K4 prim row: type cx cy cz p0 p1 p2 r g b
PRIM_F = 10
P_MAX = meshlib.P_MAX

# K3 scene table (csrc/row_render.cu SO_* / SP_* indices): per object
# floats and ints, per primitive floats and ints. Constants that the
# reference folds in Python doubles (sin/cos of -rot, 1/scale, r^2,
# 1/half-extent) are folded in float64 here and stored as float32. SO_RB:
# the kernel's world bounding radius (VIEW_PAD included).
SO_F = 8
SO_X, SO_Y, SO_Z, SO_SR, SO_CR, SO_INVS, SO_SC, SO_RB = range(8)
SO_I = 2
SOI_P0, SOI_NP = range(2)
SP_F = 13
(SP_CX, SP_CY, SP_CZ, SP_P0, SP_P1, SP_P2, SP_R, SP_G, SP_B, SP_P0SQ,
 SP_IP0, SP_IP1, SP_IP2) = range(13)
SP_I = 2
SPI_BOX, SPI_LAMP = range(2)

MAX_STATIC_OBJECTS = 16
# margin of the kernels' bounding spheres for float32 rounding (1 cm)
VIEW_PAD = 0.01
LAMP_GREEN = (0.1, 0.85, 0.15)
LAMP_RED = (0.9, 0.1, 0.1)


# ---------------------------------------------------------------------------
# Per-env rows
# ---------------------------------------------------------------------------

def pack_tile_words(maps, tex_variant):
    """Packed tile words of every env, int32 [B, ceil(Hg*Wg/4)]: byte =
    kind | angle << 4 | variant << 6, 4 tiles per word, little-endian.
    tex_variant int32 [B, Hg, Wg]."""
    B = tex_variant.shape[0]
    kind = maps.tile_kind.reshape(1, -1).to(torch.int32)
    angle = maps.tile_angle.reshape(1, -1).to(torch.int32)
    var = tex_variant.reshape(B, -1).to(torch.int32)
    byte = (kind & 0xF) | ((angle & 0x3) << 4) | ((var & 0x3) << 6)
    n = byte.shape[1]
    n_words = -(-n // 4)
    b = torch.zeros((B, n_words * 4), dtype=torch.int32, device=byte.device)
    b[:, :n] = byte
    b4 = b.reshape(B, n_words, 4)
    return (b4[..., 0] | (b4[..., 1] << 8) | (b4[..., 2] << 16)
            | (b4[..., 3] << 24))


def _prim_matrix():
    """[n_kinds, P_MAX * PRIM_F] flat prim features per object kind."""
    t = meshlib.prim_tables()
    Kn = t["type"].shape[0]
    out = np.zeros((Kn, P_MAX * PRIM_F), dtype=np.float32)
    for k in range(Kn):
        for p in range(P_MAX):
            base = p * PRIM_F
            if not t["mask"][k, p]:
                continue  # zero extents: no hit
            out[k, base + 0] = float(t["type"][k, p])
            out[k, base + 1:base + 4] = t["center"][k, p]
            out[k, base + 4:base + 7] = t["param"][k, p]
            out[k, base + 7:base + 10] = t["color"][k, p]
    return out


def prepare_camera_row(cfg, states):
    """Camera rows f32 [B, CAM_F] and eyes [B, 3] of every env. C_TSINV is
    left 0: the caller fills it from the map's tile size."""
    B = states.batch_size
    dev = states.pos.device
    fwd_flat = get_dir_vec(states.angle)
    right = get_right_vec(states.angle)
    up_y = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=dev)
    sp, cp = sincos(torch.deg2rad(states.cam_angle))
    sp, cp = sp[:, None], cp[:, None]
    forward = cp * fwd_flat - sp * up_y
    up = cp * up_y + sp * fwd_flat
    eye = (states.pos + states.cam_height[:, None] * up_y
           + states.cam_fwd_dist[:, None] * fwd_flat)
    tan_half = torch.tan(0.5 * torch.deg2rad(states.cam_fov_y))
    aspect = cfg.camera_width / cfg.camera_height
    amb = states.light_ambient
    diffuse = torch.clamp(-states.light_dir[:, 1], min=0.0)
    shade = amb + (1.0 - amb) * diffuse

    row = torch.zeros((B, CAM_F), dtype=torch.float32, device=dev)
    row[:, C_EYE:C_EYE + 3] = eye
    row[:, C_FWD:C_FWD + 3] = forward
    row[:, C_RIGHT:C_RIGHT + 3] = right
    row[:, C_UP:C_UP + 3] = up
    row[:, C_TANX] = tan_half * aspect
    row[:, C_TANY] = tan_half
    row[:, C_SHADE] = shade
    row[:, C_GND:C_GND + 3] = states.ground_color
    row[:, C_HOR:C_HOR + 3] = states.horizon_color
    row[:, C_LIGHT:C_LIGHT + 3] = states.light_dir
    row[:, C_AMB] = amb
    return row, eye


def prepare_object_blocks(cfg, maps, states, eye, pk):
    """K4's per-env rows of the Kvis nearest active objects: obj f32
    [B, Kvis*OBJ_F] and prim f32 [B, Kvis*P_MAX*PRIM_F].

    An object is active when its slot is live, visible and nearer than its
    size-aware cull distance. Rows follow a stable descending sort of
    -distance (inactive slots at -inf), the order of the reference's
    ``lax.top_k``: equal scores keep the lower slot first. The reference's
    one-hot matmul gathers are indexed gathers here."""
    Kvis = pk["Kvis"]
    active = maps.obj_mask & (~maps.obj_optional | states.obj_visible)
    dist = norm3(states.dyn.pos - eye[:, None, :])
    active = active & (dist < pk["slot_cull"])
    score = torch.where(active, -dist, -torch.inf)
    top = torch.sort(score, dim=-1, descending=True, stable=True)[1][:, :Kvis]

    def take(a):
        return torch.gather(a, 1, top)

    pos = torch.gather(states.dyn.pos, 1, top[..., None].expand(-1, -1, 3))
    ang = take(render_angles(maps, states.dyn))
    scale = maps.obj_scale[top]
    kind = maps.obj_kind[top].long()
    act = take(active).to(torch.float32)
    phase = take(states.dyn.phase).to(torch.float32)

    s_r, c_r = sincos(-ang)
    inv_s = torch.ones_like(scale) / torch.clamp(scale, min=1e-6)
    obj = torch.stack([pos[..., 0], pos[..., 1], pos[..., 2], s_r, c_r,
                       inv_s, scale, act], dim=-1)
    prim = pk["prim_mat"][kind]                      # [B, Kvis, P*F]
    lb = pk["lamp_base"]
    lamp = torch.where((phase >= 0.5)[..., None], pk["lamp_green"],
                       pk["lamp_red"])
    is_lamp = (kind == T.OBJ_KIND_IDS["trafficlight"])[..., None]
    prim[..., lb + 7:lb + 10] = torch.where(is_lamp, lamp,
                                            prim[..., lb + 7:lb + 10])
    B = states.batch_size
    return obj.reshape(B, -1), prim.reshape(B, -1)


def _static_flags(cfg, maps, states, eye, pk):
    """K3's per-env row f32 [B, 2*n]: cull flag and lamp phase of each
    scene object (the map's static pose, its size-aware cull distance)."""
    slots = pk["scene_slots"]
    dist = norm3(maps.obj_pos[slots][None] - eye[:, None, :])
    act = (dist < pk["slot_cull"][slots]).to(torch.float32)
    phase = states.dyn.phase[:, slots].to(torch.float32)
    return torch.stack([act, phase], dim=-1).reshape(states.batch_size, -1)


# ---------------------------------------------------------------------------
# Static scene (K3)
# ---------------------------------------------------------------------------

def _build_static_scene(cfg, maps):
    """None if the map needs K4, else the list of its objects (dicts of
    Python floats: pos, sin/cos of -rot, 1/scale, scale, primitives with
    type/centre/extents/colour/lamp flag, slot). [] when it has none."""
    maps = maps.numpy()
    if cfg.domain_rand:
        return None
    obj_mask = np.asarray(maps.obj_mask)
    kinds = np.asarray(maps.obj_kind)
    dyn = np.asarray(maps.obj_is_dynamic)
    moving = obj_mask & dyn & (kinds != T.OBJ_KIND_IDS["trafficlight"])
    if moving.any():
        return None
    M = int(obj_mask.sum())
    if M == 0 or M > MAX_STATIC_OBJECTS:
        return None if M else []
    pos = np.asarray(maps.obj_pos)
    rot = np.asarray(maps.obj_y_rot)
    scale = np.asarray(maps.obj_scale)
    tables = meshlib.prim_tables()
    scene = []
    for m in np.nonzero(obj_mask)[0]:
        k = int(kinds[m])
        prims = [dict(
            is_box=int(tables["type"][k, p]) == meshlib.BOX,
            center=tuple(float(x) for x in tables["center"][k, p]),
            param=tuple(float(x) for x in tables["param"][k, p]),
            color=tuple(float(x) for x in tables["color"][k, p]),
            lamp=bool(tables["phase"][k, p]),
        ) for p in range(meshlib.P_MAX) if tables["mask"][k, p]]
        sc = float(scale[m])
        scene.append(dict(
            pos=tuple(float(x) for x in pos[m]),
            s_r=math.sin(-float(rot[m])), c_r=math.cos(-float(rot[m])),
            inv_s=1.0 / max(sc, 1e-6), scale=sc, prims=prims, slot=int(m),
        ))
    return scene


def _bound_radius(ob):
    """World bounding radius of a K3 object around its position: the reach
    of its farthest primitive (|c| + r, or |c| + |half extents| for a box)
    times its scale, plus VIEW_PAD; float64."""
    r = 0.0
    for pr in ob["prims"]:
        c, p = pr["center"], pr["param"]
        reach = math.sqrt(sum(x * x for x in p)) if pr["is_box"] else p[0]
        r = max(r, math.sqrt(sum(x * x for x in c)) + reach)
    return r * ob["scale"] + VIEW_PAD


def pack_static_scene(scene):
    """The K3 scene as flat numpy tables (sof, soi, spf, spi)."""
    n_prims = sum(len(ob["prims"]) for ob in scene)
    sof = np.zeros((max(len(scene), 1), SO_F), np.float32)
    soi = np.zeros((max(len(scene), 1), SO_I), np.int32)
    spf = np.zeros((max(n_prims, 1), SP_F), np.float32)
    spi = np.zeros((max(n_prims, 1), SP_I), np.int32)
    j = 0
    for i, ob in enumerate(scene):
        sof[i] = ob["pos"] + (ob["s_r"], ob["c_r"], ob["inv_s"], ob["scale"],
                              _bound_radius(ob))
        soi[i] = (j, len(ob["prims"]))
        for pr in ob["prims"]:
            p0, p1, p2 = pr["param"]
            spf[j] = (pr["center"] + pr["param"] + pr["color"]
                      + (p0 * p0, 1.0 / max(p0, 1e-9), 1.0 / max(p1, 1e-9),
                         1.0 / max(p2, 1e-9)))
            spi[j] = (int(pr["is_box"]), int(pr["lamp"]))
            j += 1
    return sof, soi, spf, spi


def _ndc_table(H, W, fisheye):
    """[2, H*W] float32 NDC ray factors (xb, yb) that K3/K4 scale by the
    env's tan(fov/2): the inverted lens model's table under fisheye, else
    the reference kernels' ramps ((x + .5) / W - .5) * 2 and
    (.5 - (y + .5) / H) * 2, each operation rounded to float32."""
    if fisheye:
        xb, yb = undistorted_ndc(W, H)
        return np.stack([xb.reshape(-1), yb.reshape(-1)])
    f = np.float32
    p = np.arange(H * W, dtype=np.int64)
    y = p // W
    x = (p - y * W).astype(f)
    y = y.astype(f)
    xb = ((x + f(0.5)) / f(W) - f(0.5)) * f(2.0)
    yb = (f(0.5) - (y + f(0.5)) / f(H)) * f(2.0)
    return np.stack([xb, yb]).astype(f)


def pack_row_scene(cfg, maps):
    """Everything the row-fed render needs that does not change per step,
    on the map's device (dict): frame and grid sizes, the NDC table, the
    branch (K3 when the static scene builds), K3's scene tables or K4's
    prim matrix, and the per-slot cull distances. One map: a stack renders
    through the XLA ray-caster (render/raster.py), as in the reference."""
    host = maps.numpy()
    dev = maps.obj_pos.device
    H, W = cfg.camera_height, cfg.camera_width
    if (H * W) % LANE_N:
        raise ValueError(f"H*W must be a multiple of {LANE_N}: {H}x{W}")
    Hg, Wg = host.grid_shape
    present = set(int(x) for x in np.unique(np.asarray(host.tile_kind)))
    kmax = lodlib.kind_culld_max(cfg)
    slot_cull = np.minimum(
        np.float32(cfg.obj_cull_dist),
        kmax[np.asarray(host.obj_kind)] * np.asarray(host.obj_scale))
    scene = _build_static_scene(cfg, host) if cfg.render_objects else None
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    pk = dict(
        H=H, W=W, Hg=int(Hg), Wg=int(Wg), n_words=-(-int(Hg * Wg) // 4),
        aa=bool(cfg.marking_aa),
        any_x=any(k in present for k in INTERSECTION_KINDS),
        ts_inv=float(np.float32(1.0) / np.float32(host.tile_size)),
        ndc=t(_ndc_table(H, W, bool(cfg.distortion))),
        static=scene is not None, slot_cull=t(slot_cull.astype(np.float32)),
    )
    if scene is not None:
        sof, soi, spf, spi = pack_static_scene(scene)
        pk.update(n_objs=len(scene), sof=t(sof), soi=t(soi), spf=t(spf),
                  spi=t(spi),
                  scene_slots=t(np.array([ob["slot"] for ob in scene],
                                         np.int64)))
    else:
        tl = meshlib.prim_tables()["phase"][T.OBJ_KIND_IDS["trafficlight"]]
        pk.update(
            Kvis=min(cfg.max_visible_objects, host.max_objects),
            prim_mat=t(_prim_matrix()),
            lamp_base=int(np.argmax(tl)) * PRIM_F,
            lamp_green=t(np.array(LAMP_GREEN, np.float32)),
            lamp_red=t(np.array(LAMP_RED, np.float32)),
        )
    return pk


# ---------------------------------------------------------------------------
# Plain versions of the two kernels
# ---------------------------------------------------------------------------

def _recip_sqrt(x):
    """1/sqrt(x) as a true division (the kernels' 1.0f / sqrtf)."""
    return torch.ones_like(x) / torch.sqrt(x)


def _safe_inv(dm):
    return torch.ones_like(dm) / torch.where(
        torch.abs(dm) < 1e-9, torch.where(dm >= 0, 1e-9, -1e-9), dm)


def _ground(cam, words, pk):
    """Per-pixel ray, ground hit, tile shading and sky of every env (the
    part K3 and K4 share). cam [B, CAM_F], words int32 [B, n_words]."""
    H = pk["H"]
    where = torch.where
    c = lambda i: cam[:, i:i + 1]                   # [B, 1]
    xn = pk["ndc"][0][None] * c(C_TANX)             # [B, P]
    yn = pk["ndc"][1][None] * c(C_TANY)
    dx = c(C_FWD) + xn * c(C_RIGHT) + yn * c(C_UP)
    dy = c(C_FWD + 1) + xn * c(C_RIGHT + 1) + yn * c(C_UP + 1)
    dz = c(C_FWD + 2) + xn * c(C_RIGHT + 2) + yn * c(C_UP + 2)
    inv_n = _recip_sqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * inv_n, dy * inv_n, dz * inv_n

    eye0, eye1, eye2 = c(C_EYE), c(C_EYE + 1), c(C_EYE + 2)
    hg = dy < -1e-6
    t_g = where(hg, -eye1 / where(hg, dy, -1.0), 1e30)
    ts_inv = c(C_TSINV)
    fx = (eye0 + t_g * dx) * ts_inv
    fz = (eye2 + t_g * dz) * ts_inv
    ti = torch.floor(fx)
    tj = torch.floor(fz)
    Hg, Wg = pk["Hg"], pk["Wg"]
    in_grid = (ti >= 0) & (ti < Wg) & (tj >= 0) & (tj < Hg) & hg
    ii = torch.clamp(ti.to(torch.int32), 0, Wg - 1)
    jj = torch.clamp(tj.to(torch.int32), 0, Hg - 1)
    tid = jj * Wg + ii
    word = torch.gather(words, 1, (tid >> 2).long())
    byte = (word >> ((tid & 3) * 8)) & 0xFF
    inv_fw = None
    if pk["aa"]:
        k_fw = torch.full_like(eye1, float(H)) / (2.0 * c(C_TANY)) \
            / ts_inv / eye1
        inv_fw = dy * dy * k_fw
    r_, g_, b_ = _shade_pixels(byte & 0xF, (byte >> 4) & 0x3, fx - ti,
                               fz - tj, pk["any_x"], inv_fw=inv_fw,
                               variant=(byte >> 6) & 0x3)
    shade = c(C_SHADE)
    r_ = where(in_grid, r_, c(C_GND)) * shade
    g_ = where(in_grid, g_, c(C_GND + 1)) * shade
    b_ = where(in_grid, b_, c(C_GND + 2)) * shade
    sky_f = 1.0 - 0.35 * torch.clamp(dy, min=0.0)
    r_ = where(hg, r_, c(C_HOR) * sky_f)
    g_ = where(hg, g_, c(C_HOR + 1) * sky_f)
    b_ = where(hg, b_, c(C_HOR + 2) * sky_f)
    return dict(dx=dx, dy=dy, dz=dz, eye=(eye0, eye1, eye2),
                t_best=where(hg, t_g, 1e30), rgb=[r_, g_, b_],
                light=(c(C_LIGHT), c(C_LIGHT + 1), c(C_LIGHT + 2)),
                amb=c(C_AMB))


def _model_ray(g, ox, oy, oz, s_r, c_r, inv_s):
    """The env's rays in one object's model space (rotated by -rot,
    eye scaled by 1/scale) and the slab reciprocals."""
    eye0, eye1, eye2 = g["eye"]
    ex = (eye0 - ox) * inv_s
    ey = (eye1 - oy) * inv_s
    ez = (eye2 - oz) * inv_s
    m = dict(emx=ex * c_r + ez * s_r, ey=ey, emz=ez * c_r - ex * s_r,
             dmx=g["dx"] * c_r + g["dz"] * s_r,
             dmz=g["dz"] * c_r - g["dx"] * s_r)
    m.update(inv_x=_safe_inv(m["dmx"]), inv_y=_safe_inv(g["dy"]),
             inv_z=_safe_inv(m["dmz"]))
    return m


def _box_test(m, dy, cx, cy, cz, p0, p1, p2):
    """Slab test of a box (half extents p0..p2): (t, hit)."""
    ocx, ocy, ocz = m["emx"] - cx, m["ey"] - cy, m["emz"] - cz

    def slab(oc, inv, he):
        t1 = (-he - oc) * inv
        t2 = (he - oc) * inv
        return torch.minimum(t1, t2), torch.maximum(t1, t2)

    n1, x1 = slab(ocx, m["inv_x"], p0)
    n2, x2 = slab(ocy, m["inv_y"], p1)
    n3, x3 = slab(ocz, m["inv_z"], p2)
    tmin = torch.maximum(torch.maximum(n1, n2), n3)
    tmax = torch.minimum(torch.minimum(x1, x2), x3)
    t_m = torch.where(tmin > 1e-4, tmin, tmax)
    hit = (tmax >= torch.clamp(tmin, min=1e-4)) & (t_m > 1e-4)
    return t_m, hit


def _sphere_test(m, dy, cx, cy, cz, r2):
    """Ray-sphere test (r2 = radius^2): (t, hit)."""
    ocx, ocy, ocz = m["emx"] - cx, m["ey"] - cy, m["emz"] - cz
    bq = ocx * m["dmx"] + ocy * dy + ocz * m["dmz"]
    cq = ocx * ocx + ocy * ocy + ocz * ocz - r2
    disc = bq * bq - cq
    t_m = -bq - torch.sqrt(torch.clamp(disc, min=0.0))
    return t_m, (disc > 0.0) & (t_m > 1e-4)


def _hit_offset(m, dy, t_m, cx, cy, cz):
    return (m["emx"] + t_m * m["dmx"] - cx, m["ey"] + t_m * dy - cy,
            m["emz"] + t_m * m["dmz"] - cz)


def _box_normal(ax_, ay_, az_, hx, hy, hz):
    sgn = lambda q: torch.where(q >= 0.0, 1.0, -1.0)
    xb = (ax_ >= ay_) & (ax_ >= az_)
    yb = ~xb & (ay_ >= az_)
    return (torch.where(xb, sgn(hx), 0.0), torch.where(yb, sgn(hy), 0.0),
            torch.where(xb | yb, 0.0, sgn(hz)))


def _sphere_normal(hx, hy, hz):
    rinv = _recip_sqrt(torch.clamp(hx * hx + hy * hy + hz * hz, min=1e-12))
    return hx * rinv, hy * rinv, hz * rinv


def _lambert(g, nmx, nmy, nmz, s_r, c_r):
    """ambient + (1 - ambient) * max(0, -n_world . light)."""
    lx, ly, lz = g["light"]
    nwx = nmx * c_r - nmz * s_r
    nwz = nmz * c_r + nmx * s_r
    diff = torch.clamp(-(nwx * lx + nmy * ly + nwz * lz), min=0.0)
    return g["amb"] + (1.0 - g["amb"]) * diff


def _composite(g, closer, t_w, sh, colors):
    rgb = g["rgb"]
    for i in range(3):
        rgb[i] = torch.where(closer, colors[i] * sh, rgb[i])
    g["t_best"] = torch.where(closer, t_w, g["t_best"])


def _to_u8(rgb, H, W):
    B = rgb[0].shape[0]
    q = [(torch.clamp(v, 0.0, 1.0) * 255.0 + 0.5).to(torch.int32)
         .to(torch.uint8) for v in rgb]
    return torch.stack(q, dim=1).reshape(B, 3, H * W // LANE_N, LANE_N)


def render_frames_static_reference(cam, words, flags, pk):
    """Plain torch version of K3 (static scene). cam f32 [B, CAM_F], words
    int32 [B, n_words], flags f32 [B, 2*n_objs]; pk = pack_row_scene(...)
    of a static-scene map. Returns uint8 [B, 3, S, 128]."""
    g = _ground(cam, words, pk)
    dy = g["dy"]
    sof, soi = pk["sof"].cpu().tolist(), pk["soi"].cpu().tolist()
    spf, spi = pk["spf"].cpu().tolist(), pk["spi"].cpu().tolist()
    for i in range(pk["n_objs"]):
        act = flags[:, 2 * i:2 * i + 1]
        phase = flags[:, 2 * i + 1:2 * i + 2]
        ov = sof[i]
        s_r, c_r = ov[SO_SR], ov[SO_CR]
        m = _model_ray(g, ov[SO_X], ov[SO_Y], ov[SO_Z], s_r, c_r,
                       ov[SO_INVS])
        p0_, n_p = soi[i]
        for j in range(p0_, p0_ + n_p):
            pv = spf[j]
            is_box, lamp = spi[j]
            cx, cy, cz = pv[SP_CX], pv[SP_CY], pv[SP_CZ]
            if is_box:
                t_m, hit = _box_test(m, dy, cx, cy, cz, pv[SP_P0],
                                     pv[SP_P1], pv[SP_P2])
            else:
                t_m, hit = _sphere_test(m, dy, cx, cy, cz, pv[SP_P0SQ])
            t_w = t_m * ov[SO_SC]
            closer = hit & (t_w < g["t_best"]) & (act > 0.5)
            hx, hy, hz = _hit_offset(m, dy, t_m, cx, cy, cz)
            if is_box:
                n = _box_normal(torch.abs(hx) * pv[SP_IP0],
                                torch.abs(hy) * pv[SP_IP1],
                                torch.abs(hz) * pv[SP_IP2], hx, hy, hz)
            else:
                n = _sphere_normal(hx, hy, hz)
            sh = _lambert(g, *n, s_r, c_r)
            if lamp:
                green = phase > 0.5
                colors = [torch.where(green, LAMP_GREEN[k], LAMP_RED[k])
                          for k in range(3)]
            else:
                colors = [pv[SP_R], pv[SP_G], pv[SP_B]]
            _composite(g, closer, t_w, sh, colors)
    return _to_u8(g["rgb"], pk["H"], pk["W"])


def render_frames_rows_reference(cam, words, obj, prim, pk):
    """Plain torch version of K4 (object rows). cam f32 [B, CAM_F], words
    int32 [B, n_words], obj f32 [B, Kvis*OBJ_F], prim f32
    [B, Kvis*P_MAX*PRIM_F]. Returns uint8 [B, 3, S, 128]."""
    g = _ground(cam, words, pk)
    dy = g["dy"]
    for k in range(obj.shape[1] // OBJ_F):
        o = lambda j: obj[:, k * OBJ_F + j:k * OBJ_F + j + 1]    # [B, 1]
        s_r, c_r = o(3), o(4)
        m = _model_ray(g, o(0), o(1), o(2), s_r, c_r, o(5))
        for pi in range(P_MAX):
            base = (k * P_MAX + pi) * PRIM_F
            q = lambda j: prim[:, base + j:base + j + 1]
            cx, cy, cz, p0, p1, p2 = q(1), q(2), q(3), q(4), q(5), q(6)
            t_sph, sph_hit = _sphere_test(m, dy, cx, cy, cz, p0 * p0)
            t_box, box_hit = _box_test(m, dy, cx, cy, cz, p0, p1, p2)
            is_box = q(0) > 0.5
            t_m = torch.where(is_box, t_box, t_sph)
            hit = (is_box & box_hit) | (~is_box & sph_hit)
            t_w = t_m * o(6)
            closer = hit & (t_w < g["t_best"]) & (o(7) > 0.5)
            hx, hy, hz = _hit_offset(m, dy, t_m, cx, cy, cz)
            bn = _box_normal(torch.abs(hx) / torch.clamp(p0, min=1e-9),
                             torch.abs(hy) / torch.clamp(p1, min=1e-9),
                             torch.abs(hz) / torch.clamp(p2, min=1e-9),
                             hx, hy, hz)
            sn = _sphere_normal(hx, hy, hz)
            n = [torch.where(is_box, b, s) for b, s in zip(bn, sn)]
            sh = _lambert(g, *n, s_r, c_r)
            _composite(g, closer, t_w, sh, [q(7), q(8), q(9)])
    return _to_u8(g["rgb"], pk["H"], pk["W"])


# ---------------------------------------------------------------------------
# Plain mirrors of the kernels' culls (tests and chip_smoke.py's bounds)
# ---------------------------------------------------------------------------

def row_kept(rows, pk):
    """Plain mirror of the kernels' keep predicate (their per-block
    prologue) on the rows of prepare_rows: bool [B, n], the objects each
    env's pixel pass walks, in walk order (K3: the scene objects whose cull
    flag is on; K4: the row slots whose active flag is on)."""
    if pk["static"]:
        return rows[2][:, 0:2 * pk["n_objs"]:2] > 0.5
    return rows[2].reshape(rows[2].shape[0], -1, OBJ_F)[..., 7] > 0.5


def row_bound_spheres(rows, pk):
    """The kernels' world bounding spheres, in their float32 operations:
    (centres f32 [B, n, 3], radii f32 [B, n]). A centre is the object's
    position. K3's radius is the scene table's SO_RB; K4's comes from the
    env's primitive rows: the largest |c| + p0 (sphere) or |c| + |(p0, p1,
    p2)| (box) over the object's slots, padded ones included, times the
    scale, plus VIEW_PAD."""
    B = rows[0].shape[0]
    if pk["static"]:
        sof = pk["sof"][:pk["n_objs"]].to(rows[0].device)
        return (sof[None, :, SO_X:SO_Z + 1].expand(B, -1, -1),
                sof[None, :, SO_RB].expand(B, -1))
    obj = rows[2].reshape(B, -1, OBJ_F)
    prim = rows[3].reshape(B, obj.shape[1], P_MAX, PRIM_F)
    q = lambda j: prim[..., j]
    cl = torch.sqrt(q(1) * q(1) + q(2) * q(2) + q(3) * q(3))
    reach = torch.where(q(0) > 0.5,
                        torch.sqrt(q(4) * q(4) + q(5) * q(5) + q(6) * q(6)),
                        q(4))
    return obj[..., 0:3], (cl + reach).amax(-1) * obj[..., 6] + VIEW_PAD


def row_sphere_pass(rows, pk):
    """Plain mirror of the kernels' per-pixel bounding-sphere test, in
    their float32 operations, on the rows' device: bool [B, n, P], True
    where the object is kept (``row_kept``) and the pixel's ray meets its
    bounding sphere (``row_bound_spheres``) or starts inside it. The
    kernels skip the object's model ray and primitive tests on every other
    pixel: none of its primitives can be hit there."""
    cam = rows[0]
    g = _ground(cam, rows[1], pk)
    centre, rb = row_bound_spheres(rows, pk)
    b = centre - cam[:, None, C_EYE:C_EYE + 3]
    bx, by, bz = b[..., 0:1], b[..., 1:2], b[..., 2:3]     # [B, n, 1]
    c2 = bx * bx + by * by + bz * bz - rb[..., None] * rb[..., None]
    bq = (bx * g["dx"][:, None] + by * g["dy"][:, None]
          + bz * g["dz"][:, None])
    miss = (c2 > 0.0) & ((bq < 0.0) | (bq * bq < c2))
    return ~miss & row_kept(rows, pk)[..., None]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_row_render_static = _build.kernel("row_render", "dtown_row_render_static",
                                  "P" * 9 + "i" * 9, "row_render_static")
_row_render = _build.kernel("row_render", "dtown_row_render",
                           "P" * 6 + "i" * 9, "row_render")


def _check_rows(cam, words, pk, **rows):
    B = cam.shape[0]
    want = dict(cam=(cam, torch.float32, CAM_F),
                words=(words, torch.int32, pk["n_words"]))
    for name, (t, width) in rows.items():
        want[name] = (t, torch.float32, width)
    for name, (t, dtype, width) in want.items():
        if t.dtype != dtype or t.dim() != 2 or tuple(t.shape) != (B, width):
            raise ValueError(f"{name} must be {dtype} [{B}, {width}], got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != cam.device:
            raise ValueError("render rows must share one device")
    if cam.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {cam.device}")


def _dims(pk):
    return [pk["H"], pk["W"], pk["n_words"], pk["Hg"], pk["Wg"]]


def row_render_static(cam, words, flags, pk):
    """K3: frames uint8 [B, 3, S, 128] of a static-scene map from camera
    rows, tile words and per-object (cull, phase) flags. A CUDA batch goes
    through csrc/row_render.cu, a CPU batch through
    ``render_frames_static_reference``."""
    _check_rows(cam, words, pk, flags=(flags, 2 * max(pk["n_objs"], 1)))
    if cam.device.type == "cpu":
        return render_frames_static_reference(cam, words, flags, pk)
    if pk["n_objs"] > MAX_STATIC_OBJECTS:
        raise ValueError(f"at most {MAX_STATIC_OBJECTS} static objects")
    B = cam.shape[0]
    out = torch.empty((B, 3, pk["H"] * pk["W"] // LANE_N, LANE_N),
                      dtype=torch.uint8, device=cam.device)
    cam, words, flags = (t.contiguous() for t in (cam, words, flags))
    _row_render_static(cam.data_ptr(), words.data_ptr(),
                       pk["ndc"].data_ptr(), flags.data_ptr(),
                       pk["sof"].data_ptr(), pk["soi"].data_ptr(),
                       pk["spf"].data_ptr(), pk["spi"].data_ptr(),
                       out.data_ptr(), B, *_dims(pk), pk["n_objs"],
                       int(pk["aa"]), int(pk["any_x"]), cam.device)
    return out


def row_render(cam, words, obj, prim, pk):
    """K4: frames uint8 [B, 3, S, 128] from camera rows, tile words and the
    per-env object and primitive rows. A CUDA batch goes through
    csrc/row_render.cu, a CPU batch through
    ``render_frames_rows_reference``."""
    Kvis = pk["Kvis"]
    _check_rows(cam, words, pk, obj=(obj, Kvis * OBJ_F),
                prim=(prim, Kvis * P_MAX * PRIM_F))
    if cam.device.type == "cpu":
        return render_frames_rows_reference(cam, words, obj, prim, pk)
    B = cam.shape[0]
    out = torch.empty((B, 3, pk["H"] * pk["W"] // LANE_N, LANE_N),
                      dtype=torch.uint8, device=cam.device)
    cam, words, obj, prim = (t.contiguous() for t in (cam, words, obj, prim))
    _row_render(cam.data_ptr(), words.data_ptr(), pk["ndc"].data_ptr(),
                obj.data_ptr(), prim.data_ptr(), out.data_ptr(),
                B, *_dims(pk), Kvis, int(pk["aa"]), int(pk["any_x"]),
                cam.device)
    return out


# ---------------------------------------------------------------------------
# Dispatcher
# ---------------------------------------------------------------------------

def prepare_rows(cfg, maps, states, pk):
    """The kernel inputs of one batch: (cam, words, flags) for K3 or
    (cam, words, obj, prim) for K4, as pk's branch says."""
    cam, eye = prepare_camera_row(cfg, states)
    cam[:, C_TSINV] = pk["ts_inv"]
    words = pack_tile_words(maps, states.tex_variant)
    if pk["static"]:
        if pk["n_objs"]:
            flags = _static_flags(cfg, maps, states, eye, pk)
        else:
            flags = torch.zeros((states.batch_size, 2), dtype=torch.float32,
                                device=cam.device)
        return cam, words, flags
    obj, prim = prepare_object_blocks(cfg, maps, states, eye, pk)
    return cam, words, obj, prim


def render_frames_rows(cfg, maps, states, pack=None):
    """Batched RGB frames uint8 [B, 3, S, 128] of every env (byte-identical
    to [B, 3, H, W]); use planes_to_nhwc for [B, H, W, 3]. ``pack`` is
    pack_row_scene(cfg, maps), built here when None."""
    pk = pack if pack is not None else pack_row_scene(cfg, maps)
    rows = prepare_rows(cfg, maps, states, pk)
    if pk["static"]:
        return row_render_static(*rows, pk)
    return row_render(*rows, pk)


def planes_to_nhwc(cfg, planes):
    """uint8 [B, C, S, 128] -> [B, H, W, C]."""
    H, W = cfg.camera_height, cfg.camera_width
    B, Cn = planes.shape[:2]
    return planes.reshape(B, Cn, H * W).movedim(1, -1).reshape(B, H, W, Cn)
