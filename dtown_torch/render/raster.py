"""The XLA ray-caster as batched torch: camera frames of a batch of envs.

Counterpart of dtown/render/raster.py, which renders one env's frame
(vmapped over envs) with XLA ops and no Pallas kernel. Here every function
takes a batch of B envs (EnvState fields [B, ...]) and works on
[B, H, W, ...] tensors, with the reference's float32 arithmetic:

* the ground: a ray per pixel against the ground plane, the tile under
  the hit shaded analytically (shading.shade_tile, marking AA), the sky;
* objects: the Kvis nearest active objects (a stable descending sort of
  -distance, the order of ``lax.top_k``), each ray-cast against its
  primitive soup (spheres and boxes) in model space, composited by depth;
* ``mesh_fidelity="triangles"``: kinds registered from OBJ files
  (meshes.TRI_MESHES) ray-cast against their triangles instead;
* the ``draw_curve`` / ``draw_bbox`` debug overlays, fisheye rays
  (``distortion``) and grayscale (luma taken before quantisation).

On a stack of maps (map_loader.stack_maps) each env reads its own member
(``state.map_idx``) where the map is read: the tile grids are indexed by
(map, row, column), the object tables gathered [B, M]. ``render_frame``
renders in slices of envs so that the [B, H, W, P, 3] candidates of one
object stay within a fixed number of pixels (PIXELS_PER_SLICE).

No kernel: the work is elementwise tensor ops, as it is XLA in the
reference, on the card or on the CPU alike.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from dtown_torch import constants as C
from dtown_torch import physics
from dtown_torch import types as T
from dtown_torch.geometry import bezier_closest, bezier_point, div, \
    get_dir_vec, get_right_vec, norm3, sincos
from dtown_torch.objects import dynamic_corners, render_angles
from dtown_torch.render import lod
from dtown_torch.render import meshes as meshlib
from dtown_torch.render.distortion import undistorted_ndc
from dtown_torch.render.shading import shade_tile

_EPS = 1e-4
# pixels of one slice of envs: the object pass holds about ten
# [pixels, P_MAX, 3] float32 temporaries (about 1 KB a pixel)
PIXELS_PER_SLICE = 1 << 22
_LAMP_GREEN = (0.1, 0.85, 0.15)
_LAMP_RED = (0.9, 0.1, 0.1)

_OBJ_FIELDS = ("obj_mask", "obj_optional", "obj_kind", "obj_scale",
               "obj_is_dynamic", "obj_halfdims", "obj_corners", "obj_norms")


def _sum3(a, b):
    """sum(a * b) over the last axis of length 3, in order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def _f32(x, like):
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _objects_of(maps, mi):
    """The object tables of every env, [B, M, ...]: the env's member of a
    stack, or the map's own broadcast over the batch."""
    B = mi.shape[0]
    if maps.is_stack:
        return SimpleNamespace(**{f: getattr(maps, f)[mi.long()]
                                  for f in _OBJ_FIELDS})
    return SimpleNamespace(**{
        f: getattr(maps, f).expand((B,) + tuple(getattr(maps, f).shape))
        for f in _OBJ_FIELDS})


def _grid_at(maps, name, mi, j, i):
    """maps.<name>[j, i] per pixel (j, i int [B, ...]), on the env's member
    of a stack."""
    a = getattr(maps, name)
    if maps.is_stack:
        m = mi.long().reshape((-1,) + (1,) * (j.dim() - 1))
        return a[m, j.long(), i.long()]
    return a[j.long(), i.long()]


def _tile_size(maps, mi):
    """Tile size of every env, f32 [B]."""
    ts = maps.tile_size.to(torch.float32)
    return ts[mi.long()] if maps.is_stack else ts.expand(mi.shape[0])


def _active(objs, states):
    return objs.obj_mask & (~objs.obj_optional | states.obj_visible)


# ---------------------------------------------------------------------------
# Camera and ground
# ---------------------------------------------------------------------------

def camera_rays(cfg, states):
    """Unit ray directions f32 [B, H, W, 3] and eyes [B, 3]: the eye sits
    cam_height above the pose and cam_fwd_dist ahead, pitched down by
    cam_angle, vertical fov cam_fov_y; under cfg.distortion the pixel's
    NDC factors come from the inverted fisheye model."""
    H, W = cfg.camera_height, cfg.camera_width
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
    aspect = W / H
    if cfg.distortion:
        xb, yb = undistorted_ndc(W, H)
        xg = torch.as_tensor(xb, device=dev)[None, :, :, None]
        yg = torch.as_tensor(yb, device=dev)[None, :, :, None]
    else:
        ys = (0.5 - div(torch.arange(H, dtype=torch.float32, device=dev)
                        + 0.5, float(H))) * 2.0
        xs = (div(torch.arange(W, dtype=torch.float32, device=dev) + 0.5,
                  float(W)) - 0.5) * 2.0
        yg = ys[None, :, None, None]
        xg = xs[None, None, :, None]
    bc = lambda v: v[:, None, None, :]
    th = tan_half[:, None, None, None]
    d = bc(forward) + xg * (th * aspect) * bc(right) + yg * th * bc(up)
    d = d / norm3(d)[..., None]
    return d, eye


def _ground_color(cfg, maps, states, rays, eye):
    """Shaded ground and sky f32 [B, H, W, 3] and the ground hit distance
    t_bg [B, H, W] (inf on sky pixels)."""
    mi = states.map_idx
    dy = rays[..., 1]
    hits_ground = dy < -1e-6
    ey = eye[:, 1, None, None]
    t = torch.where(hits_ground,
                    -ey / torch.where(hits_ground, dy, -1.0), torch.inf)
    px = eye[:, 0, None, None] + t * rays[..., 0]
    pz = eye[:, 2, None, None] + t * rays[..., 2]

    ts = _tile_size(maps, mi)[:, None, None]
    fi = torch.floor(px / ts)
    fj = torch.floor(pz / ts)
    Hg, Wg = maps.grid_shape
    in_grid = (fi >= 0) & (fi < Wg) & (fj >= 0) & (fj < Hg) & hits_ground
    # pixels off the ground are masked below: give them tile 0
    i = torch.clamp(torch.where(in_grid, fi, 0.0).to(torch.int32), 0, Wg - 1)
    j = torch.clamp(torch.where(in_grid, fj, 0.0).to(torch.int32), 0, Hg - 1)

    kind = _grid_at(maps, "tile_tex", mi, j, i)
    bidx = torch.arange(dy.shape[0], device=dy.device)[:, None, None]
    variant = states.tex_variant[bidx, j.long(), i.long()]
    tangle = _grid_at(maps, "tile_angle", mi, j, i)

    u = px / ts - fi
    v = pz / ts - fj
    if cfg.marking_aa:
        # along-track footprint: inv_fw = dy^2 / (eye_y * px_ang) * ts
        px_ang = div(2.0 * torch.tan(0.5 * torch.deg2rad(states.cam_fov_y)),
                     float(cfg.camera_height))
        inv_fw = dy * dy / (ey * px_ang[:, None, None]) * ts
    else:
        inv_fw = None
    texel = shade_tile(kind, tangle, variant, u, v, inv_fw=inv_fw)

    ground_rgb = torch.where(in_grid[..., None], texel,
                             states.ground_color[:, None, None, :])
    amb = states.light_ambient
    diffuse = torch.clamp(-states.light_dir[:, 1], min=0.0)
    shade = amb + (1.0 - amb) * diffuse
    ground_rgb = ground_rgb * shade[:, None, None, None]
    sky = states.horizon_color[:, None, None, :] * (
        1.0 - 0.35 * torch.clamp(dy, min=0.0))[..., None]
    rgb = torch.where(hits_ground[..., None], ground_rgb, sky)
    t_bg = torch.where(hits_ground, t, torch.inf)
    return rgb, t_bg


# ---------------------------------------------------------------------------
# Objects
# ---------------------------------------------------------------------------

def _rot_xz(x, z, s, c):
    """(x, z) turned by the angle whose sincos is (s, c)."""
    return x * c + z * s, z * c - x * s


def _model_rays(eye, opos, oang, oscale, rays):
    """Eye [B, 3] and rays [B, H, W, 3] in the model space of one object of
    every env (pose opos [B, 3], heading oang [B], scale oscale [B])."""
    s_r, c_r = sincos(-oang)
    off = (eye - opos) / torch.clamp(oscale, min=1e-6)[:, None]
    ox, oz = _rot_xz(off[:, 0], off[:, 2], s_r, c_r)
    o_model = torch.stack([ox, off[:, 1], oz], -1)
    s4, c4 = s_r[:, None, None], c_r[:, None, None]
    dx, dz = _rot_xz(rays[..., 0], rays[..., 2], s4, c4)
    d_model = torch.stack([dx, rays[..., 1], dz], -1)
    return o_model[:, None, None, :].expand_as(d_model), d_model


def _to_world(n_model, oang):
    s_f, c_f = sincos(oang)
    s4, c4 = s_f[:, None, None], c_f[:, None, None]
    nx, nz = _rot_xz(n_model[..., 0], n_model[..., 2], s4, c4)
    return torch.stack([nx, n_model[..., 1], nz], -1)


def _lambert(states, n_world):
    diffuse = torch.clamp(
        -_sum3(n_world, states.light_dir[:, None, None, :]), min=0.0)
    amb = states.light_ambient[:, None, None]
    return amb + (1.0 - amb) * diffuse


def _intersect_prims(o, d, prim, prim_ok):
    """Rays (o, d [B, H, W, 3], model space) against one object's
    primitives per env (prim: dict of [B, P, ...] tables; prim_ok bool
    [B, P], the per-primitive LOD cull). Returns (t [B, H, W], normal
    [B, H, W, 3], winning primitive int64 [B, H, W], hit bool)."""
    ctr = prim["center"][:, None, None]                    # [B,1,1,P,3]
    par = prim["param"][:, None, None]
    oc = o[..., None, :] - ctr                             # [B,H,W,P,3]
    dd = d[..., None, :]                                   # [B,H,W,1,3]

    b = _sum3(oc, dd)
    cc = _sum3(oc, oc) - par[..., 0] ** 2
    disc = b * b - cc
    t_sph = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    sph_hit = (disc > 0.0) & (t_sph > _EPS)

    tiny = torch.where(dd >= 0, 1e-9, -1e-9)
    inv_d = 1.0 / torch.where(torch.abs(dd) < 1e-9, tiny, dd)
    t1 = (-par - oc) * inv_d
    t2 = (par - oc) * inv_d
    tmin = torch.minimum(t1, t2).amax(-1)
    tmax = torch.maximum(t1, t2).amin(-1)
    box_hit = tmax >= torch.clamp(tmin, min=_EPS)
    t_box = torch.where(tmin > _EPS, tmin, tmax)
    box_hit = box_hit & (t_box > _EPS)

    is_box = (prim["type"] == meshlib.BOX)[:, None, None]
    t_p = torch.where(is_box, t_box, t_sph)
    hit_p = torch.where(is_box, box_hit, sph_hit) \
        & prim["mask"][:, None, None] & prim_ok[:, None, None]
    t_p = torch.where(hit_p, t_p, torch.inf)

    best = torch.argmin(t_p, dim=-1)                       # [B,H,W]
    t_best = torch.gather(t_p, -1, best[..., None])[..., 0]
    hit = torch.isfinite(t_best)

    B = best.shape[0]
    flat = best.reshape(B, -1)

    def pick(tab):                                         # [B,P,3]
        return torch.gather(tab, 1, flat[..., None].expand(-1, -1, 3)) \
            .reshape(best.shape + (3,))

    he_b = pick(prim["param"])
    p_hit = o + t_best[..., None] * d
    rel = p_hit - pick(prim["center"])
    n_sph = rel / torch.clamp(norm3(rel), min=1e-9)[..., None]
    ratio = rel / torch.clamp(he_b, min=1e-9)
    ax = torch.argmax(torch.abs(ratio), dim=-1)
    n_box = torch.nn.functional.one_hot(ax, 3).to(o.dtype) * torch.sign(
        torch.gather(ratio, -1, ax[..., None]))
    is_box_b = torch.gather(prim["type"], 1, flat).reshape(best.shape) \
        == meshlib.BOX
    normal = torch.where(is_box_b[..., None], n_box, n_sph)
    return t_best, normal, best, hit


def _prim_tables(dev):
    t = meshlib.prim_tables()
    return {k: torch.as_tensor(v, device=dev) for k, v in t.items()}


def _render_objects(cfg, maps, states, objs, rays, eye, rgb, t_bg,
                    exclude=None):
    """Composite the Kvis nearest active objects of every env over (rgb,
    t_bg). exclude: bool [B, M] slots drawn by the triangle pass."""
    M = maps.max_objects
    Kvis = min(cfg.max_visible_objects, M)
    if M == 0 or Kvis == 0 or not np.asarray(maps.numpy().obj_mask).any():
        return rgb, t_bg
    dev = rgb.device
    prim = _prim_tables(dev)
    B = rays.shape[0]
    bi = torch.arange(B, device=dev)

    active = _active(objs, states)
    if exclude is not None:
        active = active & ~exclude
    dist = norm3(states.dyn.pos - eye[:, None, :])
    kmax = torch.as_tensor(lod.kind_culld_max(cfg), device=dev)
    kind = objs.obj_kind.long()
    slot_cull = torch.minimum(_f32(cfg.obj_cull_dist, dist),
                              kmax[kind] * objs.obj_scale)
    active = active & (dist < slot_cull)
    culld_base = torch.as_tensor(lod.prim_culld_base(cfg), device=dev)
    score = torch.where(active, -dist, -torch.inf)
    top = torch.sort(score, dim=-1, descending=True, stable=True)[1][:, :Kvis]
    draw_angle = render_angles(objs, states.dyn)
    green, red = _f32(_LAMP_GREEN, rgb), _f32(_LAMP_RED, rgb)
    cull = _f32(cfg.obj_cull_dist, rgb)

    for k in range(Kvis):
        m = top[:, k]
        ok = active[bi, m]
        oscale = objs.obj_scale[bi, m]
        okind = kind[bi, m]
        o_b, d_model = _model_rays(eye, states.dyn.pos[bi, m],
                                   draw_angle[bi, m], oscale, rays)
        pk = {key: v[okind] for key, v in prim.items()}
        prim_ok = dist[bi, m][:, None] < torch.minimum(
            cull, culld_base[okind] * oscale[:, None])
        t_m, n_model, best_p, hit = _intersect_prims(o_b, d_model, pk,
                                                     prim_ok)
        t_w = t_m * oscale[:, None, None]
        closer = hit & (t_w < t_bg) & ok[:, None, None]
        n_world = _to_world(n_model, draw_angle[bi, m])

        flat = best_p.reshape(B, -1)
        base_col = torch.gather(pk["color"], 1,
                                flat[..., None].expand(-1, -1, 3)) \
            .reshape(best_p.shape + (3,))
        is_lamp = torch.gather(pk["phase"], 1, flat).reshape(best_p.shape)
        lamp = torch.where((states.dyn.phase[bi, m] == 1)[:, None], green,
                           red)[:, None, None, :]
        base_col = torch.where(is_lamp[..., None], lamp, base_col)
        col = base_col * _lambert(states, n_world)[..., None]
        rgb = torch.where(closer[..., None], col, rgb)
        t_bg = torch.where(closer, t_w, t_bg)
    return rgb, t_bg


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _intersect_triangles(o, d, tris, cols):
    """Moeller-Trumbore of rays (o, d [B, H, W, 3]) against a triangle
    buffer (tris [T, 3, 3], cols [T, 3]). Returns (t [B, H, W], normal
    [B, H, W, 3] facing the ray, colour [B, H, W, 3], hit)."""
    v0 = tris[:, 0]
    e1 = tris[:, 1] - v0
    e2 = tris[:, 2] - v0
    dd = d[..., None, :]                                   # [B,H,W,1,3]
    pvec = _cross(dd, e2)                                  # [B,H,W,T,3]
    det = _sum3(e1, pvec)
    ok_det = torch.abs(det) > 1e-12
    inv_det = torch.where(ok_det, 1.0 / det, 0.0)
    tvec = o[..., None, :] - v0
    u = _sum3(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _sum3(dd, qvec) * inv_det
    t = _sum3(e2, qvec) * inv_det
    hit_p = ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > _EPS)
    t_p = torch.where(hit_p, t, torch.inf)
    best = torch.argmin(t_p, dim=-1)
    t_best = torch.gather(t_p, -1, best[..., None])[..., 0]
    hit = torch.isfinite(t_best)
    n_raw = _cross(e1, e2)
    n_raw = n_raw / torch.clamp(norm3(n_raw), min=1e-12)[..., None]
    normal = n_raw[best]
    flip = _sum3(normal, d)[..., None] > 0.0
    normal = torch.where(flip, -normal, normal)
    return t_best, normal, cols[best], hit


def _tri_slots(maps):
    """(slot, kind id) of every object slot whose kind has a registered
    triangle mesh, on the host map (any member of a stack)."""
    host = maps.numpy()
    kinds = np.asarray(host.obj_kind).reshape(-1, host.max_objects)
    mask = np.asarray(host.obj_mask).reshape(-1, host.max_objects)
    out = set()
    for km, mm in zip(kinds, mask):
        for s in np.nonzero(mm)[0]:
            if T.OBJ_KINDS[int(km[s])] in meshlib.TRI_MESHES:
                out.add((int(s), int(km[s])))
    return sorted(out)


def _render_tri_objects(cfg, states, objs, tri, rays, eye, rgb, t_bg):
    """The triangle-fidelity pass over the (slot, kind) pairs ``tri``."""
    dev = rgb.device
    active = _active(objs, states)
    draw_angle = render_angles(objs, states.dyn)
    for s, kid in tri:
        tris_np, cols_np = meshlib.TRI_MESHES[T.OBJ_KINDS[kid]]
        tris = torch.as_tensor(tris_np, device=dev)
        cols = torch.as_tensor(cols_np, device=dev)
        oscale = objs.obj_scale[:, s]
        o_b, d_model = _model_rays(eye, states.dyn.pos[:, s],
                                   draw_angle[:, s], oscale, rays)
        t_m, n_model, col, hit = _intersect_triangles(o_b, d_model, tris,
                                                      cols)
        t_w = t_m * oscale[:, None, None]
        on = active[:, s] & (objs.obj_kind[:, s] == kid)
        closer = hit & (t_w < t_bg) & on[:, None, None]
        n_world = _to_world(n_model, draw_angle[:, s])
        rgb = torch.where(closer[..., None],
                          col * _lambert(states, n_world)[..., None], rgb)
        t_bg = torch.where(closer, t_w, t_bg)
    return rgb, t_bg


# ---------------------------------------------------------------------------
# Debug overlays
# ---------------------------------------------------------------------------

def _ground_hits(rays, eye, t_bg):
    hit = torch.isfinite(t_bg)
    tt = torch.where(hit, t_bg, 0.0)
    px = eye[:, 0, None, None] + tt * rays[..., 0]
    pz = eye[:, 2, None, None] + tt * rays[..., 2]
    return hit, px, pz


def _overlay_curves(cfg, maps, states, rgb, rays, eye, t_bg):
    """draw_curve: ground pixels within 1 cm of a lane bezier of their
    tile painted red."""
    mi = states.map_idx
    hit, px, pz = _ground_hits(rays, eye, t_bg)
    ts = _tile_size(maps, mi)[:, None, None]
    Hg, Wg = maps.grid_shape
    i = torch.clamp(torch.floor(px / ts).to(torch.int32), 0, Wg - 1)
    j = torch.clamp(torch.floor(pz / ts).to(torch.int32), 0, Hg - 1)
    curves = _grid_at(maps, "curves", mi, j, i)          # [B,H,W,C,4,3]
    cmask = _grid_at(maps, "curve_mask", mi, j, i)       # [B,H,W,C]
    p = torch.stack([px, torch.zeros_like(px), pz], -1)
    pc = p[..., None, :].expand(curves.shape[:-2] + (3,))
    t = bezier_closest(curves, pc)
    e = bezier_point(curves, t) - pc
    d2 = _sum3(e, e)
    d2 = torch.where(cmask, d2, torch.inf)
    on_curve = hit & (d2.amin(-1) < 0.01 ** 2)
    return torch.where(on_curve[..., None], _f32(_LAMP_RED, rgb), rgb)


def _overlay_bboxes(cfg, states, objs, rgb, rays, eye, t_bg):
    """draw_bbox: the active objects' footprint rectangles traced on the
    ground in red."""
    hit, px, pz = _ground_hits(rays, eye, t_bg)
    corners, _ = dynamic_corners(objs, states.dyn)       # [B, M, 4, 2]
    active = _active(objs, states)
    on_edge = torch.zeros_like(hit)
    bc = lambda x: x[:, None, None]
    for m in range(corners.shape[1]):
        for a in range(4):
            c0 = corners[:, m, a]
            c1 = corners[:, m, (a + 1) % 4]
            e = c1 - c0
            L2 = torch.clamp(e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1],
                             min=1e-12)
            tt = torch.clamp(((px - bc(c0[:, 0])) * bc(e[:, 0])
                              + (pz - bc(c0[:, 1])) * bc(e[:, 1]))
                             / bc(L2), 0.0, 1.0)
            dx = px - (bc(c0[:, 0]) + tt * bc(e[:, 0]))
            dz = pz - (bc(c0[:, 1]) + tt * bc(e[:, 1]))
            on_edge = on_edge | (bc(active[:, m])
                                 & (dx * dx + dz * dz < 0.008 ** 2))
    on_edge = on_edge & hit
    return torch.where(on_edge[..., None], _f32((1.0, 0.0, 0.0), rgb), rgb)


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

def _slice_states(states, a, b):
    """Envs a..b of a batched EnvState."""
    cut = lambda obj: {f.name: getattr(obj, f.name)[a:b]
                       for f in dataclasses.fields(obj) if f.name != "dyn"}
    return states.replace(dyn=states.dyn.replace(**cut(states.dyn)),
                          **cut(states))


def _frame_slice(cfg, maps, states, tri):
    rays, eye = camera_rays(cfg, states)
    rgb, t_bg = _ground_color(cfg, maps, states, rays, eye)
    objs = _objects_of(maps, states.map_idx)
    if cfg.draw_curve:
        rgb = _overlay_curves(cfg, maps, states, rgb, rays, eye, t_bg)
    if cfg.draw_bbox:
        rgb = _overlay_bboxes(cfg, states, objs, rgb, rays, eye, t_bg)
    if cfg.render_objects:
        exclude = None
        if tri:
            tri_kind = torch.zeros(len(T.OBJ_KINDS), dtype=torch.bool,
                                   device=rgb.device)
            tri_kind[[k for _, k in tri]] = True
            exclude = tri_kind[objs.obj_kind.long()] & objs.obj_mask
        rgb, t_bg = _render_objects(cfg, maps, states, objs, rays, eye, rgb,
                                    t_bg, exclude=exclude)
        if tri:
            rgb, t_bg = _render_tri_objects(cfg, states, objs, tri, rays,
                                            eye, rgb, t_bg)
    rgb = torch.clamp(rgb, 0.0, 1.0)
    if cfg.grayscale:
        rgb = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
               + 0.114 * rgb[..., 2])[..., None]
    return (rgb * 255.0 + 0.5).to(torch.uint8)


def envs_per_slice(cfg, maps) -> int:
    """Envs rendered together: PIXELS_PER_SLICE pixels, fewer when a
    triangle mesh has more triangles than an object has primitives."""
    widest = meshlib.P_MAX
    for _, kid in (_tri_slots(maps) if cfg.mesh_fidelity == "triangles"
                   else ()):
        widest = max(widest,
                     len(meshlib.TRI_MESHES[T.OBJ_KINDS[kid]][0]))
    per_env = cfg.camera_height * cfg.camera_width * widest // meshlib.P_MAX
    return max(1, PIXELS_PER_SLICE // per_env)


def render_frame(cfg, maps, states, tri=None):
    """Camera frames uint8 [B, H, W, C] of every env (C = 1 under
    grayscale). ``maps`` is the tensor map (or stack) on the states'
    device; ``tri`` the triangle pass's (slot, kind) pairs, found on the
    host map when None."""
    if tri is None:
        tri = _tri_slots(maps) if cfg.mesh_fidelity == "triangles" else []
    B = states.batch_size
    n = envs_per_slice(cfg, maps)
    if B <= n:
        return _frame_slice(cfg, maps, states, tri)
    return torch.cat([
        _frame_slice(cfg, maps, _slice_states(states, a, min(a + n, B)), tri)
        for a in range(0, B, n)])


def render_top_down(cfg, maps, states):
    """Bird's-eye view of the whole map with an agent marker, uint8
    [B, H, W, 3]: the ray-caster from a synthetic camera 10 m above the
    map's centre looking straight down (screen up = -z), with no LOD, no
    distance cull, every object visible and no fisheye; then the agent's
    footprint painted red with a white front band. One map, not a
    stack."""
    if maps.is_stack:
        raise ValueError("the top-down view takes one map, not a stack")
    cfg = dataclasses.replace(
        cfg, obj_cull_dist=1e9, obj_lod_px=0.0,
        max_visible_objects=int(maps.obj_mask.shape[-1]), distortion=False)
    H, W = cfg.camera_height, cfg.camera_width
    Hg, Wg = maps.grid_shape
    B = states.batch_size
    dev = states.pos.device
    ts = maps.tile_size.to(torch.float32)
    cx = 0.5 * Wg * ts
    cz = 0.5 * Hg * ts
    cam_h = torch.tensor(10.0, device=dev)
    half_z = 0.525 * Hg * ts
    half_x = 0.525 * Wg * ts
    tan_half = torch.maximum(half_z, div(half_x, W / H)) / cam_h
    fov_y = 2.0 * torch.rad2deg(torch.atan(tan_half))
    full = lambda v: torch.as_tensor(v, dtype=torch.float32,
                                     device=dev).expand(B).clone()
    td = states.replace(
        pos=torch.stack([cx, torch.zeros_like(cx), cz]).expand(B, 3).clone(),
        angle=full(np.float32(np.pi / 2)), cam_angle=full(90.0),
        cam_height=full(10.0), cam_fwd_dist=full(0.0), cam_fov_y=full(fov_y))
    img = render_frame(cfg, maps, td)
    if cfg.grayscale:
        img = img.expand(-1, -1, -1, 3)

    rays, eye = camera_rays(cfg, td)
    dy = rays[..., 1]
    t = -eye[:, 1, None, None] / torch.where(dy < -1e-6, dy, -1.0)
    px = eye[:, 0, None, None] + t * rays[..., 0]
    pz = eye[:, 2, None, None] + t * rays[..., 2]
    center = physics.actual_center(states.pos, states.angle)
    s, c = sincos(states.angle)
    s, c = s[:, None, None], c[:, None, None]
    dx = px - center[:, 0, None, None]
    dz = pz - center[:, 2, None, None]
    u = dx * c - dz * s
    v = dx * s + dz * c
    half_l = float(np.float32(C.ROBOT_LENGTH / 2))
    half_w = float(np.float32(C.ROBOT_WIDTH / 2))
    in_box = (torch.abs(u) <= half_l) & (torch.abs(v) <= half_w)
    front = in_box & (u >= 0.5 * half_l)
    red = torch.tensor([220, 30, 30], dtype=torch.uint8, device=dev)
    white = torch.tensor([255, 255, 255], dtype=torch.uint8, device=dev)
    img = torch.where(in_box[..., None], red, img)
    return torch.where(front[..., None], white, img)
