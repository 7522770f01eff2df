"""The row-fed render kernels' culls, mirrored in plain torch: their keep
predicate (the per-block prologue of csrc/row_render.cu;
row_raster.row_kept), their world bounding spheres
(row_raster.row_bound_spheres) and their per-pixel bounding-sphere test
(row_raster.row_sphere_pass). An object alone in the scene changes no
pixel whose ray the sphere test rejects, every bounding sphere contains
every real primitive (and K4's the model origin, where its padded slots
sit), and dropping the objects the predicate rejects leaves the plain
render's bytes equal.
Cases at 32x32 with 8 envs on the step path: K3 on loop_obstacles, linear
and fisheye; K4 on bigtown, udem1 with domain randomization, and bigtown
fisheye. Half the envs stand 0.3-0.8 m from an object facing it, half turn
their back to it. chip_smoke.py holds the kernels against their plain
versions on the card (max |diff| 0), on these poses too."""
import itertools
import math

import numpy as np
import pytest
import torch

import dtown_torch
from dtown_torch.render import row_raster as rr

B, S = 8, 32
CASES = {
    "k3": ("loop_obstacles", {}, True),
    "k3_fisheye": ("loop_obstacles", dict(distortion=True), True),
    "k4": ("bigtown", {}, False),
    "k4_dr": ("udem1", dict(domain_rand=True), False),
    "k4_fisheye": ("bigtown", dict(distortion=True), False),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _posed(states, maps, seed):
    """The states with env b at 0.3-0.8 m from live object b % n_live,
    facing it (even b) or turned away from it (odd b)."""
    rng = np.random.default_rng(seed)
    live = torch.nonzero(maps.obj_mask).flatten()
    i = live[torch.arange(B) % len(live)]
    opos = states.dyn.pos[torch.arange(B), i]
    a = torch.as_tensor(rng.uniform(-math.pi, math.pi, B), dtype=torch.float32)
    d = torch.as_tensor(rng.uniform(0.3, 0.8, B), dtype=torch.float32)
    pos = states.pos.clone()
    pos[:, 0] = opos[:, 0] - d * torch.cos(a)
    pos[:, 2] = opos[:, 2] + d * torch.sin(a)
    angle = torch.where(torch.arange(B) % 2 == 0, a, a + math.pi)
    return states.replace(pos=pos, angle=angle)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    name, kw, static = CASES[request.param]
    cfg, maps, v_reset, v_step = dtown_torch.make_vec(
        name, B, device="cpu", renderer="pallas", camera_width=S,
        camera_height=S, **kw)
    pk = v_step.pack
    assert pk["static"] == static, request.param
    states = _posed(v_reset(torch.Generator().manual_seed(3)), maps, 4)
    rows = rr.prepare_rows(cfg, maps, states, pk)
    return request.param, cfg, maps, pk, rows


def _render(rows, pk):
    if pk["static"]:
        return rr.render_frames_static_reference(*rows, pk)
    return rr.render_frames_rows_reference(*rows, pk)


def _env(rows, e):
    return [r[e:e + 1].clone() for r in rows]


def _only(rows, pk, keep):
    """One env's rows with every object outside ``keep`` (bool [n]) culled:
    its cull flag (K3) or active flag (K4) off."""
    rows = [r.clone() for r in rows]
    if pk["static"]:
        rows[2][0, 0:2 * pk["n_objs"]:2] *= keep.to(torch.float32)
    else:
        obj = rows[2].view(1, -1, rr.OBJ_F)
        obj[0, :, 7] *= keep.to(torch.float32)
    return rows


def test_sphere_test_rejects_no_hit(case):
    """Each kept object alone in the scene leaves the bytes of the empty
    scene on every pixel whose ray the bounding-sphere test rejects; the
    test rejects pixels and keeps the object's own."""
    tag, _, _, pk, rows = case
    kept = rr.row_kept(rows, pk)
    passed = rr.row_sphere_pass(rows, pk)
    n_rejected = n_changed = n_kept_px = 0
    for e in range(B):
        one = _env(rows, e)
        none = torch.zeros_like(kept[e])
        empty = _render(_only(one, pk, none), pk)[0]
        for o in torch.nonzero(kept[e]).flatten().tolist():
            only = none.clone()
            only[o] = True
            img = _render(_only(one, pk, only), pk)[0]
            changed = (img != empty).any(0).reshape(-1)
            rejected = ~passed[e, o]
            assert not bool((changed & rejected).any()), (tag, e, o)
            n_rejected += int(rejected.sum())
            n_changed += int(changed.sum())
            n_kept_px += rejected.numel()
    assert n_changed > 0 and n_rejected > 0, tag
    # most rays miss most kept objects
    assert n_rejected > 0.5 * n_kept_px, (tag, n_rejected, n_kept_px)


def _prim_extents(rows, pk):
    """Per env and object the real primitives' farthest model-space reach
    (float64 [B, n]: the largest |c + corner| of a box, |c| + r of a
    sphere) and the object scale [B, n]; K4's padded slots (zero extents)
    are not real primitives."""
    corners = np.array(list(itertools.product((-1, 1), repeat=3)), float)

    def reach(is_box, c, p):
        if is_box:
            return float(np.linalg.norm(c + corners * p, axis=1).max())
        return float(np.linalg.norm(c)) + p[0]

    if pk["static"]:
        sof = pk["sof"].double().numpy()
        soi, spi = pk["soi"].numpy(), pk["spi"].numpy()
        spf = pk["spf"].double().numpy()
        far = []
        for o in range(pk["n_objs"]):
            j0, n_p = soi[o]
            far.append(max(reach(spi[j, rr.SPI_BOX], spf[j, rr.SP_CX:
                                                         rr.SP_CZ + 1],
                                 spf[j, rr.SP_P0:rr.SP_P2 + 1])
                           for j in range(j0, j0 + n_p)))
        far = np.tile(np.array(far), (B, 1))
        scale = np.tile(sof[:pk["n_objs"], rr.SO_SC], (B, 1))
        return far, scale
    obj = rows[2].double().reshape(B, -1, rr.OBJ_F).numpy()
    prim = rows[3].double().reshape(B, obj.shape[1], rr.P_MAX,
                                    rr.PRIM_F).numpy()
    far = np.zeros(obj.shape[:2])
    for e, o, q in np.ndindex(B, obj.shape[1], rr.P_MAX):
        pv = prim[e, o, q]
        if (pv[4:7] > 0).any():
            far[e, o] = max(far[e, o], reach(pv[0] > 0.5, pv[1:4], pv[4:7]))
    return far, obj[..., 6]


def test_bounding_spheres_hold_every_primitive(case):
    """Every kept object's sphere, centred on its position, reaches past
    its farthest real primitive by at least half VIEW_PAD (the margin for
    float32 rounding); its radius is positive, so it holds the model
    origin, where K4's padded slots sit."""
    tag, _, _, pk, rows = case
    kept = rr.row_kept(rows, pk)
    centre, rb = rr.row_bound_spheres(rows, pk)
    far, scale = _prim_extents(rows, pk)
    rb = rb.double().numpy()
    k = kept.numpy()
    assert k.any(), tag
    assert (rb[k] - far[k] * scale[k] >= 0.5 * rr.VIEW_PAD).all(), tag
    assert (rb[k] > 0).all() and (far[k] > 0).all(), tag
    if pk["static"]:
        torch.testing.assert_close(
            centre[0], pk["sof"][:pk["n_objs"], rr.SO_X:rr.SO_Z + 1],
            rtol=0, atol=0)
    else:
        torch.testing.assert_close(
            centre, rows[2].reshape(B, -1, rr.OBJ_F)[..., 0:3], rtol=0,
            atol=0)


def _dropped(one, pk, keep, cfg, maps):
    """One env's rows and pack with the objects outside ``keep`` removed,
    the kept ones in walk order: K3 a scene table of the kept objects, K4
    the kept rows first and inactive zero rows after."""
    if pk["static"]:
        scene = [ob for ob, k in zip(rr._build_static_scene(cfg, maps), keep)
                 if k]
        tabs = [torch.as_tensor(t) for t in rr.pack_static_scene(scene)]
        pk2 = dict(pk, n_objs=len(scene),
                   **dict(zip(("sof", "soi", "spf", "spi"), tabs)))
        flags = one[2][0, :2 * pk["n_objs"]].view(-1, 2)[keep].reshape(1, -1)
        if not len(scene):
            flags = torch.zeros((1, 2))
        return [one[0], one[1], flags], pk2
    kv = keep.numel()
    obj = one[2].view(kv, rr.OBJ_F)
    prim = one[3].view(kv, rr.P_MAX * rr.PRIM_F)
    o2, p2 = torch.zeros_like(obj), torch.zeros_like(prim)
    n = int(keep.sum())
    o2[:n], p2[:n] = obj[keep], prim[keep]
    return [one[0], one[1], o2.reshape(1, -1), p2.reshape(1, -1)], pk


def test_dropping_rejected_objects_leaves_bytes_equal(case):
    tag, cfg, maps, pk, rows = case
    full = _render(rows, pk)
    kept = rr.row_kept(rows, pk)
    for e in range(B):
        one, pk2 = _dropped(_env(rows, e), pk, kept[e], cfg, maps)
        assert torch.equal(_render(one, pk2)[0], full[e]), (tag, e)
    # every env facing its object keeps something
    assert bool(kept[0::2].any(1).all()), tag
