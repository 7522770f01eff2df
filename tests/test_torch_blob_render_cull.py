"""The blob render kernel's culls, mirrored in plain torch: its keep
predicate (the per-block prologue of csrc/blob_render.cu; blob_raster.kept
and blob_raster.compact) and its per-pixel bounding-sphere test
(blob_raster.sphere_pass). Dropping the objects the predicate rejects from
an env leaves the plain render's bytes equal, its compacted list keeps
plan order, and an object alone in the scene changes no pixel whose ray
the sphere test rejects. The view cull in the predicate (every object
wholly behind the camera's forward half-plane) is on only when pack_plan
finds every ray of the frame facing forward.
Cases at 32x32 with 8 envs: the driver config, moving NPCs, domain
randomization, fisheye, a stack with NPCs and domain randomization, and a
triangle mesh; half the envs face an object from 0.3-0.8 m, half turn
their back to it. chip_smoke.py holds the kernel against the plain
version on the card (max |diff| 0)."""
import math

import numpy as np
import pytest
import torch

import dtown_torch
from dtown_torch import EnvConfig, make_fused_rollout, map_loader
from dtown_torch.ops import state_kernel as sk
from dtown_torch.render import blob_raster as br

from test_objmesh import _write_sample
from test_torch_objmesh import register_sample_kinds

B, S = 8, 32
KIND = "duckhouse_torch_cull"
CASES = {
    "driver": ("loop_obstacles", {}),
    "npc": ("town_dyn_duckiebots", {}),
    "dr": ("udem1", dict(domain_rand=True)),
    "fisheye": ("loop_obstacles", dict(distortion=True)),
    "stack": (["town_dyn_duckiebots", "udem1"], dict(domain_rand=True)),
    "tri_mesh": ("tri", dict(mesh_fidelity="triangles")),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def registered_tri_map(tmp_dir):
    """loop_obstacles with the sample mesh of tests/test_objmesh.py inside
    the loop, registered as KIND in both packages (the kinds that other
    test files of this process registered in dtown first, so the two kind
    lists stay aligned). A generator: it yields the compiled map, then
    puts every registry back as it was (a kind left registered would make
    a later test of this process, tests/test_native.py's bake of the
    shipped kinds, see one kind too many)."""
    import yaml

    restore = register_sample_kinds(_write_sample(tmp_dir), KIND)
    try:
        with open(f"{map_loader.MAPS_DIR}/loop_obstacles.yaml") as f:
            data = yaml.safe_load(f)
        data["objects"].append({"kind": KIND, "pos": [1.5, 1.5],
                                "rotate": 90, "height": 0.2,
                                "static": True})
        yield map_loader.compile_map(data)
    finally:
        restore()


@pytest.fixture(scope="module")
def tri_map(tmp_path_factory):
    yield from registered_tri_map(tmp_path_factory.mktemp("cull"))


def _posed(blob, pk, seed):
    """The envs' blob with env e at 0.3-0.8 m from object e % n_objs,
    facing it (even e) or turned away from it (odd e)."""
    blob = blob.clone()
    rng = np.random.default_rng(seed)
    of, oi = pk["of"], pk["oi"]
    for e in range(B):
        o = e % pk["n_objs"]
        npc = int(oi[o, br.OI_NPC])
        if npc >= 0:
            base = sk.F_NPC_BASE + sk.NPC_ROWS * npc
            tx, tz = float(blob[base, e]), float(blob[base + 1, e])
        else:
            tx, tz = float(of[o, br.O_X]), float(of[o, br.O_Z])
        a = rng.uniform(-math.pi, math.pi)
        d = rng.uniform(0.3, 0.8)
        blob[sk.F_POS_X, e] = tx - d * math.cos(a)
        blob[sk.F_POS_Z, e] = tz + d * math.sin(a)
        blob[sk.F_ANGLE, e] = a if e % 2 == 0 else a + math.pi
        if pk["n_maps"] > 1 and npc < 0:
            blob[sk.F_MAPID, e] = float(oi[o, br.OI_MAP])
    return blob


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, tri_map):
    spec, kw = CASES[request.param]
    if spec == "tri":
        maps = tri_map
    elif isinstance(spec, list):
        maps = dtown_torch.stack_maps(spec)
    else:
        maps = dtown_torch.load_map(spec)
    cfg = EnvConfig(camera_width=S, camera_height=S, **kw)
    init_blob, fused_step, _ = make_fused_rollout(cfg, maps, B, device="cpu")
    pk = fused_step.pack
    blob = _posed(init_blob(torch.Generator().manual_seed(3)), pk, 4)
    return request.param, pk, blob


def _without(pk, keep_o, keep_p):
    """pk with every object and primitive outside the keep masks (of one
    env) culled for the plain version: the object's and its primitives'
    cull distances below any distance."""
    of, pf, pi = pk["of"].clone(), pk["pf"].clone(), pk["pi"].clone()
    of[:pk["n_objs"]][~keep_o, br.O_CULL2] = -1.0
    drop = torch.nonzero(~keep_p).flatten()
    pi[drop, br.PI_OWN] = 1
    pf[drop, br.P_CD2] = -1.0
    return dict(pk, of=of, pf=pf, pi=pi)


def test_dropping_rejected_objects_leaves_bytes_equal(case):
    tag, pk, blob = case
    assert pk["view"], tag
    full = br.render_frames_reference(blob, pk)
    keep_o, keep_p = br.kept(blob, pk)
    for e in range(B):
        one = br.render_frames_reference(
            blob[:, e:e + 1].contiguous(),
            _without(pk, keep_o[e], keep_p[e, :pk["pi"].shape[0]]))
        assert torch.equal(one[0], full[e]), (tag, e)
    # the view cull rejected objects that every other cull keeps
    no_view = dict(pk, view=False)
    keep_nv, _ = br.kept(blob, no_view)
    assert int((keep_nv & ~keep_o).sum()) > 0, tag
    # and every env facing its object keeps something
    assert bool(keep_o[0::2].any(1).all()), tag


def test_compacted_list_keeps_plan_order(case):
    tag, pk, blob = case
    oi = pk["oi"]
    keep_o, keep_p = br.kept(blob, pk)
    for e, (objs, prims, ends) in enumerate(br.compact(blob, pk)):
        assert objs == sorted(objs) and len(set(objs)) == len(objs)
        assert objs == torch.nonzero(keep_o[e]).flatten().tolist()
        assert prims == torch.nonzero(keep_p[e]).flatten().tolist()
        start = 0
        for o, end in zip(objs, ends):
            p0, n_p = int(oi[o, br.OI_P0]), int(oi[o, br.OI_NP])
            assert p0 <= min(prims[start:end]) and max(
                prims[start:end]) < p0 + n_p and end > start
            start = end
        assert start == len(prims)


def test_sphere_test_rejects_no_hit(case):
    """Each kept object alone in the scene (the others culled) leaves the
    bytes of the empty scene on every pixel whose ray the bounding-sphere
    test rejects; the test rejects most pixels and keeps the object's own."""
    tag, pk, blob = case
    keep_o, keep_p = br.kept(blob, pk)
    passed = br.sphere_pass(blob, pk)
    n_p = pk["pi"].shape[0]
    none = torch.zeros(n_p, dtype=torch.bool)
    n_rejected = n_changed = 0
    for e in range(B):
        one = blob[:, e:e + 1].contiguous()
        empty = br.render_frames_reference(
            one, _without(pk, torch.zeros_like(keep_o[e]), none))[0]
        for o in torch.nonzero(keep_o[e]).flatten().tolist():
            only = torch.zeros_like(keep_o[e])
            only[o] = True
            p0 = int(pk["oi"][o, br.OI_P0])
            prims = none.clone()
            prims[p0:p0 + int(pk["oi"][o, br.OI_NP])] = True
            img = br.render_frames_reference(
                one, _without(pk, only, prims & keep_p[e, :n_p]))[0]
            changed = (img != empty).any(0).reshape(-1)
            rejected = ~passed[e, o]
            assert not bool((changed & rejected).any()), (tag, e, o)
            n_rejected += int(rejected.sum())
            n_changed += int(changed.sum())
    assert n_changed > 0 and n_rejected > 0, tag
    assert float((~passed[keep_o]).float().mean()) > 0.5, tag


def test_view_cull_off_when_rays_reach_behind():
    """A camera pitched 80 degrees down sees behind its own feet (the
    lower rays' horizontal component points backwards): pack_plan turns
    the view cull off, and kept() culls no static object by view."""
    cfg = EnvConfig(camera_width=S, camera_height=S)
    maps = dtown_torch.load_map("loop_obstacles")
    plan = br.build_render_plan(cfg, maps)
    assert br.pack_plan(cfg, plan, "cpu")["view"]
    steep = dict(plan, sin_pitch=math.sin(math.radians(80.0)),
                 cos_pitch=math.cos(math.radians(80.0)))
    assert not br.rays_face_forward(cfg, steep)
    pk = br.pack_plan(cfg, steep, "cpu")
    assert not pk["view"]
    assert float(pk["scene"][br._SCENE_NAMES.index("view_cull")]) == 0.0
    blob = torch.zeros((pk["nf"], 2))
    blob[sk.F_POS_X] = float(pk["of"][0, br.O_X]) + 0.5
    blob[sk.F_POS_Z] = float(pk["of"][0, br.O_Z])
    blob[sk.F_ANGLE, 1] = math.pi          # env 1 turns its back
    keep_o, _ = br.kept(blob, pk)
    assert bool(keep_o[:, 0].all())


@pytest.mark.parametrize("kw", [dict(), dict(distortion=True)])
def test_view_cull_under_domain_randomization(kw):
    """Under domain randomization the check covers every draw of the fov
    and pitch ranges: on at the redraw ranges, off when a pitch range
    reaches 80 degrees down."""
    cfg = EnvConfig(camera_width=S, camera_height=S, domain_rand=True, **kw)
    plan = br.build_render_plan(cfg, dtown_torch.load_map("udem1"))
    assert br.rays_face_forward(cfg, plan)
    assert br.pack_plan(cfg, plan, "cpu")["view"]
    assert not br.rays_face_forward(cfg, plan,
                                    dr_ranges=((37.0, 47.0), (16.0, 80.0)))
