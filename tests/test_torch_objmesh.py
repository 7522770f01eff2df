"""dtown_torch's OBJ meshes (render/objmesh.py) and the blob render's
triangle primitives vs the JAX package, on tests/test_objmesh.py's sample
mesh (two quads and a roof triangle), registered in both packages under a
name of this file's own: the parsed mesh, its triangle buffer and boxes,
the registered kind (id, footprint, primitive table row, triangles), the
triangle-fidelity render plan; the plain K2 against dtown's interpret-mode
kernel on test_objmesh.py's scene at 64x64 (the blob from dtown's reset
with its start pose) at
test_torch_blob_render.py's bars (mean |diff| < 1, at most 1% of values
off by more than 10); a fused rollout with triangles against dtown's,
blob for blob; and the step path, which renders the kind as its boxes on
both sides, against dtown's render_frames_pallas at
test_torch_row_render.py's bars. The CUDA kernel is held against the same
plain version on the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dtown import assets as jassets
from dtown import env as jenv
from dtown import map_loader as jmap_loader
from dtown import types as jtypes
from dtown.ops.fused_env import make_fused_rollout as j_make_fused_rollout
from dtown.ops.fused_env import pack_blob as j_pack_blob
from dtown.render import blob_raster as jbr
from dtown.render import meshes as jmeshes
from dtown.render import objmesh as jobj
from dtown.render import pallas_raster as jpr

import dtown_torch
from dtown_torch import EnvConfig, assets, make_fused_rollout
from dtown_torch import map_loader, types as T
from dtown_torch.convert import blob_from_numpy, env_states_from_numpy
from dtown_torch.render import blob_raster as br
from dtown_torch.render import meshes, objmesh
from dtown_torch.render import row_raster as rr

from test_objmesh import _write_sample
from test_torch_blob_render_npc import B, posed_blob
from test_torch_row_render import _posed_states
from test_torch_state_npc import check_rows

KIND = "duckhouse_torch_objmesh"
MEAN_BAR, SHARE_BAR = 1.0, 0.01


def _scene(kind):
    # tests/test_objmesh.py's scene: the wall quads face the camera
    return {
        "tiles": [["straight/W", "straight/W", "straight/W"]],
        "objects": [{"kind": kind, "pos": [1.0, 0.3], "rotate": 90,
                     "height": 0.1, "static": True}],
        "tile_size": 0.585,
    }


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _registries():
    """Every process-global registry that register_custom_object mutates,
    in both packages: (container, prim_tables cache owner) pairs."""
    return [(jtypes.OBJ_KINDS, jmeshes), (jtypes.OBJ_KIND_IDS, jmeshes),
            (jassets.OBJECT_DIMS, jmeshes), (jmeshes._PRIMS, jmeshes),
            (jmeshes.TRI_MESHES, jmeshes), (T.OBJ_KINDS, meshes),
            (T.OBJ_KIND_IDS, meshes), (assets.OBJECT_DIMS, meshes),
            (meshes._PRIMS, meshes), (meshes.TRI_MESHES, meshes)]


def register_sample_kinds(path, kind=KIND):
    """Register the sample mesh at ``path`` as ``kind`` in both packages, the
    kinds that other test files of this process registered in dtown in
    the port first (so that the two kind lists stay aligned). Returns
    restore(), which puts every registry back as it was, in place (other
    modules hold references to these lists and dicts), and clears both
    packages' cached primitive tables: a kind left registered would make
    a later test of this process (tests/test_native.py's bake of the
    shipped kinds) see one kind too many."""
    saved = [(c, list(c) if isinstance(c, list) else dict(c))
             for c, _ in _registries()]

    def restore():
        for c, old in saved:
            if isinstance(c, list):
                c[:] = old
            else:
                c.clear()
                c.update(old)
        jmeshes.prim_tables.cache_clear()
        meshes.prim_tables.cache_clear()

    for k in jtypes.OBJ_KINDS[len(T.OBJ_KINDS):]:
        if k != kind:
            objmesh.register_custom_object(k, path)
    jobj.register_custom_object(kind, path)
    dtown_torch.register_custom_object(kind, path)
    return restore


@pytest.fixture(scope="module")
def mesh_path(tmp_path_factory):
    """The sample mesh registered as KIND in both packages for this
    module; every registry is restored at the module's teardown."""
    path = _write_sample(tmp_path_factory.mktemp("objmesh"))
    restore = register_sample_kinds(path)
    yield path
    restore()


@pytest.fixture(scope="module")
def maps(mesh_path):
    return jmap_loader.compile_map(_scene(KIND)), map_loader.compile_map(
        _scene(KIND))


def test_objmesh_parse_matches_reference(mesh_path):
    ours, ref = objmesh.ObjMesh.get(mesh_path), jobj.ObjMesh.get(mesh_path)
    assert objmesh.ObjMesh.get(mesh_path) is ours
    for name in ("verts", "min_coords", "max_coords", "triangles",
                 "tri_colors"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(ref, name))
    assert len(ours.group_boxes) == len(ref.group_boxes) == 2
    for bo, br_ in zip(ours.group_boxes, ref.group_boxes):
        for a, b in zip(bo, br_):
            np.testing.assert_array_equal(a, b)
    for n in (64, 16, 3):
        for a, b in zip(ours.to_triangles(n), ref.to_triangles(n)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    assert ours.to_prims() == ref.to_prims()
    assert ours.to_prims(1) == ref.to_prims(1)


def test_register_custom_object_matches_reference(mesh_path):
    kid = T.OBJ_KIND_IDS[KIND]
    assert kid == jtypes.OBJ_KIND_IDS[KIND] and T.OBJ_KINDS[kid] == KIND
    assert T.OBJ_KINDS == jtypes.OBJ_KINDS
    assert assets.OBJECT_DIMS[KIND] == jassets.OBJECT_DIMS[KIND]
    ours, ref = meshes.prim_tables(), jmeshes.prim_tables()
    for name in ref:
        np.testing.assert_array_equal(ours[name][kid], ref[name][kid])
    assert ours["mask"][kid].any()
    for a, b in zip(meshes.TRI_MESHES[KIND], jmeshes.TRI_MESHES[KIND]):
        np.testing.assert_array_equal(a, b)


def test_triangle_plan_matches_reference(maps):
    jmaps, tmaps = maps
    kw = dict(camera_width=32, camera_height=32, mesh_fidelity="triangles")
    plan = br.build_render_plan(EnvConfig(**kw), tmaps)
    assert plan == jbr.build_render_plan(jtypes.EnvConfig(**kw), jmaps)
    tris = [p for ob in plan["objs"] for p in ob["prims"] if p.get("is_tri")]
    assert len(tris) == 5          # the sample's 5 faces, within budget 8
    ob = plan["objs"][0]
    assert br._bound_radius(ob) == jbr._bound_radius(ob)
    pk = br.pack_plan(EnvConfig(**kw), plan, "cpu")
    assert pk["tri"] and int(pk["oi"][0, br.OI_MODEL]) == 1
    assert (pk["pi"][:, br.PI_TYPE] == br.TRI_T).sum() == 5
    boxes = br.build_render_plan(EnvConfig(camera_width=32,
                                           camera_height=32), tmaps)
    assert not any(p.get("is_tri") for ob in boxes["objs"]
                   for p in ob["prims"])


def test_triangle_render_matches_pallas_interpret(maps):
    """tests/test_objmesh.py::test_triangle_fidelity_fused_matches_xla's
    scene: 8 envs at the start pose (0.3, 0.15, 0) facing the mesh."""
    jmaps, tmaps = maps
    kw = dict(obs_type="rgb", camera_width=64, camera_height=64,
              auto_reset=False)
    jcfg = jtypes.EnvConfig(start_pose=(0.3, 0.15, 0.0),
                            mesh_fidelity="triangles", **kw)
    keys = jax.random.split(jax.random.PRNGKey(6), B)
    idx = jnp.zeros((B,), jnp.int32)
    states = jax.vmap(lambda k, i: jenv.reset(jcfg, jmaps, k, i))(keys, idx)
    blob = np.asarray(j_pack_blob(states, jmaps))
    jplan = jbr.build_render_plan(jcfg, jmaps)
    ref = np.asarray(jax.jit(lambda b: jbr.render_frames_from_blob(
        jcfg, jmaps, b, jplan, interpret=True))(blob)).astype(int)
    cfg = EnvConfig(mesh_fidelity="triangles", **kw)
    pk = br.pack_plan(cfg, br.build_render_plan(cfg, tmaps), "cpu")
    ours = br.render_frames_from_blob(blob_from_numpy(blob, device="cpu"), pk)
    ours = ours.numpy().astype(int)
    assert ours.shape == ref.shape == (B, 3, 32, 128)
    diff = np.abs(ours - ref)
    assert diff.mean() < MEAN_BAR, diff.mean()
    assert (diff > 10).mean() < SHARE_BAR
    # the triangles, not the boxes, drew the mesh: the red roof shows
    cfg_b = EnvConfig(**kw)
    pk_b = br.pack_plan(cfg_b, br.build_render_plan(cfg_b, tmaps), "cpu")
    boxes = br.render_frames_from_blob(blob_from_numpy(blob, device="cpu"),
                                       pk_b).numpy()
    assert (boxes.astype(int) != ours).mean() > 0.005
    r, g, b = (ours[0, c].reshape(-1) for c in range(3))
    assert ((r > 90) & (r > 1.5 * g) & (r > 1.5 * b)).sum() > 3


def test_fused_rollout_triangles_matches_reference(maps):
    """make_fused_rollout with mesh_fidelity="triangles" from dtown's
    initial blob (half the envs facing the mesh), 3 steps, both sides."""
    jmaps, tmaps = maps
    kw = dict(camera_width=32, camera_height=32, mesh_fidelity="triangles",
              max_steps=2)
    jcfg, cfg = jtypes.EnvConfig(**kw), EnvConfig(**kw)
    target = tuple(np.asarray(jmaps.obj_pos)[0, [0, 2]])
    blob_j = jnp.asarray(posed_blob(jcfg, jmaps, [target], seed=7))
    _, j_step, _ = j_make_fused_rollout(jcfg, jmaps, B)
    step_j = jax.jit(lambda b, a: j_step(b, None, a))
    _, t_step, _ = make_fused_rollout(cfg, tmaps, B, device="cpu")
    assert t_step.pack["tri"]
    blob_t = blob_from_numpy(np.asarray(blob_j), device="cpu")
    rng = np.random.default_rng(9)
    for _ in range(3):
        act = np.stack([rng.uniform(0.0, 0.3, B),
                        rng.uniform(-0.3, 0.3, B)], -1).astype(np.float32)
        blob_j, _, obs_j = step_j(blob_j, jnp.asarray(act))
        blob_t, _, obs_t = t_step(blob_t, torch.from_numpy(act))
        check_rows(np.asarray(blob_j), blob_t.numpy())
        ours, ref = obs_t.numpy().astype(int), np.asarray(obs_j).astype(int)
        diff = np.abs(ours - ref)
        assert diff.mean() < MEAN_BAR, diff.mean()
        assert (diff > 10).mean() < SHARE_BAR
        assert ours.std() > 5


def test_step_path_renders_registered_kind_as_boxes(maps):
    """The row-fed render (K3 here: one static object) draws the kind's
    material boxes whatever mesh_fidelity says, as dtown's does."""
    jmaps, tmaps = maps
    kw = dict(camera_width=32, camera_height=32, renderer="pallas",
              mesh_fidelity="triangles")
    jcfg, cfg = jtypes.EnvConfig(**kw), EnvConfig(**kw)
    tmaps = tmaps.to("cpu")
    sj = _posed_states(jcfg, jmaps, 3)
    ref = np.asarray(jax.jit(lambda s: jpr.render_frames_pallas(
        jcfg, jmaps, s, interpret=True))(sj)).astype(int)
    pk = rr.pack_row_scene(cfg, tmaps)
    assert pk["static"] and pk["n_objs"] == 1
    ours = rr.render_frames_rows(
        cfg, tmaps, env_states_from_numpy(sj, device="cpu"),
        pack=pk).numpy().astype(int)
    assert ours.shape == ref.shape == (B, 3, 8, 128)
    diff = np.abs(ours - ref)
    assert diff.mean() <= 0.05, diff.mean()
    assert (diff > 2).mean() <= 1e-3
    # the object is in the frames: culled in every env, they differ
    cam, words, flags = rr.prepare_rows(
        cfg, tmaps, env_states_from_numpy(sj, device="cpu"), pk)
    assert (flags[:, 0] > 0.5).any()
    bare = rr.row_render_static(cam, words, torch.zeros_like(flags), pk)
    assert (bare.numpy().astype(int) != ours).any()
