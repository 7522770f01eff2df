"""Object kinds registered by a test stay inside it: the registrations
that the module fixtures of tests/test_torch_objmesh.py and
tests/test_torch_blob_render_cull.py make in both packages
(dtown.types.OBJ_KINDS / OBJ_KIND_IDS, dtown.assets.OBJECT_DIMS,
dtown.render.meshes._PRIMS / TRI_MESHES and the port's counterparts) is
undone at its teardown, with both primitive-table caches cleared, so a
later test of the same process sees the shipped kinds only (dtown's
native bake, tests/test_native.py, compares their count)."""
from dtown import assets as jassets
from dtown import types as jtypes
from dtown.render import meshes as jmeshes

from dtown_torch import assets, types as T
from dtown_torch.render import meshes

from test_objmesh import _write_sample
from test_torch_blob_render_cull import KIND as CULL_KIND
from test_torch_blob_render_cull import registered_tri_map
from test_torch_objmesh import KIND, register_sample_kinds


def _state():
    return (list(jtypes.OBJ_KINDS), dict(jtypes.OBJ_KIND_IDS),
            sorted(jassets.OBJECT_DIMS), sorted(jmeshes._PRIMS),
            sorted(jmeshes.TRI_MESHES), list(T.OBJ_KINDS),
            dict(T.OBJ_KIND_IDS), sorted(assets.OBJECT_DIMS),
            sorted(meshes._PRIMS), sorted(meshes.TRI_MESHES))


def test_registration_is_undone_at_teardown(tmp_path):
    before = _state()
    n_before = jmeshes.prim_tables()["type"].shape[0]
    assert n_before == len(jtypes.OBJ_KINDS)
    restore = register_sample_kinds(_write_sample(tmp_path))
    try:
        assert KIND in jtypes.OBJ_KIND_IDS and KIND in T.OBJ_KIND_IDS
        assert jmeshes.prim_tables()["type"].shape[0] == n_before + \
            (len(jtypes.OBJ_KINDS) - len(before[0]))
        assert meshes.prim_tables()["type"].shape[0] == len(T.OBJ_KINDS)
    finally:
        restore()
    assert _state() == before
    assert jmeshes.prim_tables()["type"].shape[0] == len(jtypes.OBJ_KINDS) \
        == n_before
    assert meshes.prim_tables()["type"].shape[0] == len(T.OBJ_KINDS)
    assert KIND not in jmeshes.TRI_MESHES and KIND not in meshes.TRI_MESHES



def test_cull_fixture_registration_is_undone(tmp_path):
    """The blob render cull tests' map (their module fixture tri_map)
    registers its own kind and places it; closing the fixture's generator,
    as pytest does at the module's teardown, restores every registry."""
    before = _state()
    n_before = jmeshes.prim_tables()["type"].shape[0]
    gen = registered_tri_map(tmp_path)
    maps = next(gen)
    assert CULL_KIND in jtypes.OBJ_KIND_IDS and CULL_KIND in T.OBJ_KIND_IDS
    assert T.OBJ_KIND_IDS[CULL_KIND] in set(maps.obj_kind[maps.obj_mask])
    assert meshes.prim_tables()["type"].shape[0] == len(T.OBJ_KINDS)
    gen.close()
    assert _state() == before
    assert jmeshes.prim_tables()["type"].shape[0] == len(jtypes.OBJ_KINDS) \
        == n_before
    assert meshes.prim_tables()["type"].shape[0] == len(T.OBJ_KINDS)
    assert CULL_KIND not in jmeshes.TRI_MESHES
    assert CULL_KIND not in meshes.TRI_MESHES
