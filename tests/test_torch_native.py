"""The port's binding to the C++ map compiler (dtown_torch.native) against
the port's python compiler, at tests/test_native.py's bars: tiles, curves
and objects bit for bit (curves and object floats 1e-6), the spawn bank
property-checked, the prim tables and the per-object scene bake equal to
the render plan's. Then the binding's refusals: a failed build and an
ABI mismatch raise, and building never touches native/libdtown_mapc.so.
"""
import hashlib
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dtown_torch import map_loader, native, physics
from dtown_torch.geometry import get_lane_pos2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAPS = ["small_loop", "udem1", "loop_obstacles", "4way", "zigzag_dists",
        "loop_pedestrians", "straight_road"]


@pytest.fixture(scope="module", autouse=True)
def _built():
    if native.cxx() is None:
        pytest.skip("g++ not installed: the native map compiler cannot "
                    "be built")
    native.build_library()
    assert native.available()


def _path(name):
    return os.path.join(map_loader.MAPS_DIR, f"{name}.yaml")


@pytest.mark.parametrize("name", MAPS)
def test_native_matches_python(name):
    from dtown_torch.render.blob_raster import pack_tile_words

    nat = native.compile_map_native(_path(name))
    py = map_loader.load_map(name)
    np.testing.assert_array_equal(nat["tile_kind"], py.tile_kind)
    np.testing.assert_array_equal(nat["tile_angle"], py.tile_angle)
    np.testing.assert_array_equal(nat["drivable"], py.drivable)
    np.testing.assert_array_equal(nat["curve_mask"], py.curve_mask)
    np.testing.assert_allclose(nat["curves"], py.curves, atol=1e-6)
    # real object slots only (the python compiler pads scale with 1 and
    # identity norms, the native one with zeros)
    M = int(nat["n_objects"])
    for f, pyf in [
        ("obj_pos", py.obj_pos), ("obj_y_rot", py.obj_y_rot),
        ("obj_scale", py.obj_scale), ("obj_corners", py.obj_corners),
        ("obj_norms", py.obj_norms), ("obj_safety_rad", py.obj_safety_rad),
        ("obj_halfdims", py.obj_halfdims), ("obj_height", py.obj_height),
        ("obj_walk_dist", py.obj_walk_dist),
    ]:
        np.testing.assert_allclose(nat[f][:M], np.asarray(pyf)[:M],
                                   atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(nat["obj_kind"][:M], py.obj_kind[:M])
    np.testing.assert_array_equal(nat["obj_dynamic"][:M],
                                  py.obj_is_dynamic[:M])
    words_py = pack_tile_words(py.tile_kind, py.tile_angle)
    assert nat["n_words"] == len(words_py)
    np.testing.assert_array_equal(
        nat["tile_words"], np.asarray(words_py, np.int64).astype(np.int32))


@pytest.mark.parametrize("name", ["small_loop", "udem1"])
def test_native_spawn_bank_properties(name):
    """Every native bank pose passes the port's acceptance test (32 poses
    across the bank, as one batch)."""
    nat = native.compile_map_native(_path(name))
    maps = map_loader.load_map(name).to("cpu")
    assert nat["spawn_mask"].all()
    deg = np.abs(nat["spawn_lane_deg"])
    assert (np.diff(deg) >= -1e-9).all()             # sorted by |angle|

    sel = np.linspace(0, 2047, 32).astype(int)
    pos = torch.as_tensor(nat["spawn_pos"][sel], dtype=torch.float32)
    ang = torch.as_tensor(nat["spawn_angle"][sel], dtype=torch.float32)
    active = maps.obj_mask.expand(len(sel), -1)
    valid, _ = physics.valid_pose(maps, pos, ang, maps.obj_corners,
                                  maps.obj_norms, active, safety_factor=1.3)
    assert bool(valid.all()), sel[~valid.numpy()]
    lp = get_lane_pos2(maps, pos, ang)
    assert bool(lp.in_lane.all())
    np.testing.assert_array_less(
        np.abs(lp.angle_deg.numpy() - nat["spawn_lane_deg"][sel]), 0.5)


def test_native_prim_tables_match_meshes():
    """The native prim bake (mapc.cpp::kind_prims) equals the port's
    render tables (render/meshes.py::prim_tables) over the 21 built-in
    kinds, float for float in float32."""
    from dtown_torch.render import meshes

    nat = native.prim_tables_native()
    py = {k: v[:native.N_OBJ_KINDS] for k, v in meshes.prim_tables().items()}
    for f in ("type", "mask", "phase"):
        np.testing.assert_array_equal(nat[f], py[f], err_msg=f)
    for f in ("center", "param", "color"):
        np.testing.assert_array_equal(nat[f].astype(np.float32), py[f],
                                      err_msg=f)


@pytest.mark.parametrize("name", ["udem1", "loop_obstacles", "4way"])
def test_native_scene_bake_matches_render_plan(name):
    """Per-object sin/cos, model-space light and bound radius baked
    natively equal what blob_raster.build_render_plan computes (the max
    bound over a slot's LOD pseudo-objects)."""
    from dtown_torch.render.blob_raster import _bound_radius, \
        build_render_plan
    from dtown_torch.types import EnvConfig

    nat = native.compile_map_native(_path(name))
    plan = build_render_plan(EnvConfig(obs_type="rgb"),
                             map_loader.load_map(name))
    assert plan is not None and plan["objs"]
    by_slot = {}
    for ob in plan["objs"]:
        by_slot.setdefault(ob["slot"], []).append(ob)
    for s, obs_s in by_slot.items():
        ob = obs_s[0]
        assert abs(nat["obj_sincos"][s, 0] - ob["s_r"]) < 1e-15
        assert abs(nat["obj_sincos"][s, 1] - ob["c_r"]) < 1e-15
        np.testing.assert_allclose(nat["obj_lmodel"][s], ob["l_model"],
                                   atol=1e-15)
        rad = max(_bound_radius(o) for o in obs_s)
        assert abs(nat["obj_bound_rad"][s] - rad) < 1e-12


@pytest.mark.parametrize("field", ["CMap sizeof", "CPrims sizeof",
                                   "abi version"])
def test_abi_mismatch_raises(field):
    """A library whose struct size or ABI version differs from the
    binding's is refused, naming what differs."""
    import ctypes

    got = {"CMap sizeof": ctypes.sizeof(native.CMap),
           "CPrims sizeof": ctypes.sizeof(native.CPrims),
           "abi version": native.ABI_VERSION}
    got[field] += 8
    fake = SimpleNamespace(
        dtown_mapc_sizeof=lambda: got["CMap sizeof"],
        dtown_prims_sizeof=lambda: got["CPrims sizeof"],
        dtown_mapc_abi_version=lambda: got["abi version"])
    with pytest.raises(RuntimeError, match=field):
        native.check_abi(fake)
    native.check_abi(native.load_library(native.build_library()))


def test_abi_version_of_binding_checked_at_load(monkeypatch):
    monkeypatch.setattr(native, "ABI_VERSION", native.ABI_VERSION + 1)
    with pytest.raises(RuntimeError, match="abi version 3 != 4"):
        native.load_library(native.build_library())


def test_failed_build_raises(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build_library(str(bad), str(tmp_path / "build"))
    assert not os.listdir(tmp_path / "build")


def test_build_leaves_tracked_library_unchanged(tmp_path):
    """The port builds from native/mapc.cpp into its own build directory
    and never writes native/: the tracked library's bytes are the same
    before and after a fresh build, which lands where it was asked."""
    tracked = os.path.join(REPO, "native", "libdtown_mapc.so")

    def sha():
        with open(tracked, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    before = sha()
    listing = sorted(os.listdir(os.path.dirname(tracked)))
    out = native.build_library(build_dir=str(tmp_path))
    assert os.path.dirname(out) == str(tmp_path) and os.path.exists(out)
    native.check_abi(native.load_library(out))
    assert sha() == before
    assert sorted(os.listdir(os.path.dirname(tracked))) == listing
