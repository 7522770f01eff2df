"""dtown_torch blob render (plain torch version on the CPU) vs the JAX
package: its Pallas blob render kernel in interpret mode, its XLA
ray-caster, and the XLA golden images. The CUDA kernel is held against the
same plain version on the card by chip_smoke.py."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dtown import env as jenv
from dtown import map_loader as jmap_loader
from dtown import types as jtypes
from dtown.ops.fused_env import pack_blob as j_pack_blob
from dtown.render import blob_raster as jbr
from dtown.render import pallas_raster as jpr
from dtown.render import shading as jshading

from dtown_torch import EnvConfig, load_map, stack_maps
from dtown_torch.convert import blob_from_numpy
from dtown_torch.ops import state_kernel as sk
from dtown_torch.render import blob_raster as br
from dtown_torch.render import shading, tile_shading

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _states(jcfg, jmaps, B, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    idx = jnp.zeros((B,), jnp.int32)
    return jax.vmap(lambda k, i: jenv.reset(jcfg, jmaps, k, i))(keys, idx)


def _render(cfg, map_name, blob_np):
    plan = br.build_render_plan(cfg, load_map(map_name))
    pk = br.pack_plan(cfg, plan, "cpu")
    planes = br.render_frames_from_blob(
        blob_from_numpy(blob_np, device="cpu"), pk)
    return planes.numpy().astype(int)


def _nhwc(planes, H, W):
    B = planes.shape[0]
    return np.moveaxis(planes.reshape(B, 3, H * W), 1, -1).reshape(
        B, H, W, 3)


@pytest.mark.parametrize("size", [32, 64])
def test_blob_render_matches_pallas_interpret(size):
    jcfg = jtypes.EnvConfig(camera_width=size, camera_height=size,
                            auto_reset=False)
    cfg = EnvConfig(camera_width=size, camera_height=size, auto_reset=False)
    jmaps = jmap_loader.load_map("loop_obstacles")
    blob = j_pack_blob(_states(jcfg, jmaps, 8, 1), jmaps)
    ref = np.asarray(jbr.render_frames_from_blob(
        jcfg, jmaps, blob, jbr.build_render_plan(jcfg, jmaps),
        interpret=True)).astype(int)
    ours = _render(cfg, "loop_obstacles", np.asarray(blob))
    assert ours.shape == ref.shape
    diff = np.abs(ours - ref)
    # the TPU default carries packed u8 ground bytes, the port quantizes
    # float32 once: <= ~2 counts apart (test_packed_ground_matches_float_path)
    assert diff.mean() < 1.0, diff.mean()
    assert (diff > 10).mean() < 0.01


def test_blob_render_matches_xla_renderer():
    jcfg = jtypes.EnvConfig(camera_width=64, camera_height=64,
                            auto_reset=False)
    cfg = EnvConfig(camera_width=64, camera_height=64, auto_reset=False)
    jmaps = jmap_loader.load_map("loop_obstacles")
    states = _states(jcfg, jmaps, 8, 2)
    ref = np.asarray(jax.vmap(
        lambda s: jenv.render_obs(jcfg, jmaps, s))(states)).astype(int)
    ours = _nhwc(_render(cfg, "loop_obstacles",
                         np.asarray(j_pack_blob(states, jmaps))), 64, 64)
    diff = np.abs(ours - ref)
    # tests/test_blob_render.py bars (arc-dash phase proxy, rounding)
    assert diff.mean() < 2.0, diff.mean()
    assert (diff > 10).mean() < 0.03


# (golden name, map, pos (x, z) in tile units, angle): tests/
# test_golden_images.py poses, rendered there by the XLA ray-caster
GOLDENS = [
    ("small_loop_straight", "small_loop", (0.6, 0.35), 0.0),
    ("obstacles_duckie", "loop_obstacles", (2.0, 0.6), 0.0),
]


@pytest.mark.parametrize("name,map_name,pos_t,angle", GOLDENS)
def test_blob_render_matches_golden(name, map_name, pos_t, angle):
    from PIL import Image

    golden = np.asarray(Image.open(
        os.path.join(GOLDEN_DIR, f"{name}.png"))).astype(int)
    cfg = EnvConfig(camera_width=64, camera_height=64, auto_reset=False)
    ts = float(load_map(map_name).tile_size)
    blob = np.zeros((sk.NF, 8), np.float32)
    blob[sk.F_POS_X] = np.float32(pos_t[0] * ts)
    blob[sk.F_POS_Z] = np.float32(pos_t[1] * ts)
    blob[sk.F_ANGLE] = np.float32(angle)
    img = _nhwc(_render(cfg, map_name, blob), 64, 64)[0]
    assert img.shape == golden.shape
    diff = np.abs(img - golden)
    assert diff.mean() < 2.0, diff.mean()
    assert (diff > 10).mean() < 0.03


def test_render_plan_and_rays_match_reference():
    for map_name in ("loop_obstacles", "udem1"):
        jcfg = jtypes.EnvConfig(camera_width=32, camera_height=32)
        cfg = EnvConfig(camera_width=32, camera_height=32)
        ref = jbr.build_render_plan(jcfg, jmap_loader.load_map(map_name))
        ours = br.build_render_plan(cfg, load_map(map_name))
        assert ours == ref
        np.testing.assert_array_equal(
            br._static_ray_planes(32, 32, ours),
            jbr._static_ray_planes(32, 32, ref, False)[:5])


def test_tile_shading_helpers_match_reference():
    rng = np.random.default_rng(3)
    n = 8192
    kind = rng.integers(0, 10, n).astype(np.int32)
    ang = rng.integers(0, 4, n).astype(np.int32)
    u = rng.random(n).astype(np.float32)
    v = rng.random(n).astype(np.float32)
    inv_fw = rng.uniform(0.5, 200.0, n).astype(np.float32)
    present = frozenset(range(10))
    tk, ta, tu, tv, tf = (torch.from_numpy(a)
                          for a in (kind, ang, u, v, inv_fw))
    jk, ja, ju, jv, jf = (jnp.asarray(a) for a in (kind, ang, u, v, inv_fw))
    for aa in (True, False):
        ours = tile_shading._shade_pixels(tk, ta, tu, tv, True,
                                          inv_fw=tf if aa else None)
        ref = jpr._shade_pixels(jk, ja, 0, ju, jv, present=present,
                                inv_fw=jf if aa else None)
        for o, r in zip(ours, ref):
            # same op order; XLA's CPU backend may fuse a multiply-add
            # into one FMA, which moves the last bit of a few values
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                       atol=2e-6)
    h_t = tile_shading._noise_h16f(tu, tv, tk, 0)
    h_j = jpr._noise_h16f(ju, jv, jk, 0)
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))
    words = torch.tensor([11, 22, 33], dtype=torch.int32)
    widx = torch.tensor([0, 2, 1, -1, 3], dtype=torch.int32)
    assert tile_shading._select_word(words, widx).tolist() == [11, 33, 22,
                                                               11, 11]
    d = torch.from_numpy(rng.uniform(-0.1, 0.1, n).astype(np.float32))
    np.testing.assert_array_equal(
        shading.line_coverage(d, tf).numpy(),
        np.asarray(jshading.line_coverage(jnp.asarray(d.numpy()), jf)))


def test_render_scope_raises():
    """What the blob render refuses: a scene past the plan's budget gives
    None (the reference's planless fallback). Triangle fidelity (on a map
    without OBJ kinds the plan is unchanged, on a stack too), fisheye,
    moving NPCs, domain randomization, grayscale and stacks of maps pack."""
    maps = load_map("loop_obstacles")
    tri = EnvConfig(mesh_fidelity="triangles")
    assert br.build_render_plan(tri, maps) == br.build_render_plan(
        EnvConfig(), maps)
    stacked = stack_maps(["loop_obstacles", "small_loop"])
    assert br.build_render_plan(tri, stacked) is not None
    pk = br.pack_plan(EnvConfig(), br.build_render_plan(EnvConfig(),
                                                        stacked), "cpu")
    assert pk["n_maps"] == 2 and pk["npw"] == 7
    plan = br.build_render_plan(EnvConfig(), maps)
    flat = br.pack_plan(EnvConfig(camera_width=32, camera_height=32), plan,
                        "cpu")
    fish = br.pack_plan(EnvConfig(camera_width=32, camera_height=32,
                                  distortion=True), plan, "cpu")
    assert fish["rays"].shape == flat["rays"].shape == (5, 32 * 32)
    assert not torch.equal(fish["rays"], flat["rays"])
    cfg = EnvConfig(domain_rand=True, grayscale=True)
    pk = br.pack_plan(cfg, br.build_render_plan(
        cfg, load_map("loop_pedestrians")), "cpu")
    assert pk["dr"] and pk["C"] == 1 and pk["n_npc"] == 3
    assert pk["rays"].shape == (2, 64 * 64)      # the NDC table under DR
    assert br.build_render_plan(EnvConfig(), stack_maps(["udem1"] * 4)) \
        is None
