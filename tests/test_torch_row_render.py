"""dtown_torch's row-fed render (plain torch versions of K3 and K4 on the
CPU) vs the JAX package's ``render_frames_pallas`` in interpret mode, and
its per-env rows vs the JAX package's, on states carried across. The CUDA
kernels are held against the same plain versions on the card by
chip_smoke.py.

Measured on the CPU (8 envs, 32x32, these tests' states): udem1 and
bigtown equal the interpret path to the byte; loop_obstacles (with and
without render_objects) and town_dyn_duckiebots differ by a mean |diff|
of 8.1e-5 and 4.1e-5 u8 counts, no pixel more than 1 count. The bars
(mean 0.05, share of |diff| > 2 at most 1e-3) leave room for rounding:
the reference's rsqrt against 1/sqrt, and XLA's multiply-add contraction."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dtown import env as jenv
from dtown import map_loader as jmap_loader
from dtown import types as jtypes
from dtown.render import pallas_raster as jpr

from dtown_torch import EnvConfig, load_map
from dtown_torch.convert import env_states_from_numpy
from dtown_torch.render import row_raster as rr

B, SIZE = 8, 32
MEAN_BAR, SHARE_BAR = 0.05, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several test processes side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    kw = dict(camera_width=SIZE, camera_height=SIZE, renderer="pallas", **kw)
    return jtypes.EnvConfig(**kw), EnvConfig(**kw)


def _posed_states(jcfg, jmaps, seed):
    """Reset states; envs 0..B/2-1 look at an object slot from 0.3-0.8 m,
    and every env's NPC clock reads 5.2 s (traffic lights green, duckies
    mid-wiggle), as after 156 steps. A posed camera stays clear of every
    object's footprint: from inside a box its bottom face and the ground
    are one plane, and rounding alone decides which one a pixel shows."""
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    s = jax.jit(jax.vmap(lambda k: jenv.reset(jcfg, jmaps, k)))(keys)
    rng = np.random.default_rng(seed)
    pos, ang = np.array(s.pos), np.array(s.angle)
    live = np.nonzero(np.asarray(jmaps.obj_mask))[0]
    opos = np.asarray(jmaps.obj_pos)[live]
    half = np.asarray(jmaps.obj_halfdims)[live]
    clear = np.linalg.norm(half, axis=-1) + 0.05
    for b in range(B // 2):
        i = b % len(live)
        for _ in range(100):
            a = rng.uniform(-np.pi, np.pi)
            d = clear[i] + rng.uniform(0.2, 0.6)
            p = np.array([opos[i, 0] - d * np.cos(a), 0.0,
                          opos[i, 2] + d * np.sin(a)])
            if (np.hypot(*(opos - p)[:, [0, 2]].T) > clear).all():
                pos[b], ang[b] = p, a
                break
    M = jmaps.max_objects
    dyn = s.dyn.replace(time=jnp.full((B, M), 5.2, jnp.float32),
                        phase=jnp.ones((B, M), jnp.int32))
    return s.replace(pos=jnp.asarray(pos, jnp.float32),
                     angle=jnp.asarray(ang, jnp.float32), dyn=dyn)


def _compare(ours, ref):
    ours = ours.numpy().astype(int)
    ref = np.asarray(ref).astype(int)
    assert ours.shape == ref.shape == (B, 3, SIZE * SIZE // 128, 128)
    diff = np.abs(ours - ref)
    assert diff.mean() <= MEAN_BAR, diff.mean()
    assert (diff > 2).mean() <= SHARE_BAR, (diff > 2).mean()
    return ours


def _render_both(map_name, **kw):
    jcfg, cfg = _cfgs(**kw)
    jmaps = jmap_loader.load_map(map_name)
    maps = load_map(map_name).to("cpu")
    sj = _posed_states(jcfg, jmaps, 1)
    ref = jax.jit(lambda s: jpr.render_frames_pallas(
        jcfg, jmaps, s, interpret=True))(sj)
    pk = rr.pack_row_scene(cfg, maps)
    ours = rr.render_frames_rows(
        cfg, maps, env_states_from_numpy(sj, device="cpu"), pack=pk)
    return _compare(ours, ref), pk, (cfg, maps, sj)


@pytest.mark.parametrize("map_name", ["loop_obstacles", "udem1"])
def test_static_scene_render_matches_pallas_interpret(map_name):
    """K3's plain version; udem1 has a traffic light, green at 5.2 s."""
    img, pk, _ = _render_both(map_name)
    assert pk["static"] and pk["n_objs"] > 0
    assert img.std() > 5


@pytest.mark.parametrize("map_name", ["bigtown", "town_dyn_duckiebots"])
def test_object_rows_render_matches_pallas_interpret(map_name):
    """K4's plain version: bigtown has 32 objects (over K3's 16), and
    town_dyn_duckiebots has scripted bots (moving objects)."""
    img, pk, _ = _render_both(map_name)
    assert not pk["static"] and pk["Kvis"] == 8
    assert img.std() > 5


def test_render_objects_false_still_draws_objects():
    """dtown's quirk, mirrored: render_objects=False skips the static scene
    and takes K4, whose object rows ignore the flag, so objects are drawn
    on both sides."""
    img, pk, (cfg, maps, sj) = _render_both("loop_obstacles",
                                            render_objects=False)
    assert not pk["static"]
    jcfg, _ = _cfgs(render_objects=False)
    jmaps = jmap_loader.load_map("loop_obstacles")
    assert jpr._build_static_scene(jcfg, jmaps) is not None  # K3 was open
    eye = jax.vmap(lambda s: jpr.prepare_camera_row(jcfg, s)[1])(sj)
    obj_j, _ = jax.vmap(lambda s, e: jpr.prepare_object_blocks(
        jcfg, jmaps, s, e))(sj, eye)
    assert (np.asarray(obj_j).reshape(B, -1, rr.OBJ_F)[..., 7] > 0.5).any()
    # the same frames without objects (every object row inactive)
    st = env_states_from_numpy(sj, device="cpu")
    cam, words, obj, prim = rr.prepare_rows(cfg, maps, st, pk)
    assert (obj.reshape(B, -1, rr.OBJ_F)[..., 7] > 0.5).any()
    obj = obj.reshape(B, -1, rr.OBJ_F).clone()
    obj[..., 7] = 0.0
    bare = rr.row_render(cam, words, obj.reshape(B, -1), prim, pk)
    assert (bare.numpy().astype(int) != img).any()


@pytest.mark.parametrize("map_name", ["loop_obstacles", "bigtown",
                                      "town_dyn_duckiebots"])
def test_rows_match_reference(map_name):
    """Camera rows, tile words and the static scene or object/prim rows
    equal the JAX package's (within 1e-6, rows in the same order)."""
    jcfg, cfg = _cfgs()
    jmaps = jmap_loader.load_map(map_name)
    maps = load_map(map_name).to("cpu")
    sj = _posed_states(jcfg, jmaps, 2)
    st = env_states_from_numpy(sj, device="cpu")
    cam_j, eye_j = jax.vmap(lambda s: jpr.prepare_camera_row(jcfg, s))(sj)
    cam_t, eye_t = rr.prepare_camera_row(cfg, st)
    np.testing.assert_allclose(cam_t.numpy(), np.asarray(cam_j), rtol=0,
                               atol=1e-6)
    pk = rr.pack_row_scene(cfg, maps)
    words_j = jax.vmap(lambda s: jpr.pack_tile_words(jmaps, s.tex_variant))(sj)
    np.testing.assert_array_equal(
        rr.pack_tile_words(maps, st.tex_variant).numpy(),
        np.asarray(words_j)[:, :pk["n_words"]])
    scene = jpr._build_static_scene(jcfg, jmaps)
    assert rr._build_static_scene(cfg, maps) == scene
    assert pk["static"] == (scene is not None)
    if pk["static"]:
        flags_j = jax.vmap(lambda s, e: jpr._static_flags(
            jcfg, jmaps, s, e, scene))(sj, eye_j)
        flags_t = rr._static_flags(cfg, maps, st, eye_t, pk)
        np.testing.assert_array_equal(flags_t.numpy(), np.asarray(flags_j))
        assert flags_t[:, 0::2].sum() > 0
        return
    obj_j, prim_j = jax.vmap(lambda s, e: jpr.prepare_object_blocks(
        jcfg, jmaps, s, e))(sj, eye_j)
    obj_t, prim_t = rr.prepare_object_blocks(cfg, maps, st, eye_t, pk)
    np.testing.assert_allclose(obj_t.numpy(), np.asarray(obj_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(prim_t.numpy(), np.asarray(prim_j), rtol=0,
                               atol=1e-6)
    assert (obj_t.reshape(B, -1, rr.OBJ_F)[..., 7] > 0.5).sum() >= B // 2


def test_row_render_wrappers_check_inputs():
    cfg = EnvConfig(camera_width=SIZE, camera_height=SIZE, renderer="pallas")
    maps = load_map("bigtown").to("cpu")
    pk = rr.pack_row_scene(cfg, maps)
    cam = torch.zeros((4, rr.CAM_F))
    words = torch.zeros((4, pk["n_words"]), dtype=torch.int32)
    obj = torch.zeros((4, pk["Kvis"] * rr.OBJ_F))
    prim = torch.zeros((4, pk["Kvis"] * rr.P_MAX * rr.PRIM_F))
    assert rr.row_render(cam, words, obj, prim, pk).shape == (4, 3, 8, 128)
    with pytest.raises(ValueError):
        rr.row_render(cam, words, obj[:, :8], prim, pk)
    with pytest.raises(ValueError):
        rr.row_render(cam.double(), words, obj, prim, pk)
    with pytest.raises(ValueError):
        rr.pack_row_scene(EnvConfig(camera_width=10, camera_height=10), maps)


def test_shade_pixels_variants_match_reference():
    """The per-pixel texture variant (0..3) that K3/K4 read from the
    packed tile byte: brightness 0.94 + 0.04*variant and the hash seed."""
    from dtown_torch.render import tile_shading

    rng = np.random.default_rng(8)
    n = 8192
    kind = rng.integers(0, 10, n).astype(np.int32)
    ang = rng.integers(0, 4, n).astype(np.int32)
    var = rng.integers(0, 4, n).astype(np.int32)
    u, v = (rng.random(n).astype(np.float32) for _ in range(2))
    inv_fw = rng.uniform(0.5, 200.0, n).astype(np.float32)
    t = [torch.from_numpy(a) for a in (kind, ang, u, v, inv_fw, var)]
    j = [jnp.asarray(a) for a in (kind, ang, u, v, inv_fw, var)]
    for aa in (True, False):
        ours = tile_shading._shade_pixels(t[0], t[1], t[2], t[3], True,
                                          inv_fw=t[4] if aa else None,
                                          variant=t[5])
        ref = jpr._shade_pixels(j[0], j[1], j[5], j[2], j[3],
                                present=frozenset(range(10)),
                                inv_fw=j[4] if aa else None)
        for o, r in zip(ours, ref):
            # same op order, but XLA's CPU backend may contract a multiply-
            # add: a last-bit difference (2^-24) of an in-tile coordinate
            # times the coverage slope inv_fw (up to 200 here)
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                       atol=200 * 2.0 ** -24)
    zero = tile_shading._shade_pixels(t[0], t[1], t[2], t[3], True,
                                      inv_fw=t[4])
    var0 = tile_shading._shade_pixels(t[0], t[1], t[2], t[3], True,
                                      inv_fw=t[4],
                                      variant=torch.zeros_like(t[5]))
    for a, b in zip(zero, var0):
        assert torch.equal(a, b)  # variant 0 keeps the blob render's bits
