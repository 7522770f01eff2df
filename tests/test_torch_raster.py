"""dtown_torch's XLA ray-caster as batched torch (render/raster.py) vs the
JAX package's vmapped ``render/raster.py::render_frame``, on states
carried across from the JAX package and posed (moved off their spawns,
NPCs moved, lamps switched): loop_obstacles, udem1 with domain
randomization and fisheye, town_dyn_duckiebots with moving NPCs in
grayscale, the draw_curve / draw_bbox overlays without marking AA, a
stack of maps (each env on its own member), and the triangle pass on
tests/test_objmesh.py's sample mesh. Bars per frame: mean |diff| <= 0.25
and at most 0.5% of values off by more than 1; the largest |diff|
measured on the CPU is each case's ``max_seen``. Also
tests/test_marking_aa.py's check: the AA frame is nearer a 4x4
supersampled hard render than the hard frame is."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dtown import env as jenv
from dtown import map_loader as jmap_loader
from dtown import types as jtypes

from dtown_torch import EnvConfig, load_map, stack_maps
from dtown_torch import map_loader
from dtown_torch.convert import env_states_from_numpy
from dtown_torch.render import raster

MEAN_BAR, SHARE_BAR = 0.25, 0.005
B, S = 8, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def check_frames(ours, ref, mean_bar=MEAN_BAR, share_bar=SHARE_BAR):
    """Per-frame bars; returns the largest |diff|."""
    ours = np.asarray(ours).astype(np.int32)
    ref = np.asarray(ref).astype(np.int32)
    assert ours.shape == ref.shape
    d = np.abs(ours - ref).reshape(ours.shape[0], -1)
    assert d.mean(1).max() <= mean_bar, d.mean(1)
    assert (d > 1).mean(1).max() <= share_bar, (d > 1).mean(1)
    return int(d.max())


def _posed_states(jcfg, jmaps, seed=1):
    """dtown's fresh states of B envs (each on member b % n_maps of a
    stack), moved off their spawn poses by a few cm and degrees per env,
    and with the NPCs and the light phase moved as a few steps would."""
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    idx = jenv.initial_map_indices(jmaps, B)
    st = jax.vmap(lambda k, i: jenv.reset(jcfg, jmaps, k, i))(keys, idx)
    r = np.random.default_rng(seed)
    pos = np.asarray(st.pos) + r.uniform(-0.05, 0.05, (B, 3)) * [1, 0, 1]
    ang = np.asarray(st.angle) + r.uniform(-0.2, 0.2, B)
    dpos = np.asarray(st.dyn.pos) + r.uniform(-0.03, 0.03,
                                              st.dyn.pos.shape) * [1, 0, 1]
    dyn = st.dyn.replace(
        pos=jnp.asarray(dpos, jnp.float32),
        time=jnp.full_like(st.dyn.time, 0.4),
        phase=jnp.asarray(r.integers(0, 2, st.dyn.phase.shape), jnp.int32))
    return st.replace(pos=jnp.asarray(pos, jnp.float32),
                      angle=jnp.asarray(ang, jnp.float32), dyn=dyn)


def _compare(names, **kw):
    jcfg = jtypes.EnvConfig(camera_width=S, camera_height=S, **kw)
    cfg = EnvConfig(camera_width=S, camera_height=S, **kw)
    if isinstance(names, list):
        jmaps = jmap_loader.stack_maps(names)
        maps = stack_maps(names).to("cpu")
    else:
        jmaps = jmap_loader.load_map(names)
        maps = load_map(names).to("cpu")
    sj = _posed_states(jcfg, jmaps)
    ref = jax.jit(jax.vmap(lambda s: jenv.render_obs(jcfg, jmaps, s)))(sj)
    ours = raster.render_frame(cfg, maps, env_states_from_numpy(
        sj, device="cpu"))
    assert ours.dtype == torch.uint8
    assert ours.shape == (B, S, S, 1 if cfg.grayscale else 3)
    assert float(ours.float().std()) > 5.0
    return check_frames(ours.numpy(), ref)


@pytest.mark.parametrize("name,kw,max_seen", [
    ("loop_obstacles", {}, 1),
    ("udem1", {"domain_rand": True, "distortion": True}, 4),
    ("town_dyn_duckiebots", {"grayscale": True}, 1),
    ("loop_obstacles", {"draw_curve": True, "draw_bbox": True,
                        "marking_aa": False}, 4),
    (["zigzag_dists", "4way", "udem1"], {}, 1),
])
def test_render_frame_matches_reference(name, kw, max_seen):
    """max_seen: the largest |diff| measured on the CPU. A ray direction
    one float32 ulp apart (XLA contracts some of the reference's
    multiply-adds) can move a ground hit across a noise texel (up to 4
    counts) or a hard marking edge."""
    assert _compare(name, **kw) <= max_seen


def test_stack_frames_follow_map_idx():
    """On a stack each env's frame is its own member's: env b of the stack
    renders as the single map of member b % n_maps does."""
    names = ["small_loop", "udem1"]
    cfg = EnvConfig(camera_width=S, camera_height=S)
    stack = stack_maps(names).to("cpu")
    jcfg = jtypes.EnvConfig(camera_width=S, camera_height=S)
    st = env_states_from_numpy(_posed_states(
        jcfg, jmap_loader.stack_maps(names)), device="cpu")
    frames = raster.render_frame(cfg, stack, st)
    for m in range(2):
        ours = raster.render_frame(cfg, stack.map_at(m), st)
        rows = (st.map_idx == m).numpy()
        np.testing.assert_array_equal(frames.numpy()[rows],
                                      ours.numpy()[rows])


def test_triangle_pass_matches_reference(tmp_path):
    """mesh_fidelity="triangles" on tests/test_objmesh.py's scene, the
    camera posed facing the sample mesh; the kinds registered for the test
    are removed again at its end."""
    from test_objmesh import _write_sample
    from test_torch_objmesh import KIND, _scene, register_sample_kinds

    restore = register_sample_kinds(_write_sample(tmp_path))
    try:
        kw = dict(camera_width=S, camera_height=S,
                  mesh_fidelity="triangles", start_pose=(0.3, 0.3, 0.0))
        jcfg, cfg = jtypes.EnvConfig(**kw), EnvConfig(**kw)
        jmaps = jmap_loader.compile_map(_scene(KIND))
        maps = map_loader.compile_map(_scene(KIND)).to("cpu")
        keys = jax.random.split(jax.random.PRNGKey(0), B)
        sj = jax.vmap(lambda k: jenv.reset(jcfg, jmaps, k))(keys)
        ang = jnp.linspace(-0.3, 0.3, B, dtype=jnp.float32)
        sj = sj.replace(angle=ang)
        ref = jax.jit(jax.vmap(lambda s: jenv.render_obs(jcfg, jmaps, s)))(
            sj)
        st = env_states_from_numpy(sj, device="cpu")
        ours = raster.render_frame(cfg, maps, st)
        assert check_frames(ours.numpy(), ref) <= 1
        prims = raster.render_frame(
            dataclasses.replace(cfg, mesh_fidelity="prims"), maps, st)
        # the triangle pass draws pixels the boxes do not
        assert (ours != prims).any()
    finally:
        restore()


@pytest.mark.parametrize("pos_t,angle",
                         [((1.5, 2.25), 1.5707964), ((0.65, 2.5), 1.5707964)])
def test_aa_closer_to_supersampled_truth(pos_t, angle):
    """As tests/test_marking_aa.py: on marking-edge pixels the AA frame is
    nearer a box-downsampled 256x256 hard render than the hard frame."""
    maps = load_map("4way").to("cpu")
    ts = float(maps.numpy().tile_size)
    base = EnvConfig(camera_width=64, camera_height=64, auto_reset=False,
                     render_objects=False,
                     start_pose=(pos_t[0] * ts, pos_t[1] * ts, angle))
    from dtown_torch import env as tenv

    s = tenv.reset(base, maps, torch.Generator().manual_seed(3), 1)
    hi = dataclasses.replace(base, camera_width=256, camera_height=256,
                             marking_aa=False)
    img_hi = raster.render_frame(hi, maps, s)[0].numpy().astype(float)
    ssaa = img_hi.reshape(64, 4, 64, 4, 3).mean(axis=(1, 3))
    img_aa = raster.render_frame(base, maps, s)[0].numpy().astype(float)
    img_hd = raster.render_frame(dataclasses.replace(base, marking_aa=False),
                                 maps, s)[0].numpy().astype(float)
    blk = img_hi.reshape(64, 4, 64, 4, 3)
    edge = (blk.max(axis=(1, 3)) - blk.min(axis=(1, 3))).max(-1) > 60
    assert edge.sum() > 50
    e_aa = np.abs(img_aa - ssaa).max(-1)[edge].mean()
    e_hd = np.abs(img_hd - ssaa).max(-1)[edge].mean()
    assert e_aa < 0.85 * e_hd, (e_aa, e_hd)


def test_render_in_slices_equals_one_batch(monkeypatch):
    """Rendering in slices of envs (PIXELS_PER_SLICE) changes no pixel."""
    cfg = EnvConfig(camera_width=S, camera_height=S)
    maps = load_map("loop_obstacles").to("cpu")
    jcfg = jtypes.EnvConfig(camera_width=S, camera_height=S)
    st = env_states_from_numpy(_posed_states(
        jcfg, jmap_loader.load_map("loop_obstacles")), device="cpu")
    whole = raster.render_frame(cfg, maps, st)
    monkeypatch.setattr(raster, "PIXELS_PER_SLICE", 3 * S * S)
    assert raster.envs_per_slice(cfg, maps) == 3
    np.testing.assert_array_equal(raster.render_frame(cfg, maps, st).numpy(),
                                  whole.numpy())
