"""render(mode="top_down") of dtown_torch's gym env, as
tests/test_topdown.py, and render/raster.py::render_top_down against the
JAX package's on the same states (bars of tests/test_torch_raster.py)."""
import numpy as np
import torch

import jax

from dtown import env as jenv
from dtown import map_loader as jmap_loader
from dtown import types as jtypes
from dtown.render import raster as jraster

import dtown_torch
from dtown_torch import EnvConfig, load_map
from dtown_torch.convert import env_states_from_numpy
from dtown_torch.render import raster

from test_torch_raster import check_frames


def _red_centroid(img):
    red = (img[..., 0] > 180) & (img[..., 1] < 90) & (img[..., 2] < 90)
    assert red.sum() > 3, "agent marker missing"
    ys, xs = np.nonzero(red)
    return ys.mean(), xs.mean()


def test_top_down_shape_and_marker():
    env = dtown_torch.make("Duckietown-loop_obstacles-v0", camera_width=128,
                           camera_height=128, obs_type="state", device="cpu")
    env.reset()
    img = env.render("top_down")
    assert img.shape == (128, 128, 3) and img.dtype == np.uint8
    assert img.std() > 10.0
    _red_centroid(img)


def test_top_down_marker_tracks_agent():
    """x -> columns, z -> rows (screen up = -z, screen right = +x)."""
    ys, xs = [], []
    for tile in [(1, 1), (5, 1), (1, 5)]:
        env = dtown_torch.make("Duckietown-udem1-v0", camera_width=128,
                               camera_height=96, obs_type="state",
                               user_tile_start=tile, device="cpu")
        env.reset()
        y, x = _red_centroid(env.render("top_down"))
        ys.append(y)
        xs.append(x)
    assert xs[1] > xs[0] + 10
    assert abs(ys[1] - ys[0]) < 6
    assert ys[2] > ys[0] + 10
    assert abs(xs[2] - xs[0]) < 6


def test_top_down_objects_visible():
    """No distance cull from 10 m up: loop_obstacles' duckies show."""
    env = dtown_torch.make("Duckietown-loop_obstacles-v0", camera_width=160,
                           camera_height=160, obs_type="state", device="cpu")
    env.reset()
    img = env.render("top_down").astype(np.int32)
    yellow = (img[..., 0] > 150) & (img[..., 1] > 120) & (img[..., 2] < 100)
    assert yellow.sum() > 10


def test_top_down_matches_reference():
    """render_top_down of 4 envs of loop_obstacles at 64x64 (grayscale
    too) against the JAX package's; measured max |diff| 0."""
    B = 4
    jmaps = jmap_loader.load_map("loop_obstacles")
    maps = load_map("loop_obstacles").to("cpu")
    for gray in (False, True):
        kw = dict(camera_width=64, camera_height=64, grayscale=gray)
        jcfg, cfg = jtypes.EnvConfig(**kw), EnvConfig(**kw)
        keys = jax.random.split(jax.random.PRNGKey(4), B)
        sj = jax.vmap(lambda k: jenv.reset(jcfg, jmaps, k))(keys)
        ref = jax.jit(jax.vmap(
            lambda s: jraster.render_top_down(jcfg, jmaps, s)))(sj)
        ours = raster.render_top_down(cfg, maps,
                                      env_states_from_numpy(sj, device="cpu"))
        assert ours.shape == (B, 64, 64, 3) and ours.dtype == torch.uint8
        assert check_frames(ours.numpy(), ref) <= 1
