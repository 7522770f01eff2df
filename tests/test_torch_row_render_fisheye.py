"""dtown_torch's row-fed render with fisheye (cfg.distortion) vs the JAX
package: the plain K3 (loop_obstacles, the static scene) and K4 (bigtown,
object rows) on posed states.

dtown's own fisheye row-fed kernels cannot be traced on the JAX this repo
runs: ``_make_kernel`` and ``_make_kernel_static`` close over their NDC
table (``_ndc_planes``) as constants, which pallas_call refuses ("captures
constants ... pass them as inputs"), and dtown's tests never render them.
So the frames are held against dtown's XLA ray-caster (``env.render_obs``,
render/raster.py), which bakes the same ``undistorted_ndc`` table into its
rays and which dtown's own Pallas renders are held against, at those
tests' bars (tests/test_pallas_render.py: mean |diff| < 2, at most 3% of
values off by more than 10). The rest of the fisheye path is pinned bit
for bit: the table equals dtown's ``_ndc_planes``, its linear form equals
the reference kernels' in-kernel ramps, and without fisheye the plain K3
and K4 match dtown's interpret-mode kernels (test_torch_row_render.py).
The CUDA kernels are held against the same plain versions on the card by
chip_smoke.py."""
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

from test_torch_row_render import B, SIZE, _posed_states

MEAN_BAR, SHARE_BAR = 2.0, 0.03


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("map_name,static", [("loop_obstacles", True),
                                             ("bigtown", False)])
def test_fisheye_row_render_matches_reference(map_name, static):
    kw = dict(camera_width=SIZE, camera_height=SIZE, renderer="pallas",
              distortion=True)
    jcfg, cfg = jtypes.EnvConfig(**kw), EnvConfig(**kw)
    jmaps = jmap_loader.load_map(map_name)
    maps = load_map(map_name).to("cpu")
    sj = _posed_states(jcfg, jmaps, 1)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda s: jenv.render_obs(jcfg, jmaps, s)))(sj)).astype(int)
    pk = rr.pack_row_scene(cfg, maps)
    assert pk["static"] == static
    planes = rr.render_frames_rows(
        cfg, maps, env_states_from_numpy(sj, device="cpu"), pack=pk)
    ours = rr.planes_to_nhwc(cfg, planes).numpy().astype(int)
    assert ours.shape == ref.shape == (B, SIZE, SIZE, 3)
    diff = np.abs(ours - ref)
    assert diff.mean() < MEAN_BAR, diff.mean()
    assert (diff > 10).mean() < SHARE_BAR
    assert ours.std() > 5
    flat = rr.render_frames_rows(
        EnvConfig(camera_width=SIZE, camera_height=SIZE, renderer="pallas"),
        maps, env_states_from_numpy(sj, device="cpu"))
    assert (flat != planes).float().mean() > 0.1


@pytest.mark.parametrize("W,H", [(32, 32), (96, 64), (640, 480)])
def test_ndc_table_ramps_match_reference(W, H):
    """The linear table is the reference kernels' ramps, float32 op for
    op ((x + .5) / W - .5) * 2 and (.5 - (y + .5) / H) * 2; under fisheye
    it is dtown's _ndc_planes."""
    p = jnp.arange(H * W, dtype=jnp.int32)
    y = p // W
    x = p - y * W
    xr = ((x.astype(jnp.float32) + 0.5) / W - 0.5) * 2.0
    yr = (0.5 - (y.astype(jnp.float32) + 0.5) / H) * 2.0
    table = rr._ndc_table(H, W, False)
    assert table.dtype == np.float32 and table.shape == (2, H * W)
    np.testing.assert_array_equal(table[0], np.asarray(xr))
    np.testing.assert_array_equal(table[1], np.asarray(yr))
    fish = rr._ndc_table(H, W, True)
    ref = jpr._ndc_planes(H, W, H * W // 128, True)
    np.testing.assert_array_equal(fish[0], ref[0].reshape(-1))
    np.testing.assert_array_equal(fish[1], ref[1].reshape(-1))
