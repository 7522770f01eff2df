"""dtown_torch's fisheye model (render/distortion.py) vs the JAX
package's: the Newton-inverted coordinates, the remap grid and the NDC
ray table bit for bit at 64x64, 96x96 and the reference's native 640x480,
and the post-render remaps byte for byte on seeded frames (dtown applies
the small one as a bf16 permutation matmul, the large one as a gather;
the port gathers both)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dtown import types as jtypes
from dtown.render import distortion as jd

from dtown_torch import EnvConfig
from dtown_torch.render import distortion as td


@pytest.mark.parametrize("W,H", [(64, 64), (96, 96), (640, 480)])
def test_lens_tables_bit_equal(W, H):
    for ours, ref in zip(td._undistort_coords(W, H),
                         jd._undistort_coords(W, H)):
        np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(td._remap_grid(W, H), jd._remap_grid(W, H))
    xb, yb = td.undistorted_ndc(W, H)
    xr, yr = jd.undistorted_ndc(W, H)
    assert xb.dtype == yb.dtype == np.float32
    np.testing.assert_array_equal(xb, xr)
    np.testing.assert_array_equal(yb, yr)


def test_apply_distortion_same_bytes():
    W, H = 48, 32
    frame = np.random.default_rng(0).integers(0, 256, (H, W, 3), np.uint8)
    jcfg = jtypes.EnvConfig(camera_width=W, camera_height=H)
    cfg = EnvConfig(camera_width=W, camera_height=H)
    ref = np.asarray(jd.apply_distortion(jcfg, jnp.asarray(frame)))
    ours = td.apply_distortion(cfg, torch.from_numpy(frame)).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert (ours != frame).mean() > 0.1


# 32x32 takes dtown's bf16 permutation matmul, 128x96 (over
# PERM_MATMUL_MAX_PIXELS) its gather
@pytest.mark.parametrize("W,H,C", [(32, 32, 3), (32, 32, 1), (128, 96, 3)])
def test_apply_distortion_planes_same_bytes(W, H, C):
    planes = np.random.default_rng(W + C).integers(
        0, 256, (4, C, H * W // 128, 128), np.uint8)
    jcfg = jtypes.EnvConfig(camera_width=W, camera_height=H)
    cfg = EnvConfig(camera_width=W, camera_height=H)
    ref = np.asarray(jd.apply_distortion_planes(jcfg, jnp.asarray(planes)))
    ours = td.apply_distortion_planes(cfg, torch.from_numpy(planes)).numpy()
    assert ours.shape == ref.shape == planes.shape
    np.testing.assert_array_equal(ours, ref)
