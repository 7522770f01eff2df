"""The port's texture atlas (render/textures.py::tile_atlas) against
dtown's on the CPU: byte for byte, since both rasterize the ray-caster's
shading (shade_tile) at the same texel centres."""
import numpy as np
import pytest

from dtown.render import textures as jtex
from dtown_torch.render import textures


def test_tile_atlas_equals_reference():
    ref = jtex.tile_atlas()
    got = textures.tile_atlas(device="cpu")
    assert got.shape == ref.shape == (10, 4, 128, 128, 3)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    # the atlas is not flat: kinds and variants differ
    assert len({got[k, 0].tobytes() for k in range(got.shape[0])}) > 5
    assert not np.array_equal(got[1, 0], got[1, 1])


def test_tile_atlas_refuses_missing_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        textures.tile_atlas.__wrapped__()
