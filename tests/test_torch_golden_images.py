"""dtown_torch's XLA ray-caster (render/raster.py) against the ten golden
frames of tests/goldens/*.png, at tests/test_golden_images.py's poses
(64x64, the pose overwritten on a fresh state of the map). The bar is the
goldens' own: max |diff| <= 1. Measured on the CPU: 0 on all ten (the
frames are byte-identical)."""
import os

import numpy as np
import pytest
import torch

from dtown_torch import EnvConfig, load_map
from dtown_torch import env as tenv
from dtown_torch.render import raster

from test_golden_images import GOLDEN_DIR, POSES


@pytest.mark.parametrize("name,map_name,pos_t,angle", POSES)
def test_golden_image(name, map_name, pos_t, angle):
    from PIL import Image

    cfg = EnvConfig(camera_width=64, camera_height=64, auto_reset=False)
    maps = load_map(map_name).to("cpu")
    ts = float(maps.numpy().tile_size)
    st = tenv.reset(cfg, maps, torch.Generator().manual_seed(0), 1)
    st = st.replace(
        pos=torch.tensor([[pos_t[0] * ts, 0.0, pos_t[1] * ts]]),
        angle=torch.tensor([angle], dtype=torch.float32))
    img = raster.render_frame(cfg, maps, st)[0].numpy().astype(int)
    golden = np.asarray(Image.open(
        os.path.join(GOLDEN_DIR, f"{name}.png"))).astype(int)
    assert img.shape == golden.shape
    assert np.abs(img - golden).max() <= 1
