"""Texture-atlas preview derived from the analytic shader.

Counterpart of dtown/render/textures.py. The renderers shade tiles
procedurally per pixel (render/shading.py); this module rasterizes that
shader (``shade_tile``, the ray-caster's form) onto a texel grid to give
a classic atlas, for previews and docs.

Atlas layout: uint8 [N_KINDS, N_TEX_VARIANTS, TEX, TEX, 3].
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from dtown_torch import types as T
from dtown_torch.device import resolve_device
from dtown_torch.randomization import N_TEX_VARIANTS

TEX = 128  # texels per tile edge


@functools.lru_cache(maxsize=2)
def tile_atlas(device="cuda") -> np.ndarray:
    """The atlas as a numpy array, every kind and variant shaded in one
    batch on ``device`` (the card unless ``device="cpu"``). The result is
    shared between callers: do not write to it."""
    from dtown_torch.render.shading import shade_tile

    dev = resolve_device(device)
    n_kinds = max(T.TILE_KINDS.values()) + 1
    c = (torch.arange(TEX, dtype=torch.float32, device=dev) + 0.5) / TEX
    shape = (n_kinds, N_TEX_VARIANTS, TEX, TEX)
    v = c[:, None].expand(shape)
    u = c[None, :].expand(shape)
    kind = torch.arange(n_kinds, dtype=torch.int32, device=dev)
    var = torch.arange(N_TEX_VARIANTS, dtype=torch.int32, device=dev)
    rgb = shade_tile(kind[:, None, None, None].expand(shape),
                     torch.zeros(shape, dtype=torch.int32, device=dev),
                     var[None, :, None, None].expand(shape), u, v)
    return (rgb * 255.0 + 0.5).to(torch.uint8).cpu().numpy()
