"""Task layers of the fused rollout: the Nav task's goal draw.

Counterpart of dtown/tasks.py's ``_draw_goal``: a Nav goal is a tile drawn
uniformly from the drivable tiles of the env's map. The fused Nav rollout
(ops/fused_env.py ``make_fused_nav_rollout``) draws its first goals here;
the state kernel redraws them at every reset from its integer hash
(ops/state_kernel.py).
"""
from __future__ import annotations

import numpy as np
import torch


def draw_goal(maps, map_idx, generator: torch.Generator):
    """Goal tiles (i, j), int32 [B, 2]: for env b a tile drawn uniformly
    from the drivable tiles of its map (member map_idx[b] of a stack; the
    map itself on a single map), from ``generator``, a torch.Generator on
    map_idx's device."""
    host = maps.numpy()
    grids = ([np.asarray(host.map_at(m).drivable) for m in range(host.n_maps)]
             if host.is_stack else [np.asarray(host.drivable)])
    W = grids[0].shape[1]
    flat = [np.flatnonzero(g) for g in grids]          # j * W + i
    table = np.zeros((len(flat), max(max(len(f) for f in flat), 1)),
                     np.int64)
    for m, f in enumerate(flat):
        table[m, :len(f)] = f
    dev = map_idx.device
    counts = torch.as_tensor([len(f) for f in flat], device=dev)
    mi = map_idx.long()
    n = counts[mi]
    u = torch.rand(map_idx.shape, generator=generator, device=dev,
                   dtype=torch.float64)
    k = torch.minimum((u * n).long(), torch.clamp(n - 1, min=0))
    tile = torch.as_tensor(table, device=dev)[mi, k]
    return torch.stack([tile % W, tile // W], -1).to(torch.int32)
