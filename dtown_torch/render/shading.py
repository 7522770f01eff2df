"""Analytic tile shading constants and marking coverage (torch).

Counterpart of dtown/render/shading.py: the road surface is shaded
procedurally, with lane markings as analytic functions of the in-tile
(u, v) coordinate and surface noise from an integer hash of the texel.
"""
import torch

# Marking geometry (tile fractions), consistent with curves.LANE_OFFSET
EDGE_INSET = 0.035
LINE_W = 0.025
DASH_PERIOD = 0.125
DASH_DUTY = 0.5

# Colors (0..1)
YELLOW = (0.82, 0.68, 0.10)
WHITE = (0.88, 0.88, 0.88)
ASPHALT = (0.155, 0.155, 0.16)
GRASS = (0.22, 0.46, 0.18)
FLOOR = (0.62, 0.60, 0.58)
EMPTY = (0.13, 0.28, 0.11)

NOISE_AMP = 0.012
NOISE_CELLS = 128  # hash lattice per tile edge


def line_coverage(d, inv_fw, half_w=LINE_W / 2, cap=None):
    """Exact box-filter coverage of the band |d| < half_w under a pixel
    footprint of width 1/inv_fw (tile units):
    clamp(min((half_w - |d|) * inv_fw + 0.5, 2 * half_w * inv_fw), 0, 1).
    """
    tent = (half_w - torch.abs(d)) * inv_fw + 0.5
    if cap is None:
        cap = (2.0 * half_w) * inv_fw
    return torch.clamp(torch.minimum(tent, cap), 0.0, 1.0)
