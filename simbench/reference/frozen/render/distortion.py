"""Fisheye camera distortion: the inverted lens model and its remaps.

Counterpart of dtown/render/distortion.py. The Duckiebot's plumb-bob
radial model is inverted on the host (numpy, Newton iterations) into
per-pixel undistorted coordinates. The renderers use them at ray level
(``undistorted_ndc``: each destination pixel casts the ray the post-render
remap would have sampled), so distortion is a table read, not a resample.
``apply_distortion`` / ``apply_distortion_planes`` keep the post-render
remap as a gather; the reference applies it to small frames as a bf16
one-hot permutation matmul, which gives the same bytes (each u8 value is
exact in bf16 and a one-hot row sums one of them).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

# Normalized intrinsics (fraction of width/height) and radial coefficients
FX, FY = 0.477, 0.643
CX, CY = 0.5, 0.5
K1, K2, K3 = -0.28, 0.07, 0.0


@functools.lru_cache(maxsize=None)
def _undistort_coords(width: int, height: int):
    """Newton-inverted undistorted normalized coords (xu, yu) [H, W] at
    every destination (fisheye) pixel center."""
    fx, fy = FX * width, FY * height
    cx, cy = CX * width, CY * height
    u, v = np.meshgrid(np.arange(width) + 0.5, np.arange(height) + 0.5)
    xd = (u - cx) / fx
    yd = (v - cy) / fy
    # invert r_d = r_u * (1 + k1 r_u^2 + k2 r_u^4 + k3 r_u^6) by Newton
    rd = np.hypot(xd, yd)
    ru = rd.copy()
    for _ in range(8):
        f = ru * (1 + K1 * ru**2 + K2 * ru**4 + K3 * ru**6) - rd
        fp = 1 + 3 * K1 * ru**2 + 5 * K2 * ru**4 + 7 * K3 * ru**6
        ru = ru - f / np.maximum(fp, 1e-6)
    scale = np.where(rd > 1e-9, ru / np.maximum(rd, 1e-9), 1.0)
    return xd * scale, yd * scale


@functools.lru_cache(maxsize=None)
def _remap_grid(width: int, height: int):
    """Flat source-pixel index [H, W] (int32) of every destination pixel."""
    fx, fy = FX * width, FY * height
    cx, cy = CX * width, CY * height
    xu, yu = _undistort_coords(width, height)
    su = np.clip((xu * fx + cx).astype(np.int32), 0, width - 1)
    sv = np.clip((yu * fy + cy).astype(np.int32), 0, height - 1)
    return sv * width + su


@functools.lru_cache(maxsize=None)
def undistorted_ndc(width: int, height: int):
    """Per-pixel NDC ray factors (xb, yb), float32 [H, W] each, that take
    the place of the linear ramps xb = ((x + .5)/W - .5)*2 and
    yb = (.5 - (y + .5)/H)*2 in the renderers' rays (then scaled by
    tan(fov/2)): xb = 2*FX*xu, yb = -2*FY*yu."""
    xu, yu = _undistort_coords(width, height)
    return ((2.0 * FX * xu).astype(np.float32),
            (-2.0 * FY * yu).astype(np.float32))


def apply_distortion(cfg, rgb):
    """Warp a rectilinear frame [H, W, C] (torch) into the fisheye view."""
    H, W = cfg.camera_height, cfg.camera_width
    grid = _grid(W, H, rgb.device)
    flat = rgb.reshape(H * W, rgb.shape[-1])
    return flat[grid].reshape(H, W, rgb.shape[-1])


def apply_distortion_planes(cfg, planes):
    """Fisheye warp of uint8 channel planes [B, C, S, 128] (torch)."""
    B, C = planes.shape[0], planes.shape[1]
    H, W = cfg.camera_height, cfg.camera_width
    flat = planes.reshape(B * C, H * W)
    return flat[:, _grid(W, H, planes.device)].reshape(planes.shape)


def _grid(W, H, device):
    return torch.as_tensor(_remap_grid(W, H).reshape(-1).astype(np.int64),
                           device=device)
