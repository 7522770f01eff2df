"""The IMPALA-CNN trunk's first convolution on the card: 3x3 window,
stride 1, SAME padding, 1 or 3 input channels, 16 output channels,
bfloat16 (csrc/conv3s1.cu).

cuDNN has no tensor-core kernel for bf16 with fewer than 8 input channels
and runs this layer on its generic engine. The hand-written kernel
computes the same bits: each output is one float32 sum of its products in
the order window row, window column, channel, rounded once to bfloat16, as
the generic engine sums them. It reads the uint8 frames and converts them
itself (the values of learn/networks.py's ``_images_to_bf16``), writing
the converted frames only where the weight gradient needs them. The
weight gradient stays cuDNN's, called as autograd calls it for F.conv2d,
so a training step is the one F.conv2d would take.

``conv3s1(images, w)`` takes uint8 frames [B, H, W, C] (any strides) and
bf16 ``w`` [16, C, 3, 3], both on the card. Elsewhere the layer converts
the frames and calls F.conv2d; ``conv3s1_reference`` is the kernel's sum
in plain torch, in its order.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dtown_torch.utils import profiling

K, STRIDE, FEATURES, CHANNELS = 3, 1, 16, (1, 3)
# SAME for a 3x3 window at stride 1: one pixel on every side
PAD = 1


def fits(c_in, features, k, stride):
    """Whether a convolution has the kernel's shape."""
    return (k, stride, features) == (K, STRIDE, FEATURES) and \
        c_in in CHANNELS


def conv3s1_reference(x, w):
    """Plain torch version on NCHW ``x``: per output, the products x * w
    summed in float32 (float64 for float64 input) from 0 in the order
    window row, window column, channel, then rounded to x's dtype."""
    acc_dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    xp = F.pad(x, (PAD,) * 4).to(acc_dtype)
    w = w.to(acc_dtype)
    H, W = x.shape[2:]
    acc = xp.new_zeros((x.shape[0], w.shape[0], H, W))
    for r in range(K):
        for s in range(K):
            tap = xp[:, :, r:r + H, s:s + W]
            for c in range(w.shape[1]):
                acc = acc + tap[:, c, None] * w[None, :, c, r, s, None, None]
    return acc.to(x.dtype)


def _fn():
    from dtown_torch import _build

    fn = _build.load("conv3s1").dtown_conv3s1
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_longlong] * 4 + [
            ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(images, w, keep):
    """(y, the converted frames as the trunk's conversion gives them, or
    None when not ``keep``)."""
    B, H, W, C = images.shape
    w = w.contiguous()
    dev = images.device
    y = torch.empty((B, w.shape[0], H, W), dtype=torch.bfloat16,
                    device=dev, memory_format=torch.channels_last)
    xo = torch.empty((B, H, W, C), dtype=torch.bfloat16, device=dev) \
        if keep else None
    err = _fn()(images.data_ptr(), *images.stride(), w.data_ptr(),
                y.data_ptr(), 0 if xo is None else xo.data_ptr(), B, C, H,
                W, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3s1 kernel launch failed: CUDA error {err}")
    profiling.count("launches.conv3s1")
    return y, None if xo is None else xo.permute(0, 3, 1, 2)


class _Conv3s1(torch.autograd.Function):
    """The kernel forward; the backward is cuDNN's weight gradient on the
    converted frames, with the arguments autograd gives it for F.conv2d."""

    @staticmethod
    def forward(ctx, images, w):
        y, x = _launch(images, w, ctx.needs_input_grad[1])
        ctx.save_for_backward(x, w)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        _, gw, _ = torch.ops.aten.convolution_backward(
            dy, x, w, None, [STRIDE, STRIDE], [PAD, PAD], [1, 1], False,
            [0, 0], 1, [False, True, False])
        return None, gw


def conv3s1(images, w):
    """The convolution of uint8 frames ``images`` [B, H, W, C], converted
    to bf16 / 255, with ``w`` [16, C, 3, 3] at stride 1 and SAME padding,
    in bf16, on the card."""
    if images.dtype != torch.uint8 or w.dtype != torch.bfloat16:
        raise ValueError(f"conv3s1 takes uint8 frames and a bf16 weight, "
                         f"got {images.dtype} and {w.dtype}")
    if not (images.is_cuda and w.is_cuda):
        raise ValueError(f"conv3s1 runs on the card, got frames on "
                         f"{images.device} and the weight on {w.device}")
    if images.dim() != 4 or \
            tuple(w.shape) != (FEATURES, images.shape[-1], K, K) or \
            images.shape[-1] not in CHANNELS:
        raise ValueError(f"conv3s1 takes frames [B, H, W, 1 or 3] and a "
                         f"weight [16, C, 3, 3], got {tuple(images.shape)} "
                         f"and {tuple(w.shape)}")
    return _Conv3s1.apply(images, w)
