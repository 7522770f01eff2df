"""NatureCNN's first convolution on the card: 8x8 window, stride 4, 1 or 3
input channels, 32 output channels, bfloat16 (csrc/conv8s4.cu).

cuDNN has no tensor-core kernel for bf16 with fewer than 8 input channels
and runs this layer on its generic engine, the learner's slowest kernel.
The hand-written kernel computes the same bits: each output is one
float32 sum of its products in the order window row, window column,
channel, rounded once to bfloat16, as the generic engine sums them. It
reads the uint8 frames and converts them itself (the values of
learn/networks.py's ``_images_to_bf16``), writing the converted frames
only where the weight gradient needs them. The weight gradient stays
cuDNN's, called as autograd calls it for F.conv2d, so a training step is
the one F.conv2d would take.

``conv8s4(images, w, pads)`` takes uint8 frames [B, H, W, C] (any
strides), bf16 ``w`` [32, C, 8, 8] and F.pad's SAME ``pads`` (left, right,
top, bottom) of the NCHW-shaped frames, all on the card. Elsewhere the
layer converts the frames and calls F.conv2d; ``conv8s4_reference`` is the
kernel's sum in plain torch, in its order.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dtown_torch.utils import profiling

K, STRIDE, FEATURES, CHANNELS = 8, 4, 32, (1, 3)


def fits(c_in, features, k, stride):
    """Whether a convolution has the kernel's shape."""
    return (k, stride, features) == (K, STRIDE, FEATURES) and \
        c_in in CHANNELS


def conv8s4_reference(x, w, pads):
    """Plain torch version: per output, the products x * w summed in
    float32 (float64 for float64 input) from 0 in the order window row,
    window column, channel, then rounded to x's dtype."""
    acc_dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    xp = F.pad(x, pads).to(acc_dtype)
    w = w.to(acc_dtype)
    Ho = (xp.shape[2] - K) // STRIDE + 1
    Wo = (xp.shape[3] - K) // STRIDE + 1
    acc = xp.new_zeros((x.shape[0], w.shape[0], Ho, Wo))
    for r in range(K):
        for s in range(K):
            tap = xp[:, :, r:r + STRIDE * (Ho - 1) + 1:STRIDE,
                     s:s + STRIDE * (Wo - 1) + 1:STRIDE]
            for c in range(w.shape[1]):
                acc = acc + tap[:, c, None] * w[None, :, c, r, s, None, None]
    return acc.to(x.dtype)


def _fn():
    from dtown_torch import _build

    fn = _build.load("conv8s4").dtown_conv8s4
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_longlong] * 4 + [
            ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(images, w, pads, keep):
    """(y, the converted frames as the trunk's conversion gives them, or
    None when not ``keep``)."""
    left, right, top, bottom = pads
    B, H, W, C = images.shape
    Ho = (H + top + bottom - K) // STRIDE + 1
    Wo = (W + left + right - K) // STRIDE + 1
    w = w.contiguous()
    dev = images.device
    y = torch.empty((B, w.shape[0], Ho, Wo), dtype=torch.bfloat16,
                    device=dev, memory_format=torch.channels_last)
    xo = torch.empty((B, H, W, C), dtype=torch.bfloat16, device=dev) \
        if keep else None
    err = _fn()(images.data_ptr(), *images.stride(), w.data_ptr(),
                y.data_ptr(),
                0 if xo is None else xo.data_ptr(), B, C, H, W, Ho, Wo, top,
                left, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv8s4 kernel launch failed: CUDA error {err}")
    profiling.count("launches.conv8s4")
    return y, None if xo is None else xo.permute(0, 3, 1, 2)


class _Conv8s4(torch.autograd.Function):
    """The kernel forward; the backward is cuDNN's on the converted frames,
    with the arguments autograd gives it for F.conv2d (the padded copy
    where SAME is uneven)."""

    @staticmethod
    def forward(ctx, images, w, pads):
        y, x = _launch(images, w, pads, ctx.needs_input_grad[1])
        ctx.save_for_backward(x, w)
        ctx.pads = pads
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        left, right, top, bottom = ctx.pads
        if left == right and top == bottom:
            xp, padding = x, [top, left]
        else:
            xp, padding = F.pad(x, ctx.pads), [0, 0]
        _, gw, _ = torch.ops.aten.convolution_backward(
            dy, xp, w, None, [STRIDE, STRIDE], padding, [1, 1], False,
            [0, 0], 1, [False, True, False])
        return None, gw, None


def conv8s4(images, w, pads):
    """The convolution of uint8 frames ``images`` [B, H, W, C], converted
    to bf16 / 255, with ``w`` [32, C, 8, 8] at stride 4 after F.pad's
    ``pads`` (of the NCHW-shaped frames), in bf16, on the card."""
    if images.dtype != torch.uint8 or w.dtype != torch.bfloat16:
        raise ValueError(f"conv8s4 takes uint8 frames and a bf16 weight, "
                         f"got {images.dtype} and {w.dtype}")
    if not (images.is_cuda and w.is_cuda):
        raise ValueError(f"conv8s4 runs on the card, got frames on "
                         f"{images.device} and the weight on {w.device}")
    return _Conv8s4.apply(images, w, tuple(pads))
