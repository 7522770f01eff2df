"""The trunks' first convolution on the card, on the uint8 frames: bfloat16,
SAME padding, 1 or 3 input channels, in a hand-written kernel for each
shape that ``KERNELS`` holds: NatureCNN's 8x8 window at stride 4 with 32
features (csrc/conv8s4.cu) and the IMPALA trunk's 3x3 window at stride 1
with 16 (csrc/conv3s1.cu). The table is the one place that says which
layers leave cuDNN.

cuDNN has no tensor-core kernel for bf16 with fewer than 8 input channels
and runs these layers on its generic engine. The kernels compute the same
bits: each output is one float32 sum of its products in the order window
row, window column, channel, rounded once to bfloat16, as the generic
engine sums them. They read the uint8 frames and convert them themselves
(the values of learn/networks.py's ``_images_to_bf16``), writing the
converted frames only where the weight gradient needs them. The weight
gradient stays cuDNN's, called as autograd calls it for F.conv2d, so a
training step is the one F.conv2d would take.

``frames_conv(images, w, stride, pads)`` takes uint8 frames [B, H, W, C]
(any strides), a bf16 ``w`` [F, C, k, k] of a kernel's shape, its stride
and F.pad's SAME ``pads`` (left, right, top, bottom) of the NCHW-shaped
frames, all on the card. Elsewhere the layer converts the frames and
calls F.conv2d; ``frames_conv_reference`` is the kernels' sum in plain
torch, in their order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from dtown_torch import _build

# (window, stride, features) -> the kernel, for CHANNELS input channels
KERNELS = {(8, 4, 32): "conv8s4", (3, 1, 16): "conv3s1"}
CHANNELS = (1, 3)

_LAUNCH = {name: _build.kernel(name, f"dtown_{name}",
                               "P" + "q" * 4 + "P" * 3 + "i" * 8, name)
           for name in KERNELS.values()}


def kernel_for(c_in, features, k, stride):
    """The name of the kernel of a convolution's shape, or None."""
    return KERNELS.get((k, stride, features)) if c_in in CHANNELS else None


def frames_conv_reference(x, w, stride, pads):
    """Plain torch version on NCHW ``x``: per output, the products x * w
    summed in float32 (float64 for float64 input) from 0 in the order
    window row, window column, channel, then rounded to x's dtype."""
    acc_dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    xp = F.pad(x, pads).to(acc_dtype)
    w = w.to(acc_dtype)
    kh, kw = w.shape[2:]
    Ho = (xp.shape[2] - kh) // stride + 1
    Wo = (xp.shape[3] - kw) // stride + 1
    acc = xp.new_zeros((x.shape[0], w.shape[0], Ho, Wo))
    for r in range(kh):
        for s in range(kw):
            tap = xp[:, :, r:r + stride * (Ho - 1) + 1:stride,
                     s:s + stride * (Wo - 1) + 1:stride]
            for c in range(w.shape[1]):
                acc = acc + tap[:, c, None] * w[None, :, c, r, s, None, None]
    return acc.to(x.dtype)


def _launch(images, w, stride, pads, keep):
    """(y, the converted frames as the trunk's conversion gives them, or
    None when not ``keep``)."""
    left, right, top, bottom = pads
    B, H, W, C = images.shape
    features, _, k, _ = w.shape
    Ho = (H + top + bottom - k) // stride + 1
    Wo = (W + left + right - k) // stride + 1
    w = w.contiguous()
    dev = images.device
    y = torch.empty((B, features, Ho, Wo), dtype=torch.bfloat16,
                    device=dev, memory_format=torch.channels_last)
    xo = torch.empty((B, H, W, C), dtype=torch.bfloat16, device=dev) \
        if keep else None
    _LAUNCH[KERNELS[(k, stride, features)]](
        images.data_ptr(), *images.stride(), w.data_ptr(), y.data_ptr(),
        0 if xo is None else xo.data_ptr(), B, C, H, W, Ho, Wo, top, left,
        dev)
    return y, None if xo is None else xo.permute(0, 3, 1, 2)


class _FramesConv(torch.autograd.Function):
    """The kernel forward; the backward is cuDNN's weight gradient on the
    converted frames, with the arguments autograd gives it for F.conv2d
    (the padded copy where SAME is uneven)."""

    @staticmethod
    def forward(ctx, images, w, stride, pads):
        y, x = _launch(images, w, stride, pads, ctx.needs_input_grad[1])
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.pads = stride, pads
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
            dy, xp, w, None, [ctx.stride, ctx.stride], padding, [1, 1],
            False, [0, 0], 1, [False, True, False])
        return None, gw, None, None


def frames_conv(images, w, stride, pads):
    """The convolution of uint8 frames ``images`` [B, H, W, C], converted
    to bf16 / 255, with ``w`` [F, C, k, k] at ``stride`` after F.pad's
    ``pads`` (of the NCHW-shaped frames), in bf16, on the card."""
    if images.dtype != torch.uint8 or w.dtype != torch.bfloat16:
        raise ValueError(f"frames_conv takes uint8 frames and a bf16 "
                         f"weight, got {images.dtype} and {w.dtype}")
    if images.dim() != 4 or w.dim() != 4 or \
            w.shape[1] != images.shape[-1] or w.shape[2] != w.shape[3] or \
            kernel_for(w.shape[1], w.shape[0], w.shape[2], stride) is None:
        raise ValueError(f"frames_conv takes frames [B, H, W, C] and a "
                         f"weight [F, C, k, k], C in {CHANNELS} and (k, "
                         f"stride, F) in {list(KERNELS)}; got the shapes "
                         f"{tuple(images.shape)} and {tuple(w.shape)} at "
                         f"stride {stride}")
    if not (images.is_cuda and w.is_cuda):
        raise ValueError(f"frames_conv runs on the card, got frames on "
                         f"{images.device} and the weight on {w.device}")
    return _FramesConv.apply(images, w, stride, tuple(pads))
