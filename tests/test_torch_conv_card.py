"""On the card: the trunks' first convolutions run the hand-written
kernels of ops/frames_conv.py on the uint8 frames: NatureCNN's (8x8 stride
4, 1 or 3 channels, 32 features, conv8s4) and the IMPALA trunk's (3x3
stride 1, 1 or 3 channels, 16 features, conv3s1). Each kernel's output
equals cuDNN's (the generic engine F.conv2d takes for these shapes, on the
frames as the trunk converts them) and the plain version's to the bit, at
every frame size users run here (and, for conv3s1, at 96x96 and 31x47,
off its vector path), SAME padding even or not, on NCHW planes, NHWC
frames and strided ones; the frames it converts for the weight gradient
(kept where the weight needs one) equal the trunk's conversion, and the
weight gradient F.conv2d's, to the bit. One forward and backward of each
trunk launches its kernel once, cuDNN's generic engine not at all, and
gives every output and gradient of the parent path (Conv_0 on F.conv2d)
to the bit.

Skips without a CUDA device. tests/conftest.py imports JAX, which a
machine with the card need not have, so run it there with
``python -m pytest tests/test_torch_conv_card.py --noconftest -m card``.
"""
import copy

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from dtown_torch.learn.networks import (BF16, ConvTrunk, ImpalaTrunk,
                                        _images_to_bf16, _same_pads)
from dtown_torch.ops import frames_conv
from dtown_torch.utils import profiling


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _frames(device, batch, hw, c, layout, seed=0):
    """uint8 frames [batch, H, W, c]: an NHWC view of NCHW planes (the
    fused learner's), contiguous NHWC (the step path's), or NHWC columns
    of a wider buffer (no vector layout)."""
    g = torch.Generator(device=device).manual_seed(seed)
    H, W = hw

    def draw(*shape):
        return torch.randint(0, 256, shape, generator=g, device=device,
                             dtype=torch.uint8)
    if layout == "planes":
        return draw(batch, c, H, W).permute(0, 2, 3, 1)
    if layout == "nhwc":
        return draw(batch, H, W, c)
    return draw(batch, H, W + 3, c)[:, :, 1:W + 1]


# the table's kernels by name: (window, stride, features)
SHAPES = {name: shape for shape, name in frames_conv.KERNELS.items()}


def _weight(device, name, c, seed=1):
    k, _, f = SHAPES[name]
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn((f, c, k, k), generator=g, device=device)
            * (k * k * c) ** -0.5).to(BF16).requires_grad_()


def _cudnn(x, w, stride, pads):
    left, right, top, bottom = pads
    if left == right and top == bottom:
        return F.conv2d(x, w, None, stride, (top, left))
    return F.conv2d(F.pad(x, pads), w, None, stride)


@pytest.mark.card
@pytest.mark.parametrize("name,batch,hw,keep", [
    ("conv8s4", batch, hw, True) for batch, hw in [
        (4096, (64, 64)), (256, (96, 96)), (256, (84, 84)), (256, (32, 32)),
        (256, (31, 31)), (16, (480, 640))]] + [
    ("conv3s1", batch, hw, keep) for batch, hw in [
        (2048, (64, 64)), (512, (32, 32)), (64, (96, 96)), (64, (31, 47))]
    for keep in (True, False)])
@pytest.mark.parametrize("c", [3, 1])
@pytest.mark.parametrize("layout", ["planes", "nhwc", "strided"])
def test_frames_conv_bits(cuda, name, batch, hw, keep, c, layout):
    k, s, f = SHAPES[name]
    images = _frames(cuda, batch, hw, c, layout)
    x = _images_to_bf16(images)
    w = _weight(cuda, name, c)
    pads = _same_pads(x, k, s)
    with torch.set_grad_enabled(keep):
        got = frames_conv.frames_conv(images, w, s, pads)
    want = _cudnn(x, w, s, pads)
    assert got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)
    with torch.no_grad():
        plain = frames_conv.frames_conv_reference(x, w, s, pads)
        y, kept = frames_conv._launch(images, w, s, pads, keep)
    assert torch.equal(got, plain) and torch.equal(y, got)
    if not keep:
        assert kept is None and not got.requires_grad
        return
    assert kept.stride() == x.stride() and torch.equal(kept, x)
    dy = _images_to_bf16(
        _frames(cuda, batch, want.shape[2:], f, "nhwc", seed=2)) - 0.5
    gw, = torch.autograd.grad(got, w, dy)
    gw_want, = torch.autograd.grad(want, w, dy)
    assert torch.equal(gw, gw_want)


@pytest.mark.card
def test_conv3s1_training_batch(cuda):
    """A minibatch of the four-card cell's update (32,768 frames of 64x64
    RGB planes): cuDNN keeps the generic engine's order at this batch."""
    images = _frames(cuda, 32768, (64, 64), 3, "planes")
    w = _weight(cuda, "conv3s1", 3)
    with torch.no_grad():
        got = frames_conv.frames_conv(images, w, 1, [1] * 4)
        want = F.conv2d(_images_to_bf16(images), w, None, 1, (1, 1))
    assert torch.equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("trunk,batch,c", [
    (ConvTrunk, 4096, 3), (ImpalaTrunk, 2048, 3), (ImpalaTrunk, 2048, 1)])
def test_trunk_leaves_the_generic_engine(cuda, trunk, batch, c):
    g = torch.Generator(device=cuda).manual_seed(0)
    net = trunk((64, 64, c), device=cuda, generator=g)
    name = net.Conv_0.kernel
    assert name in SHAPES
    parent = copy.deepcopy(net)
    parent.Conv_0.kernel = None        # Conv_0 on F.conv2d, as before
    x = _frames(cuda, batch, (64, 64), c, "planes")

    def step(m):
        m.zero_grad()
        out = m(x)
        out.float().square().mean().backward()
        return out

    # a process's first profiler session can miss its first kernels
    for _ in range(2):
        step(net)
        torch.cuda.synchronize()
        profiling.reset_counters()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = step(net)
            torch.cuda.synchronize()
    kernels = {ev.key for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA}
    assert any(f"{name}_kernel" in k for k in kernels), sorted(kernels)
    assert not [k for k in kernels if "convolve_common_engine" in k], \
        sorted(kernels)
    assert profiling.counters()[f"launches.{name}"] == 1
    want = step(parent)
    assert torch.equal(out, want)
    for (key, p), q in zip(net.named_parameters(), parent.parameters()):
        assert torch.equal(p.grad, q.grad), key
