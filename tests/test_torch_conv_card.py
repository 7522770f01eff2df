"""On the card: NatureCNN's first convolution (8x8 stride 4, 1 or 3
channels, 32 features) runs the hand-written kernel of ops/conv8s4.py on
the uint8 frames. Its output equals cuDNN's (the generic engine F.conv2d
takes for this shape, on the frames as the trunk converts them) and the
plain version's to the bit, at every frame size users run here, SAME
padding even or not, whatever the frames' layout; the frames it converts
for the weight gradient equal the trunk's conversion, and the weight
gradient F.conv2d's, to the bit; one forward and backward of the NatureCNN
trunk at batch 4096 on 64x64 RGB frames launches the kernel once and
cuDNN's generic engine not at all.

The IMPALA trunk's first convolution (3x3 stride 1, 1 or 3 channels, 16
features) runs ops/conv3s1.py's kernel alike: its output equals cuDNN's
and the plain version's to the bit at 64x64 and 32x32 (and at 96x96 and
31x47, off its vector path), on NCHW planes,
NHWC frames and strided ones, with the converted frames kept or not (kept,
they equal the trunk's conversion); one forward and backward of the IMPALA
trunk launches it once, cuDNN's generic engine not at all, and gives every
gradient of the parent path (Conv_0 on F.conv2d) to the bit.

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
from dtown_torch.ops import conv3s1, conv8s4
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


def _weight(device, c, seed=1):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn((32, c, 8, 8), generator=g, device=device)
            * (64 * c) ** -0.5).to(BF16).requires_grad_()


def _cudnn(x, w, pads):
    left, right, top, bottom = pads
    if left == right and top == bottom:
        return F.conv2d(x, w, None, 4, (top, left))
    return F.conv2d(F.pad(x, pads), w, None, 4)


@pytest.mark.card
@pytest.mark.parametrize("batch,hw", [(4096, (64, 64)), (256, (96, 96)),
                                      (256, (84, 84)), (256, (32, 32)),
                                      (256, (31, 31)), (16, (480, 640))])
@pytest.mark.parametrize("c", [3, 1])
@pytest.mark.parametrize("layout", ["planes", "nhwc", "strided"])
def test_conv8s4_bits(cuda, batch, hw, c, layout):
    images = _frames(cuda, batch, hw, c, layout)
    x = _images_to_bf16(images)
    w = _weight(cuda, c)
    pads = _same_pads(x, 8, 4)
    got = conv8s4.conv8s4(images, w, pads)
    want = _cudnn(x, w, pads)
    assert got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)
    with torch.no_grad():
        plain = conv8s4.conv8s4_reference(x, w, pads)
        y, kept = conv8s4._launch(images, w, pads, True)
    assert torch.equal(got, plain) and torch.equal(y, got)
    assert kept.stride() == x.stride() and torch.equal(kept, x)
    dy = _images_to_bf16(
        _frames(cuda, batch, want.shape[2:], 32, "nhwc", seed=2)) - 0.5
    gw, = torch.autograd.grad(got, w, dy)
    gw_want, = torch.autograd.grad(want, w, dy)
    assert torch.equal(gw, gw_want)


@pytest.mark.card
def test_trunk_leaves_the_generic_engine(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    trunk = ConvTrunk((64, 64, 3), device=cuda, generator=g)
    x = _frames(cuda, 4096, (64, 64), 3, "planes")

    def step():
        trunk.zero_grad()
        trunk(x).float().square().mean().backward()

    # a process's first profiler session can miss its first kernels
    for _ in range(2):
        step()
        torch.cuda.synchronize()
        profiling.reset_counters()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    kernels = {ev.key for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA}
    assert any("conv8s4_kernel" in k for k in kernels), sorted(kernels)
    assert not [k for k in kernels if "convolve_common_engine" in k], \
        sorted(kernels)
    assert profiling.counters()["launches.conv8s4"] == 1
    assert trunk.Conv_0.weight.grad.shape == (32, 3, 8, 8)


def _weight3(device, c, seed=1):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn((16, c, 3, 3), generator=g, device=device)
            * (9 * c) ** -0.5).to(BF16).requires_grad_()


@pytest.mark.card
@pytest.mark.parametrize("batch,hw", [(2048, (64, 64)), (512, (32, 32)),
                                      (64, (96, 96)), (64, (31, 47))])
@pytest.mark.parametrize("c", [3, 1])
@pytest.mark.parametrize("layout", ["planes", "nhwc", "strided"])
@pytest.mark.parametrize("keep", [True, False])
def test_conv3s1_bits(cuda, batch, hw, c, layout, keep):
    images = _frames(cuda, batch, hw, c, layout)
    x = _images_to_bf16(images)
    w = _weight3(cuda, c)
    with torch.set_grad_enabled(keep):
        got = conv3s1.conv3s1(images, w)
    want = F.conv2d(x, w.detach(), None, 1, (1, 1))
    assert got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)
    with torch.no_grad():
        plain = conv3s1.conv3s1_reference(x, w)
        y, kept = conv3s1._launch(images, w, keep)
    assert torch.equal(got, plain) and torch.equal(y, got)
    if not keep:
        assert kept is None and not got.requires_grad
        return
    assert kept.stride() == x.stride() and torch.equal(kept, x)
    dy = _images_to_bf16(
        _frames(cuda, batch, want.shape[2:], 16, "nhwc", seed=2)) - 0.5
    w2 = w.detach().clone().requires_grad_()
    gw, = torch.autograd.grad(got, w, dy)
    gw_want, = torch.autograd.grad(F.conv2d(x, w2, None, 1, (1, 1)), w2,
                                   dy)
    assert torch.equal(gw, gw_want)


@pytest.mark.card
def test_conv3s1_training_batch(cuda):
    """A minibatch of the four-card cell's update (32,768 frames of 64x64
    RGB planes): cuDNN keeps the generic engine's order at this batch."""
    images = _frames(cuda, 32768, (64, 64), 3, "planes")
    w = _weight3(cuda, 3)
    with torch.no_grad():
        got = conv3s1.conv3s1(images, w)
        want = F.conv2d(_images_to_bf16(images), w, None, 1, (1, 1))
    assert torch.equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("c", [3, 1])
def test_impala_trunk_leaves_the_generic_engine(cuda, c):
    g = torch.Generator(device=cuda).manual_seed(0)
    trunk = ImpalaTrunk((64, 64, c), device=cuda, generator=g)
    parent = copy.deepcopy(trunk)
    parent.Conv_0.direct3 = False      # Conv_0 on F.conv2d, as before
    x = _frames(cuda, 2048, (64, 64), c, "planes")

    def step(net):
        net.zero_grad()
        out = net(x)
        out.float().square().mean().backward()
        return out

    # a process's first profiler session can miss its first kernels
    for _ in range(2):
        step(trunk)
        torch.cuda.synchronize()
        profiling.reset_counters()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = step(trunk)
            torch.cuda.synchronize()
    kernels = {ev.key for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA}
    assert any("conv3s1_kernel" in k for k in kernels), sorted(kernels)
    assert not [k for k in kernels if "convolve_common_engine" in k], \
        sorted(kernels)
    assert profiling.counters()["launches.conv3s1"] == 1
    want = step(parent)
    assert torch.equal(out, want)
    for (name, p), q in zip(trunk.named_parameters(), parent.parameters()):
        assert torch.equal(p.grad, q.grad), name
