"""dtown_torch.learn.networks against dtown.learn.networks (flax), with the
flax parameters carried across by convert.params_from_flax: the forward
pass of every trunk and observation kind, the initializers' statistics,
and one recurrent step; the plain version of the first convolution's
card kernels against F.conv2d."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from dtown.learn import networks as jnet

from dtown_torch.convert import params_from_flax
from dtown_torch.learn import networks as tnet
from dtown_torch.ops import frames_conv
from dtown_torch.utils import profiling

# Outputs agree within two bf16 ulps (2^-7) of the output's scale: both
# trunks round every layer to bf16 and accumulate in f32 in another order,
# so an intermediate near a rounding boundary can land one ulp apart.
BF16_TOL = 2.0 ** -7


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_obs(obs):
    if isinstance(obs, tuple):
        return tuple(torch.from_numpy(o) for o in obs)
    return torch.from_numpy(obs)


def _obs(kind, size, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "state":
        return rng.standard_normal((8, 11)).astype(np.float32)
    img = rng.integers(0, 256, (8, size, size, 1 if kind == "gray" else 3),
                       dtype=np.uint8)
    if kind == "pair":
        return img, rng.standard_normal((8, 3)).astype(np.float32)
    return img


def _shape(obs):
    if isinstance(obs, tuple):
        return tuple(o.shape[1:] for o in obs)
    return obs.shape[1:]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BF16_TOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("trunk,kind,size", [
    ("nature", "rgb", 32), ("nature", "rgb", 64), ("nature", "gray", 32),
    ("nature", "gray", 64), ("impala", "rgb", 32), ("impala", "rgb", 64),
    ("impala", "gray", 32), ("impala", "gray", 64), ("nature", "state", 0),
    ("impala", "state", 0), ("nature", "pair", 32)])
def test_actor_critic_matches_flax(trunk, kind, size):
    """mean, log_std and value of the port's ActorCritic with flax's
    parameters. 64x64 IMPALA pools with SAME padding (0, 1), not (1, 1);
    NatureCNN's SAME pads differ between 32 and 64."""
    obs = _obs(kind, size)
    jobs = jax.tree_util.tree_map(jnp.asarray, obs)
    net = jnet.ActorCritic(trunk=trunk)
    params = net.init(jax.random.PRNGKey(0), jobs)
    mean_j, log_std_j, value_j = net.apply(params, jobs)
    port = params_from_flax(_np(params),
                            tnet.ActorCritic(_shape(obs), trunk=trunk))
    with torch.no_grad():
        mean, log_std, value = port(_torch_obs(obs))
    assert mean.shape == (8, 2) and value.shape == (8,)
    assert mean.dtype == value.dtype == torch.float32
    _close(mean, mean_j)
    _close(value, value_j)
    np.testing.assert_array_equal(log_std.detach().numpy(), log_std_j)


def _layer_stds(tree, prefix=()):
    """{path: (kernel std, fan_in)} of every kernel in a params tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_layer_stds(v, prefix + (k,)))
        elif k == "kernel":
            a = np.asarray(v)
            out[prefix] = (float(a.std()), int(np.prod(a.shape[:-1])))
    return out


@pytest.mark.parametrize("trunk", ["nature", "impala"])
def test_initializers_match_flax(trunk):
    """Per layer the port's kernel std matches flax's (lecun-normal: 1 /
    sqrt(fan_in), truncated at 2 sigma; the heads orthogonal 0.01 and 1.0),
    biases start at zero and log_std at -0.5."""
    obs = _obs("rgb", 64)
    params = jnet.ActorCritic(trunk=trunk).init(jax.random.PRNGKey(3),
                                                jnp.asarray(obs))
    port = tnet.ActorCritic(obs.shape[1:], trunk=trunk,
                            generator=torch.Generator().manual_seed(3))
    want = _layer_stds(params["params"])
    sd = port.state_dict()
    for path, (std_j, fan_in) in want.items():
        w = sd[".".join(path) + ".weight"].numpy()
        # sampling spread of a std over n draws is ~1/sqrt(2n); the
        # smallest kernel (the 512x2 mean head) has 1024 entries
        assert abs(w.std() - std_j) <= 0.1 * std_j, (path, w.std(), std_j)
        if path[-1] in ("Dense_0", "Dense_1") and len(path) == 1:
            continue  # orthogonal heads
        lim = 2.0 * np.sqrt(1.0 / fan_in) / 0.87962566103423978
        assert np.abs(w).max() <= lim * (1 + 1e-6), path
        assert abs(w.std() * np.sqrt(fan_in) - 1.0) < 0.1, path
    for name in ("Dense_0", "Dense_1"):
        w = sd[name + ".weight"].numpy()
        gain = 0.01 if name == "Dense_0" else 1.0
        np.testing.assert_allclose(w @ w.T, gain ** 2 * np.eye(w.shape[0]),
                                   rtol=0, atol=1e-6 * max(gain ** 2, 1e-3))
    for k, v in sd.items():
        if k.endswith("bias"):
            assert (v == 0).all(), k
    np.testing.assert_array_equal(sd["log_std"].numpy(), [-0.5, -0.5])


@pytest.mark.parametrize("kind,size", [("state", 0), ("rgb", 32)])
def test_rnn_step_matches_flax(kind, size):
    """One ActorCriticRNN step from a nonzero carry: flax's (c, h) carry
    and OptimizedLSTMCell gates (input kernels without bias) carried across
    as weight_ih / weight_hh / bias_hh."""
    obs = _obs(kind, size, seed=1)
    rng = np.random.default_rng(2)
    carry = tuple(rng.standard_normal((8, 64)).astype(np.float32) * 0.5
                  for _ in range(2))
    net = jnet.ActorCriticRNN(hidden=64)
    params = net.init(jax.random.PRNGKey(4), jnp.asarray(obs),
                      tuple(map(jnp.asarray, carry)))
    # non-zero hidden biases, so their place in the gates is tested
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.1 if p[-1].key == "bias" and p[-2].key.startswith(
            "h") else a, params)
    mean_j, log_std_j, value_j, (c_j, h_j) = net.apply(
        params, jnp.asarray(obs), tuple(map(jnp.asarray, carry)))
    port = params_from_flax(_np(params),
                            tnet.ActorCriticRNN(obs.shape[1:], hidden=64))
    with torch.no_grad():
        mean, log_std, value, (c, h) = port(
            torch.from_numpy(obs), tuple(map(torch.from_numpy, carry)))
    for got, want in ((mean, mean_j), (value, value_j), (c, c_j), (h, h_j)):
        _close(got, want)
    np.testing.assert_array_equal(log_std.detach().numpy(), log_std_j)
    z = port.initial_carry(5)
    assert all(t.shape == (5, 64) and not t.any() for t in z)


def test_params_from_flax_refuses_missing_and_extra_leaves():
    obs = _obs("state", 0)
    params = _np(jnet.ActorCritic().init(jax.random.PRNGKey(0),
                                         jnp.asarray(obs)))["params"]
    port = tnet.ActorCritic((11,))
    params_from_flax(params, port)          # the whole tree loads
    short = dict(params)
    del short["log_std"]
    with pytest.raises(ValueError, match="missing"):
        params_from_flax(short, port)
    extra = dict(params, Dense_9={"kernel": np.zeros((256, 1), np.float32)})
    with pytest.raises(ValueError, match="extra"):
        params_from_flax(extra, port)
    wrong = dict(params, Dense_1={"kernel": np.zeros((256, 2), np.float32),
                                  "bias": np.zeros((2,), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        params_from_flax(wrong, port)


def test_unknown_trunk_raises():
    with pytest.raises(ValueError, match="unknown trunk"):
        tnet.ActorCritic((11,), trunk="resnet")


def _frames(hw, c, layout, seed=0):
    """uint8 frames [4, H, W, c]: contiguous NHWC (the step path's) or an
    NHWC view of NCHW planes (the fused learner's)."""
    g = torch.Generator().manual_seed(seed)
    H, W = hw
    if layout == "nhwc":
        return torch.randint(0, 256, (4, H, W, c), generator=g,
                             dtype=torch.uint8)
    return torch.randint(0, 256, (4, c, H, W), generator=g,
                         dtype=torch.uint8).permute(0, 2, 3, 1)


# the table's kernels by name: (window, stride, features)
SHAPES = {name: shape for shape, name in frames_conv.KERNELS.items()}


@pytest.mark.parametrize("name,dtype,hw,c", [
    ("conv8s4", dtype, hw, c) for dtype in (torch.float64, torch.bfloat16)
    for hw in [(64, 64), (96, 96), (32, 32), (84, 84), (31, 31), (48, 64)]
    for c in (3, 1)] + [
    ("conv3s1", torch.float64, hw, c)
    for hw in [(64, 64), (32, 32), (31, 47)] for c in (3, 1)])
def test_frames_conv_reference_matches_conv2d(name, dtype, hw, c):
    """ops/frames_conv.py's plain version (the card kernels' order: each
    output summed from 0 over window row, window column, channel) computes
    F.conv2d of each kernel's layer (NatureCNN's first, 8x8 stride 4, and
    the IMPALA trunk's first, 3x3 stride 1, on 3 or 1 channels, XLA's SAME
    padding) on the images / 255. In float64: the output and the weight
    and bias gradients to 1e-12 of their scale (only the order of the sum
    differs). In bf16 (f32 sums, rounded once): the output within one bf16
    ulp of its scale."""
    k, s, f = SHAPES[name]
    x = _frames(hw, c, "planes" if c == 3 else "nhwc").permute(0, 3, 1, 2)
    x = x.to(dtype) / torch.full((), 255.0, dtype=dtype)
    conv = tnet.Conv(c, f, k, s, generator=torch.Generator().manual_seed(1))
    assert conv.kernel == name
    pads = tnet._same_pads(x, k, s)
    leaves = [conv.weight.detach().to(dtype), torch.randn(
        f, generator=torch.Generator().manual_seed(2)).to(dtype)]
    got_leaves = [v.clone().requires_grad_() for v in leaves]
    want_leaves = [v.clone().requires_grad_() for v in leaves]
    got = frames_conv.frames_conv_reference(x, got_leaves[0], s, pads) \
        + got_leaves[1][:, None, None]
    want = F.conv2d(F.pad(x, pads), want_leaves[0], None, s) \
        + want_leaves[1][:, None, None]
    assert got.shape == want.shape == (4, f, -(-hw[0] // s),
                                       -(-hw[1] // s))
    assert got.dtype == dtype
    if dtype == torch.float64:
        dy = torch.randn(want.shape, generator=torch.Generator()
                         .manual_seed(3), dtype=dtype)
        got.backward(dy)
        want.backward(dy)
        pairs = [(got, want)] + [(a.grad, b.grad) for a, b in
                                 zip(got_leaves, want_leaves)]
        for a, b in pairs:
            a, b = a.detach().numpy(), b.detach().numpy()
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-12 * np.abs(b).max())
        return
    want = want.detach().float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=ulp)


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("c", [3, 1])
def test_frames_conv_reference_sums_in_kernel_order(name, c):
    """The plain version in bf16 is, bit for bit, the kernels' sum: per
    output a float32 chain from 0 over window row, window column, channel,
    rounded once to bf16 (a scalar loop here), SAME padding even or not.
    Where every partial sum is exact in float32 (small multiples of powers
    of two), it equals F.conv2d exactly, in float32 and rounded to bf16."""
    k, s, f = SHAPES[name]
    g = torch.Generator().manual_seed(4)
    u = torch.randint(0, 256, (2, c, 5, 6), generator=g, dtype=torch.uint8)
    x = u.to(tnet.BF16) / torch.full((), 255.0, dtype=tnet.BF16)
    w = torch.randn((f, c, k, k), generator=g).to(tnet.BF16)
    pads = tnet._same_pads(x, k, s)
    got = frames_conv.frames_conv_reference(x, w, s, pads)
    assert got.dtype == tnet.BF16
    left, right, top, bottom = pads
    xp = np.pad(x.float().numpy(),
                ((0, 0), (0, 0), (top, bottom), (left, right)))
    wn = w.float().numpy()
    want = np.zeros((2, f, -(-5 // s), -(-6 // s)), np.float32)
    for b, o, i, j in np.ndindex(*want.shape):
        acc = np.float32(0)
        for r in range(k):
            for t in range(k):
                for ch in range(c):
                    acc = np.float32(acc + xp[b, ch, s * i + r, s * j + t]
                                     * wn[o, ch, r, t])
        want[b, o, i, j] = acc
    assert torch.equal(got, torch.from_numpy(want).to(tnet.BF16))

    xe = torch.randint(0, 9, (2, c, 7, 5), generator=g).float() / 8
    we = torch.randint(-8, 9, (f, c, k, k), generator=g).float() / 4
    pads = tnet._same_pads(xe, k, s)
    exact = F.conv2d(F.pad(xe, pads), we, None, s)
    assert torch.equal(frames_conv.frames_conv_reference(xe, we, s, pads),
                       exact)
    assert torch.equal(frames_conv.frames_conv_reference(
        xe.to(tnet.BF16), we.to(tnet.BF16), s, pads), exact.to(tnet.BF16))


@pytest.mark.parametrize("trunk", ["nature", "impala"])
@pytest.mark.parametrize("kind", ["rgb", "gray", "state"])
def test_frames_conv_engages_by_shape(trunk, kind):
    """The table's shapes are each trunk's Conv_0 alone: NatureCNN's (8x8
    stride 4, 1 or 3 channels, 32 features) takes conv8s4 and the IMPALA
    trunk's (3x3 stride 1, 16 features) conv3s1; no other convolution
    (NatureCNN's Conv_2 is 3x3 stride 1 on 64 channels, IMPALA's other 14
    take 16 or 32), nothing of a state trunk. The parameters keep flax's
    names and shapes, so params_from_flax loads a flax tree as before; on
    the CPU the layer stays F.conv2d and launches nothing."""
    obs = _obs(kind, 64)
    params = jnet.ActorCritic(trunk=trunk).init(jax.random.PRNGKey(0),
                                                jnp.asarray(obs))
    port = params_from_flax(_np(params), tnet.ActorCritic(obs.shape[1:],
                                                          trunk=trunk))
    t = getattr(port, port.trunk_name)
    want = [] if kind == "state" else {
        "nature": ["conv8s4", None, None],
        "impala": ["conv3s1"] + [None] * 14}[trunk]
    assert [m.kernel for m in t.modules() if isinstance(m, tnet.Conv)] \
        == want
    if trunk == "nature" and kind != "state":
        assert {k: tuple(v.shape) for k, v in t.state_dict().items()} == {
            "Conv_0.weight": (32, obs.shape[-1], 8, 8), "Conv_0.bias": (32,),
            "Conv_1.weight": (64, 32, 4, 4), "Conv_1.bias": (64,),
            "Conv_2.weight": (64, 64, 3, 3), "Conv_2.bias": (64,),
            "Dense_0.weight": (512, 8 * 8 * 64), "Dense_0.bias": (512,)}
    profiling.reset_counters()
    with torch.no_grad():
        port(torch.from_numpy(obs))
    assert not [k for k in profiling.counters() if k.startswith("launches.")]


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("what", ["device", "dtype", "shape"])
def test_frames_conv_refuses(name, what):
    """The kernels' entry refuses, before anything is launched, CPU
    tensors, frames other than uint8 or a weight other than bf16, and every
    shape the table does not hold: a weight whose channels are not the
    frames', frames of 2 channels or not [B, H, W, C], a non-square
    window, another kernel's window, other features, another stride."""
    k, s, f = SHAPES[name]
    frames = torch.from_numpy(_obs("rgb", 32))
    w = torch.zeros((f, 3, k, k), dtype=tnet.BF16)
    pads = tnet._same_pads(frames.permute(0, 3, 1, 2), k, s)
    other = next(shape for shape in frames_conv.KERNELS if shape[2] != f)
    calls = {
        "device": [(frames, w, s)],
        "dtype": [(frames.float(), w, s), (frames, w.float(), s)],
        "shape": [(frames, w[:, :1], s), (frames[..., :2], w[:, :2], s),
                  (frames[0], w, s), (frames, w[..., 1:], s),
                  (frames, torch.zeros((f, 3) + other[:1] * 2,
                                       dtype=tnet.BF16), s),
                  (frames, w[:f // 2], s), (frames, w, s + 1)]}[what]
    match = {"device": "runs on the card", "dtype": "takes uint8 frames",
             "shape": "got the shapes"}[what]
    profiling.reset_counters()
    for images, weight, stride in calls:
        with pytest.raises(ValueError, match=match):
            frames_conv.frames_conv(images, weight, stride, pads)
    assert not [k for k in profiling.counters() if k.startswith("launches.")]
