"""Actor-critic networks of the PPO learner.

Counterpart of dtown/learn/networks.py. Parameters are float32. The
trunks compute in bfloat16 the way flax's ``dtype=jnp.bfloat16`` layers
do: input, kernel and bias are cast to bf16 and the bias is added to the
bf16 product; the heads run in float32 on the trunk's output. The casts
are written out (``torch.autocast`` rounds differently), so gradients and
Adam stay float32.

Submodules carry flax's auto-names (``ConvTrunk_0``, ``Conv_1``,
``Dense_2``, ``OptimizedLSTMCell_0``), so a flax params tree maps onto
``state_dict`` names by its path (``dtown_torch.convert.params_from_flax``).
Initializers are flax's: lecun-normal (truncated) kernels with zero biases,
orthogonal heads (scale 0.01 for the mean, 1.0 for the value),
``log_std = -0.5``; each network draws them from an explicit
torch.Generator.

Observations are uint8 images [B, H, W, C] (NHWC as in the reference, any
strides: the fused learner hands in an NHWC view of the rollout's NCHW
planes; the trunk's first convolution converts them to bf16 laid out
channels-last, cuDNN's layout for bf16 convolutions), float32 state
vectors [B, D], or the pair (image, vec) for goal-conditioned camera
policies. Networks are built for one observation shape: ``obs_shape`` is
the per-env shape, (H, W, C) or (D,), or the pair of the two.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from dtown_torch.ops import frames_conv

BF16 = torch.bfloat16
# stddev of a standard normal truncated to (-2, 2): lecun_normal's divisor
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w, fan_in, generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def _same_pads(x, k, s):
    """XLA's SAME padding of NCHW ``x`` for a k x k window at stride s,
    as F.pad's (left, right, top, bottom): out = ceil(n / s), total =
    max((out - 1) * s + k - n, 0), the smaller half before."""
    pads = []
    for n in (x.shape[3], x.shape[2]):          # F.pad: last dim first
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return pads


class Dense(nn.Module):
    """flax ``nn.Dense``: x @ kernel + bias in ``dtype``. The weight is
    stored [out, in] (torch's Linear layout)."""

    def __init__(self, fan_in, features, dtype=BF16, scale=None,
                 device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, fan_in,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        with torch.no_grad():
            if scale is None:
                _lecun_normal_(self.weight, fan_in, generator)
            else:
                nn.init.orthogonal_(self.weight, scale, generator=generator)

    def forward(self, x):
        y = torch.matmul(x.to(self.dtype), self.weight.to(self.dtype).t())
        return y + self.bias.to(self.dtype)


class Conv(nn.Module):
    """flax ``nn.Conv`` (SAME padding, bf16) on NCHW-shaped tensors (kept
    channels-last in memory by the trunks); the weight is stored OIHW.
    Symmetric SAME padding goes to the convolution itself, so only an
    uneven one costs a padded copy. A trunk's first layer takes the uint8
    frames [B, H, W, C] and converts them (``_images_to_bf16``). On the card
    a layer of a shape in ops/frames_conv.py's table (NatureCNN's and the
    IMPALA trunk's first, on 1 or 3 channels), which cuDNN runs on its
    generic engine, runs that shape's kernel (``kernel``), which converts
    the frames itself, to the same bits."""

    def __init__(self, c_in, features, k, stride=1, device=None,
                 generator=None):
        super().__init__()
        self.k, self.stride = k, stride
        self.kernel = frames_conv.kernel_for(c_in, features, k, stride)
        self.weight = nn.Parameter(torch.empty(features, c_in, k, k,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        with torch.no_grad():
            _lecun_normal_(self.weight, k * k * c_in, generator)

    def forward(self, x):
        w = self.weight.to(BF16)
        frames = x.dtype == torch.uint8
        left, right, top, bottom = pads = _same_pads(
            x.permute(0, 3, 1, 2) if frames else x, self.k, self.stride)
        if frames and self.kernel and x.is_cuda:
            y = frames_conv.frames_conv(x, w, self.stride, pads)
        else:
            if frames:
                x = _images_to_bf16(x)
            if left == right and top == bottom:
                y = F.conv2d(x, w, None, self.stride, (top, left))
            else:
                y = F.conv2d(F.pad(x, pads), w, None, self.stride)
        return y + self.bias.to(BF16)[:, None, None]


def _images_to_bf16(x):
    """uint8 NHWC -> bf16 in [0, 1], NCHW-shaped and channels-last in
    memory: cuDNN's bf16 convolutions run NHWC, and NCHW activations cost
    a transpose around every convolution and its gradients. Computes
    ``x.astype(bf16) / 255`` (the divisor a tensor, so the card divides
    rather than multiplying by a rounded reciprocal)."""
    x = x.permute(0, 3, 1, 2).to(BF16, memory_format=torch.channels_last)
    return x / torch.full((), 255.0, dtype=BF16, device=x.device)


def _add_state_mlp(trunk, dim, device, generator):
    """The trunks' state-vector branch: two bf16 Dense(256) with relu,
    flax's Dense_0 / Dense_1 of the trunk."""
    trunk.Dense_0 = Dense(dim, 256, device=device, generator=generator)
    trunk.Dense_1 = Dense(256, 256, device=device, generator=generator)
    trunk.out_features = 256


def _state_mlp(trunk, x):
    return F.relu(trunk.Dense_1(F.relu(trunk.Dense_0(x))))


class ConvTrunk(nn.Module):
    """NatureCNN trunk (bf16): three convs (8/4, 4/2, 3/1) and Dense(512)
    on images, or the two-layer MLP on state vectors."""

    def __init__(self, in_shape, features=(32, 64, 64), device=None,
                 generator=None):
        super().__init__()
        self.image = len(in_shape) == 3
        if not self.image:
            _add_state_mlp(self, in_shape[0], device, generator)
            return
        H, W, c = in_shape
        for i, (f, (k, s)) in enumerate(zip(features,
                                            [(8, 4), (4, 2), (3, 1)])):
            self.add_module(f"Conv_{i}", Conv(c, f, k, s, device,
                                              generator))
            H, W, c = -(-H // s), -(-W // s), f
        self.n_conv = len(features)
        self.Dense_0 = Dense(H * W * c, 512, device=device,
                             generator=generator)
        self.out_features = 512

    def forward(self, x):
        if not self.image:
            return _state_mlp(self, x)
        h = x                       # Conv_0 converts the uint8 frames
        for i in range(self.n_conv):
            h = F.relu(getattr(self, f"Conv_{i}")(h))
        # flax flattens NHWC: features in (H, W, C) order (a view of the
        # channels-last activations)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return F.relu(self.Dense_0(h))


class ImpalaTrunk(nn.Module):
    """IMPALA residual trunk (bf16): per stage a conv, a SAME 3x3/2 max
    pool (padded with -inf) and two residual blocks, then Dense(256); the
    same MLP as ConvTrunk on state vectors."""

    def __init__(self, in_shape, features=(16, 32, 32), device=None,
                 generator=None):
        super().__init__()
        self.image = len(in_shape) == 3
        if not self.image:
            _add_state_mlp(self, in_shape[0], device, generator)
            return
        H, W, c = in_shape
        n = 0
        for f in features:
            for _ in range(5):  # the stage's conv, then 2 blocks of 2
                self.add_module(f"Conv_{n}", Conv(c, f, 3, 1, device,
                                                  generator))
                c, n = f, n + 1
            H, W = -(-H // 2), -(-W // 2)
        self.n_stage = len(features)
        self.Dense_0 = Dense(H * W * c, 256, device=device,
                             generator=generator)
        self.out_features = 256

    def forward(self, x):
        if not self.image:
            return _state_mlp(self, x)
        conv = lambda i, v: getattr(self, f"Conv_{i}")(v)
        h = x                       # Conv_0 converts the uint8 frames
        for s in range(self.n_stage):
            h = conv(5 * s, h)
            h = F.max_pool2d(F.pad(h, _same_pads(h, 3, 2), value=-math.inf),
                             3, 2)
            for b in range(2):
                r = conv(5 * s + 2 * b + 1, F.relu(h))
                h = h + conv(5 * s + 2 * b + 2, F.relu(r))
        h = F.relu(h).permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return F.relu(self.Dense_0(h))


TRUNKS = {"nature": ConvTrunk, "impala": ImpalaTrunk}


def make_trunk(name, in_shape, device=None, generator=None):
    if name not in TRUNKS:
        raise ValueError(f"unknown trunk {name!r} (nature | impala)")
    return TRUNKS[name](in_shape, device=device, generator=generator)


def add_trunk(module, name, in_shape, device, generator):
    """make_trunk registered on ``module`` under flax's name for it
    (``ConvTrunk_0``, ``ImpalaTrunk_0``); returns the trunk and keeps its
    attribute name in module.trunk_name."""
    trunk = make_trunk(name, in_shape, device, generator)
    module.trunk_name = f"{type(trunk).__name__}_0"
    module.add_module(module.trunk_name, trunk)
    return trunk


class _GaussianHeads(nn.Module):
    """The mean (orthogonal 0.01) and value (orthogonal 1.0) heads in
    float32 and the state-independent ``log_std`` (-0.5)."""

    def _add_heads(self, fan_in, action_dim, mean_name, value_name, device,
                   generator):
        self.add_module(mean_name, Dense(fan_in, action_dim, torch.float32,
                                         0.01, device, generator))
        self.log_std = nn.Parameter(torch.full((action_dim,), -0.5,
                                               device=device))
        self.add_module(value_name, Dense(fan_in, 1, torch.float32, 1.0,
                                          device, generator))
        self._heads = (mean_name, value_name)

    def _apply_heads(self, h):
        h = h.to(torch.float32)
        mean = getattr(self, self._heads[0])(h)
        value = getattr(self, self._heads[1])(h)
        return mean, self.log_std, value[..., 0]


class ActorCritic(_GaussianHeads):
    """Gaussian policy over the 2-d action and a value head. With a pair
    ``obs_shape`` ((H, W, C), (D,)) the vector side channel (the Nav goal
    features) is embedded by Dense(64) and mixed with the trunk's features
    by Dense(256). forward(obs) -> (mean [B, A], log_std [A], value [B])."""

    def __init__(self, obs_shape, action_dim=2, trunk="nature", device=None,
                 generator=None):
        super().__init__()
        self.pair = isinstance(obs_shape[0], (tuple, list))
        img_shape = obs_shape[0] if self.pair else obs_shape
        width = add_trunk(self, trunk, img_shape, device,
                          generator).out_features
        if self.pair:
            self.Dense_0 = Dense(obs_shape[1][0], 64, device=device,
                                 generator=generator)
            self.Dense_1 = Dense(width + 64, 256, device=device,
                                 generator=generator)
            self._add_heads(256, action_dim, "Dense_2", "Dense_3", device,
                            generator)
        else:
            self._add_heads(width, action_dim, "Dense_0", "Dense_1", device,
                            generator)

    def forward(self, obs):
        if self.pair:
            x, vec = obs
            h = getattr(self, self.trunk_name)(x)
            g = F.relu(self.Dense_0(vec))
            h = F.relu(self.Dense_1(torch.cat([h, g], -1)))
        else:
            h = getattr(self, self.trunk_name)(obs)
        return self._apply_heads(h)


class LSTMCell(nn.Module):
    """flax ``nn.OptimizedLSTMCell`` in float32: gates i, f, g, o from
    (h @ W_h + b_h) + x @ W_i, with no input bias. weight_ih [4H, in] and
    weight_hh [4H, H] stack the gates in torch.nn.LSTMCell's order; the
    carry is flax's (c, h)."""

    def __init__(self, fan_in, hidden, device=None, generator=None):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, fan_in,
                                                  device=device))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden,
                                                  device=device))
        self.bias_hh = nn.Parameter(torch.zeros(4 * hidden, device=device))
        with torch.no_grad():
            # flax draws each gate's kernel on its own: lecun-normal input
            # kernels, orthogonal hidden ones
            for k in range(4):
                sl = slice(k * hidden, (k + 1) * hidden)
                _lecun_normal_(self.weight_ih[sl], fan_in, generator)
                nn.init.orthogonal_(self.weight_hh[sl], 1.0,
                                    generator=generator)

    def forward(self, carry, x):
        c, h = carry
        z = (h @ self.weight_hh.t() + self.bias_hh) + x @ self.weight_ih.t()
        i, f, g, o = z.chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h


class ActorCriticRNN(_GaussianHeads):
    """Recurrent actor-critic: trunk -> LSTM -> Gaussian policy + value.
    forward(obs, carry) -> (mean, log_std, value, carry); the carry (c, h),
    each [B, hidden], is reset at episode ends by the learner
    (learn/ppo_rnn.py)."""

    def __init__(self, obs_shape, action_dim=2, trunk="nature", hidden=128,
                 device=None, generator=None):
        super().__init__()
        self.hidden = hidden
        width = add_trunk(self, trunk, obs_shape, device,
                          generator).out_features
        self.OptimizedLSTMCell_0 = LSTMCell(width, hidden, device, generator)
        self._add_heads(hidden, action_dim, "Dense_0", "Dense_1", device,
                        generator)

    def forward(self, obs, carry):
        h = getattr(self, self.trunk_name)(obs).to(torch.float32)
        carry, h = self.OptimizedLSTMCell_0(carry, h)
        return (*self._apply_heads(h), carry)

    def initial_carry(self, batch):
        z = torch.zeros((batch, self.hidden), device=self.log_std.device)
        return (z, z.clone())
