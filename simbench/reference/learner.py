"""The plain reference of the PPO learner, written from its equations and
not from the program's code: the NatureCNN actor-critic, the Gaussian
policy, GAE, the clipped-surrogate loss, global-norm clipping and Adam.

The network (Mnih et al. 2015, "Human-level control through deep
reinforcement learning"; the precision as the configuration states it):

- input: uint8 frames NHWC, cast to bfloat16 and divided by 255;
- trunk, in bfloat16 (each layer's input, weight and bias cast to bfloat16,
  the bias added to the bfloat16 product, as flax's ``dtype=bfloat16``
  layers compute): conv 32 8x8 stride 4, conv 64 4x4 stride 2, conv 64 3x3
  stride 1, each with XLA's SAME padding and a ReLU; the features
  flattened in (H, W, C) order; dense 512 and a ReLU;
- heads, in float32 on the trunk's output: the action mean (2) and the
  value (1); a state-independent ``log_std`` (2), initially -0.5;
- initial values, drawn from the generator in layer order: every trunk
  weight lecun-normal truncated to two standard deviations (std
  sqrt(1 / fan_in) / 0.8796), stored [out, in(, kh, kw)]; the mean head
  orthogonal with gain 0.01, the value head orthogonal with gain 1; biases
  zero.

One iteration: T steps of actions a = mean + exp(log_std) * noise[t], the
env fed tanh(a); GAE(gamma, lambda) on the scaled rewards; then ``epochs``
passes over the T*B transitions, each permutation cut into ``minibatches``
consecutive slices, each slice one step of: loss = policy loss (clipped
surrogate on advantages normalised by their population std + 1e-8) +
vf_coef * 0.5 * mean squared value error - ent_coef * entropy; gradients
scaled by max_norm / g when their global norm g reaches max_norm
(optax.clip_by_global_norm); Adam (lr, betas 0.9 / 0.999, eps 1e-8).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BF16 = torch.bfloat16
FP8 = torch.float8_e4m3fn
LOG_2PI = math.log(2.0 * math.pi)
# the standard deviation of a standard normal truncated to (-2, 2)
TRUNC_STD = 0.87962566103423978
# (features, kernel, stride) of the three convolutions
CONVS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))
HIDDEN = 512
ACTIONS = 2

# the program's names of the parameters (its state_dict keys), to compare;
# the leaves are kept in the order it registers them, so that the global
# norm sums them in the same order
PROGRAM_NAMES = {
    "log_std": "log_std",
    "conv0.w": "ConvTrunk_0.Conv_0.weight",
    "conv0.b": "ConvTrunk_0.Conv_0.bias",
    "conv1.w": "ConvTrunk_0.Conv_1.weight",
    "conv1.b": "ConvTrunk_0.Conv_1.bias",
    "conv2.w": "ConvTrunk_0.Conv_2.weight",
    "conv2.b": "ConvTrunk_0.Conv_2.bias",
    "fc.w": "ConvTrunk_0.Dense_0.weight",
    "fc.b": "ConvTrunk_0.Dense_0.bias",
    "mean.w": "Dense_0.weight",
    "mean.b": "Dense_0.bias",
    "value.w": "Dense_1.weight",
    "value.b": "Dense_1.bias",
}


def init_params(frame_hwc, generator, device):
    """The initial parameters {name: float32 leaf} for frames (H, W, C)."""
    H, W, c = frame_hwc
    p = {}

    def lecun(shape, fan_in):
        w = torch.empty(shape, device=device)
        std = math.sqrt(1.0 / fan_in) / TRUNC_STD
        torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                    generator=generator)
        return w

    for i, (f, k, s) in enumerate(CONVS):
        p[f"conv{i}.w"] = lecun((f, c, k, k), k * k * c)
        p[f"conv{i}.b"] = torch.zeros(f, device=device)
        H, W, c = -(-H // s), -(-W // s), f
    p["fc.w"] = lecun((HIDDEN, H * W * c), H * W * c)
    p["fc.b"] = torch.zeros(HIDDEN, device=device)
    for name, out, gain in (("mean", ACTIONS, 0.01), ("value", 1, 1.0)):
        w = torch.empty((out, HIDDEN), device=device)
        torch.nn.init.orthogonal_(w, gain, generator=generator)
        p[name + ".w"] = w
        p[name + ".b"] = torch.zeros(out, device=device)
        if name == "mean":
            p["log_std"] = torch.full((ACTIONS,), -0.5, device=device)
    return {k: p[k].requires_grad_() for k in PROGRAM_NAMES}


def _fp8(x):
    """x rounded through float8 e4m3, the gradient passed straight
    through (the control's trunk)."""
    return x + (x.to(FP8).to(x.dtype) - x).detach()


def _same(n, k, s):
    """XLA's SAME padding of one side of n: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def forward(p, frames, fp8=False):
    """(mean [B, 2], log_std [2], value [B]) of uint8 frames [B, H, W, C].
    ``fp8`` rounds the trunk's layer inputs and weights through float8."""
    q = _fp8 if fp8 else (lambda t: t)
    # cuDNN runs bfloat16 convolutions channels-last
    x = frames.permute(0, 3, 1, 2).to(BF16, memory_format=torch.channels_last)
    x = x / torch.full((), 255.0, dtype=BF16, device=x.device)
    for i, (_, k, s) in enumerate(CONVS):
        (top, bottom), (left, right) = (_same(x.shape[2], k, s),
                                        _same(x.shape[3], k, s))
        w = q(p[f"conv{i}.w"].to(BF16))
        if top == bottom and left == right:
            y = F.conv2d(q(x), w, None, s, (top, left))
        else:
            y = F.conv2d(F.pad(q(x), (left, right, top, bottom)), w, None, s)
        x = F.relu(y + p[f"conv{i}.b"].to(BF16)[:, None, None])
    h = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    h = torch.matmul(q(h), q(p["fc.w"].to(BF16)).t()) + p["fc.b"].to(BF16)
    h = F.relu(h).to(torch.float32)
    mean = torch.matmul(h, p["mean.w"].t()) + p["mean.b"]
    value = torch.matmul(h, p["value.w"].t()) + p["value.b"]
    return mean, p["log_std"], value[:, 0]


def log_prob(a, mean, log_std):
    """The diagonal Gaussian's log-density of actions [B, 2], summed."""
    z = (a - mean) / torch.exp(log_std)
    return -0.5 * (z ** 2 + 2.0 * log_std + LOG_2PI).sum(-1)


def entropy(log_std):
    return log_std.sum() + 0.5 * ACTIONS * (1.0 + LOG_2PI)


def gae(reward, done, value, last_value, gamma, lam, scale):
    """(advantages, returns) [T, B] of rewards, dones and values [T, B]
    and the value [B] after the last step; rewards times ``scale``."""
    T = reward.shape[0]
    adv = torch.zeros_like(value)
    running = torch.zeros_like(last_value)
    for t in range(T - 1, -1, -1):
        nxt = last_value if t == T - 1 else value[t + 1]
        keep = (~done[t]).to(value.dtype)
        delta = reward[t] * scale + gamma * keep * nxt - value[t]
        running = delta + gamma * lam * keep * running
        adv[t] = running
    return adv, adv + value


def loss(p, frames, action, logp_old, adv, ret, hp, fp8=False):
    """The minibatch's PPO loss (hp: the PPO hyperparameters, a dict)."""
    mean, log_std, value = forward(p, frames, fp8)
    ratio = torch.exp(log_prob(action, mean, log_std) - logp_old)
    a = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    clipped = torch.clamp(ratio, 1.0 - hp["clip_eps"], 1.0 + hp["clip_eps"])
    policy = -torch.minimum(ratio * a, clipped * a).mean()
    v = 0.5 * ((value - ret) ** 2).mean()
    return policy + hp["vf_coef"] * v - hp["ent_coef"] * entropy(log_std)


def clip_global_norm_(params, max_norm):
    """optax.clip_by_global_norm on the leaves' gradients, in place: each
    becomes grad / g * max_norm where the global norm g reaches
    max_norm."""
    g = torch.sqrt(sum((x.grad ** 2).sum() for x in params))
    for x in params:
        x.grad.copy_(torch.where(g < max_norm, x.grad, x.grad / g * max_norm))
