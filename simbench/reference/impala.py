"""The plain reference of the IMPALA-CNN actor-critic, written from the
paper's description and not from the program's code.

The network (Espeholt et al. 2018, "IMPALA: Scalable Distributed Deep-RL
with Importance Weighted Actor-Learner Architectures", arXiv:1802.01561,
Fig. 3, the large network; the precision as the configuration states it):

- input: uint8 frames NHWC, cast to bfloat16 and divided by 255;
- trunk, in bfloat16 (each layer's input, weight and bias cast to
  bfloat16, the bias added to the bfloat16 product): three stages of 16, 32
  and 32 channels. A stage is a 3x3 stride-1 convolution, a 3x3 stride-2
  max pool (XLA's SAME padding, padded with -inf) and two residual blocks;
  a block is x + conv(relu(conv(relu(x)))), both 3x3 stride 1 SAME. After
  the stages: a ReLU, the features flattened in (H, W, C) order, dense 256
  and a ReLU;
- heads, in float32 on the trunk's output: the action mean (2) and the
  value (1); a state-independent ``log_std`` (2), initially -0.5;
- initial values, drawn from the generator in layer order: every trunk
  weight lecun-normal truncated to two standard deviations, stored [out,
  in(, kh, kw)]; the mean head orthogonal with gain 0.01, the value head
  orthogonal with gain 1; biases zero.

The Gaussian policy, GAE and the PPO loss's terms are learner.py's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from simbench.reference import learner

BF16 = torch.bfloat16
STAGES = (16, 32, 32)
HIDDEN = 256
ACTIONS = 2
N_CONV = 5 * len(STAGES)     # per stage its convolution and 2 blocks of 2


def _names():
    """The program's names of the parameters, in the order it registers
    them (the global norm and the all-reduce follow that order)."""
    names = {"log_std": "log_std"}
    for i in range(N_CONV):
        for s, t in (("w", "weight"), ("b", "bias")):
            names[f"conv{i}.{s}"] = f"ImpalaTrunk_0.Conv_{i}.{t}"
    for k, prog in (("fc", "ImpalaTrunk_0.Dense_0"), ("mean", "Dense_0"),
                    ("value", "Dense_1")):
        names[k + ".w"], names[k + ".b"] = prog + ".weight", prog + ".bias"
    return names


PROGRAM_NAMES = _names()


def init_params(frame_hwc, generator, device):
    """The initial parameters {name: float32 leaf} for frames (H, W, C)."""
    H, W, c = frame_hwc
    p = {}

    def lecun(shape, fan_in):
        w = torch.empty(shape, device=device)
        std = math.sqrt(1.0 / fan_in) / learner.TRUNC_STD
        torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                    generator=generator)
        return w

    i = 0
    for f in STAGES:
        for _ in range(5):
            p[f"conv{i}.w"] = lecun((f, c, 3, 3), 9 * c)
            p[f"conv{i}.b"] = torch.zeros(f, device=device)
            c, i = f, i + 1
        H, W = -(-H // 2), -(-W // 2)
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


def _same(n, k, s):
    """XLA's SAME padding of one side of n: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(p, i, x, q):
    """Convolution i (3x3, stride 1, SAME: one pixel each side) plus its
    bias, in bfloat16."""
    y = F.conv2d(q(x), q(p[f"conv{i}.w"].to(BF16)), None, 1, (1, 1))
    return y + p[f"conv{i}.b"].to(BF16)[:, None, None]


def _pool(x):
    """The 3x3 stride-2 max pool with SAME padding: -inf where it pads."""
    (top, bottom), (left, right) = _same(x.shape[2], 3, 2), \
        _same(x.shape[3], 3, 2)
    return F.max_pool2d(F.pad(x, (left, right, top, bottom),
                              value=-math.inf), 3, 2)


def forward(p, frames, fp8=False):
    """(mean [B, 2], log_std [2], value [B]) of uint8 frames [B, H, W, C].
    ``fp8`` rounds every convolution's and the dense layer's input and
    weight through float8 (learner.py's control)."""
    q = learner._fp8 if fp8 else (lambda t: t)
    # cuDNN runs bfloat16 convolutions channels-last
    x = frames.permute(0, 3, 1, 2).to(BF16, memory_format=torch.channels_last)
    x = x / torch.full((), 255.0, dtype=BF16, device=x.device)
    for s in range(len(STAGES)):
        x = _pool(_conv(p, 5 * s, x, q))
        for b in range(2):
            r = _conv(p, 5 * s + 2 * b + 1, F.relu(x), q)
            x = x + _conv(p, 5 * s + 2 * b + 2, F.relu(r), q)
    h = F.relu(x).permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    h = torch.matmul(q(h), q(p["fc.w"].to(BF16)).t()) + p["fc.b"].to(BF16)
    h = F.relu(h).to(torch.float32)
    mean = torch.matmul(h, p["mean.w"].t()) + p["mean.b"]
    value = torch.matmul(h, p["value.w"].t()) + p["value.b"]
    return mean, p["log_std"], value[:, 0]


def loss(p, frames, action, logp_old, adv, ret, hp, fp8=False):
    """The minibatch's PPO loss, learner.loss's terms on this network."""
    mean, log_std, value = forward(p, frames, fp8)
    ratio = torch.exp(learner.log_prob(action, mean, log_std) - logp_old)
    a = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    clipped = torch.clamp(ratio, 1.0 - hp["clip_eps"], 1.0 + hp["clip_eps"])
    policy = -torch.minimum(ratio * a, clipped * a).mean()
    v = 0.5 * ((value - ret) ** 2).mean()
    return policy + hp["vf_coef"] * v - hp["ent_coef"] * learner.entropy(
        log_std)
