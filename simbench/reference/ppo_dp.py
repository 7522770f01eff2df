"""The plain reference of data-parallel fused PPO on a stack of maps: the
program's first optimizer step done again from the seed, rank by rank.

Each of the ``world`` ranks owns ``num_envs // world`` envs and draws from
a stream of its own, seeded with ``rank_seed(seed, rank)`` (the sharded
learner's contract: the shared seed plus an odd 64-bit constant times the
rank, modulo 2**63), in the order the program's iteration states: the
reset, the network's initial values (drawn on every rank although rank 0's
are the ones every rank starts from), the policy noise [T, B, 2] and the
first epoch's permutation of the T*B transitions. On the stack env b of a
rank starts on member b % n_maps of that rank's own slice, the rule the
fused sharded learner runs (its reset numbers its envs from 0 on every
rank). Each rank then runs its rollout from rank 0's initial parameters,
GAE and the first minibatch's loss and gradient (``rank_share``); the
gradients are averaged over the ranks in float32, then clipped and put
through Adam (``combine``).

The env is reference/fused.py's (the frozen state step and render, built
here on the stack), the network reference/impala.py, the rest
reference/learner.py. The control puts the trunk's operands through
float8, as reference/ppo.py's does.
"""
from __future__ import annotations

import numpy as np
import torch

from simbench.reference import fused, impala, learner
from simbench.reference import town as town_lib
from simbench.reference.frozen import map_loader
from simbench.reference.frozen import types as T
from simbench.reference.frozen.ops import state_kernel as sk
from simbench.reference.frozen.render import blob_raster as br
from simbench.reference.frozen.types import EnvConfig
from simbench.reference.ppo import frames_nhwc

RANK_MIX = 0x9E3779B97F4A7C15


def rank_seed(seed, rank):
    """The seed of ``rank``'s own stream."""
    return (seed + RANK_MIX * rank) % 2 ** 63


def build(config, device, num_envs):
    """The reference of a stack configuration (``config["maps"]``) for
    ``num_envs`` envs on ``device``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = EnvConfig(**config["env"])
    maps = map_loader.stack_maps(config["maps"])
    st = sk.device_tables(cfg, sk.build_tables(cfg, maps), device)
    plan = br.build_render_plan(cfg, maps)
    if plan is None:
        raise ValueError(f"{config['maps']}: no blob render plan")
    return fused.Reference(cfg, maps.to(device), st,
                           br.pack_plan(cfg, plan, device), num_envs,
                           maps.numpy())


def frame_shape(config):
    """(H, W, C) of the configuration's frames."""
    env = config["env"]
    return (env["camera_height"], env["camera_width"],
            1 if env.get("grayscale") else 3)


def _start(ref, config, seed, rank, device):
    """(rank ``rank``'s generator, its reset blob, the parameters its
    stream draws next)."""
    gen = torch.Generator(device=device).manual_seed(rank_seed(seed, rank))
    blob = fused.init_blob(ref, gen)
    return gen, blob, impala.init_params(frame_shape(config), gen, device)


def rank_share(config, hp, seed, rank, world, device, control=False):
    """Rank ``rank``'s part of the first step: {"blob0": its reset blob,
    "theta0": rank 0's initial parameters, "loss": its first minibatch's
    loss, "grads": that loss's gradient (float32, unclipped)}, the
    parameters under the program's names. Every rank draws its own
    parameters and then runs from rank 0's, which a rank other than 0
    draws again from rank 0's stream (its reset, then the network)."""
    B = int(config["num_envs"]) // world
    ref = build(config, device, B)
    T_, mb = int(hp["rollout_len"]), int(hp["rollout_len"]) * B // int(
        hp["minibatches"])
    gen, blob, p = _start(ref, config, seed, rank, device)
    if rank:
        p = _start(ref, config, seed, 0, device)[2]
    name = impala.PROGRAM_NAMES
    theta0 = {name[k]: v.detach().clone() for k, v in p.items()}
    blob0 = blob
    planes = fused.render(ref, blob)
    noise = torch.randn((T_, B, 2), generator=gen, device=device)
    perm = torch.randperm(T_ * B, generator=gen, device=device)
    obs = torch.empty((T_,) + tuple(planes.shape), dtype=planes.dtype,
                      device=device)
    logp, value, reward = (torch.empty((T_, B), device=device)
                           for _ in range(3))
    act = torch.empty((T_, B, 2), device=device)
    done = torch.empty((T_, B), dtype=torch.bool, device=device)
    with torch.no_grad():
        for t in range(T_):
            mean, log_std, v = impala.forward(
                p, frames_nhwc(config, planes), control)
            a = mean + torch.exp(log_std) * noise[t]
            obs[t], act[t], value[t] = planes, a, v
            logp[t] = learner.log_prob(a, mean, log_std)
            blob = fused.step(ref, blob, torch.tanh(a))
            planes = fused.render(ref, blob)
            reward[t] = blob[sk.F_REWARD]
            done[t] = blob[sk.F_DONE] > 0.5
        last = impala.forward(p, frames_nhwc(config, planes), control)[2]
    adv, ret = learner.gae(reward, done, value, last, hp["gamma"],
                           hp["gae_lambda"], hp["reward_scale"])
    idx = perm[:mb]
    o, a, lp, ad, rt = (x.flatten(0, 1)[idx] for x in (obs, act, logp, adv,
                                                        ret))
    del obs
    loss = impala.loss(p, frames_nhwc(config, o), a, lp, ad, rt, hp,
                       control)
    grads = torch.autograd.grad(loss, list(p.values()))
    return dict(blob0=blob0, theta0=theta0, loss=float(loss.detach()),
                grads={name[k]: g.detach() for k, g in zip(p, grads)})


def combine(theta0, grads, hp):
    """The first optimizer step from ``theta0`` on the ranks' gradients
    ``grads`` (one dict a rank, in rank order): their float32 mean (summed
    in rank order, then divided by the world size), clipped by global norm
    and put through Adam. Returns (the gradient as Adam got it, the
    parameters after the step), under the program's names."""
    device = next(iter(theta0.values())).device
    p = {k: theta0[k].detach().clone().to(device).requires_grad_()
         for k in impala.PROGRAM_NAMES.values()}
    for k, x in p.items():
        acc = grads[0][k].to(device).clone()
        for g in grads[1:]:
            acc += g[k].to(device)
        x.grad = acc / len(grads)
    leaves = list(p.values())
    opt = torch.optim.Adam(leaves, lr=hp["lr"], betas=(0.9, 0.999),
                           eps=1e-8)
    learner.clip_global_norm_(leaves, hp["max_grad_norm"])
    opt.step()
    first = {k: opt.state[v]["exp_avg"].detach() / (1 - 0.9)
             for k, v in p.items()}
    return first, {k: v.detach().clone() for k, v in p.items()}


def first_step(config, hp, seed, world, device, control=False):
    """(every rank's share, the gradient as Adam got it, the parameters
    after the first step), the ranks on ``device`` one after another."""
    shares = [rank_share(config, hp, seed, r, world, device, control)
              for r in range(world)]
    first, after1 = combine(shares[0]["theta0"],
                            [s["grads"] for s in shares], hp)
    return shares, first, after1


def _member_arrays(host, m, kind_ids, town, bf16=False):
    """fused.map_arrays of stack member ``m`` cut to its own grid and
    object budget (map_gap counts the objects), or None where the stack's
    padding holds a drivable tile or a lane."""
    one = host.map_at(m)
    arr, kinds = fused.map_arrays(one, kind_ids, bf16)
    H, W = town.drivable.shape
    pad = np.ones(arr["drivable"].shape, dtype=bool)
    pad[:H, :W] = False
    if arr["drivable"][pad].any() or arr["curve_mask"][pad].any():
        return None, kinds
    for f in ("drivable", "curves", "curve_mask"):
        arr[f] = arr[f][:H, :W]
    return arr, kinds


def town_readings(config, host, kind_ids, blobs, accept_deg, bf16=False):
    """fused.town_readings over a stack: ``map_gap``, the worst member's
    gap to its town; ``spawn_off_road``, the invalid spawns among each
    member's accepted bank entries and the reset poses in ``blobs`` (one
    reset blob a rank), each judged on its env's member."""
    gap, off = 0.0, 0
    for m, name in enumerate(config["maps"]):
        town = town_lib.Town(name)
        arr, kinds = _member_arrays(host, m, kind_ids, town, bf16)
        gap = max(gap, float("inf") if arr is None else
                  town_lib.map_gap(town, kinds, arr))
        one = host.map_at(m)
        deg = np.asarray(one.spawn_lane_deg)
        ok = np.asarray(one.spawn_mask) & (np.abs(deg) < accept_deg)
        pos, ang = np.asarray(one.spawn_pos)[ok], \
            np.asarray(one.spawn_angle)[ok]
        if bf16:
            pos, ang = (fused._bf16(torch.from_numpy(v)).numpy()
                        for v in (pos, ang))
        off += town_lib.off_road(town, pos[:, 0], pos[:, 2], ang)
        for b in blobs:
            b = b.detach().cpu()
            on = b[sk.F_MAPID] == m
            off += town_lib.off_road(town, *(b[f][on].double().numpy()
                                             for f in (sk.F_POS_X,
                                                       sk.F_POS_Z,
                                                       sk.F_ANGLE)))
    return dict(map_gap=gap, spawn_off_road=off)


def control_town_readings(config, device, blobs):
    """The control's start numbers: the reference's own stack and spawn
    banks in bfloat16 in the program's place, and its bfloat16 blobs."""
    ref = build(config, device, 1)
    return town_readings(config, ref.host, T.OBJ_KIND_IDS,
                         [fused._bf16(b) for b in blobs],
                         ref.cfg.accept_start_angle_deg, bf16=True)
