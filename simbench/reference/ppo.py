"""The plain reference of fused PPO: the program's first optimizer step
done again from the seed. The env is the reference's fused rollout
(reference/fused.py: its reset, state step and frame render); the learner
is reference/learner.py, written from the equations. The draws come from
the seed's generator in the order the program's iteration states: the
reset, then the network's initial values, then the policy noise [T, B, 2]
and the first epoch's permutation of the T*B transitions.

The control puts the trunk's operands through float8 (e4m3), the next
precision below bfloat16: every convolution's and the trunk's dense
layer's input and weight are rounded to it (straight through for the
gradient)."""
from __future__ import annotations

import torch

from simbench.reference import fused, learner
from simbench.reference.frozen.ops import state_kernel as sk


def frames_nhwc(config, planes):
    """The render's planes uint8 [B, C, S, 128] as frames [B, H, W, C] (a
    view: S * 128 holds the H * W pixels of a channel row by row)."""
    H, W = config["env"]["camera_height"], config["env"]["camera_width"]
    return planes.reshape(planes.shape[0], planes.shape[1], H,
                          W).permute(0, 2, 3, 1)


def first_step(config, hp, init_seed, device, control=False):
    """(initial blob, initial parameters, the first minibatch's loss, the
    first gradient as Adam got it, the parameters after the first optimizer
    step), the parameters as {the program's name: tensor}: the reset, the
    first rollout, GAE and the first minibatch of the first epoch."""
    ref = fused.build(config, device)
    B, T = ref.num_envs, int(hp["rollout_len"])
    n, mb = T * B, T * B // int(hp["minibatches"])
    gen = torch.Generator(device=device).manual_seed(init_seed)
    blob = fused.init_blob(ref, gen)
    blob0 = blob
    planes = fused.render(ref, blob)
    p = learner.init_params(tuple(frames_nhwc(config, planes).shape[1:]),
                            gen, device)
    theta0 = {k: v.detach().clone() for k, v in p.items()}
    noise = torch.randn((T, B, 2), generator=gen, device=device)
    perm = torch.randperm(n, generator=gen, device=device)
    obs = torch.empty((T,) + tuple(planes.shape), dtype=planes.dtype,
                      device=device)
    logp, value, reward = (torch.empty((T, B), device=device)
                           for _ in range(3))
    act = torch.empty((T, B, 2), device=device)
    done = torch.empty((T, B), dtype=torch.bool, device=device)
    with torch.no_grad():
        for t in range(T):
            mean, log_std, v = learner.forward(
                p, frames_nhwc(config, planes), control)
            a = mean + torch.exp(log_std) * noise[t]
            obs[t], act[t], value[t] = planes, a, v
            logp[t] = learner.log_prob(a, mean, log_std)
            blob = fused.step(ref, blob, torch.tanh(a))
            planes = fused.render(ref, blob)
            reward[t] = blob[sk.F_REWARD]
            done[t] = blob[sk.F_DONE] > 0.5
        last = learner.forward(p, frames_nhwc(config, planes), control)[2]
    adv, ret = learner.gae(reward, done, value, last, hp["gamma"],
                           hp["gae_lambda"], hp["reward_scale"])
    idx = perm[:mb]
    o, a, lp, ad, rt = (x.flatten(0, 1)[idx] for x in (obs, act, logp, adv,
                                                        ret))
    del obs
    leaves = list(p.values())
    opt = torch.optim.Adam(leaves, lr=hp["lr"], betas=(0.9, 0.999),
                           eps=1e-8)
    loss = learner.loss(p, frames_nhwc(config, o), a, lp, ad, rt, hp,
                        control)
    loss.backward()
    learner.clip_global_norm_(leaves, hp["max_grad_norm"])
    opt.step()
    name = learner.PROGRAM_NAMES
    first = {name[k]: opt.state[v]["exp_avg"].detach() / (1 - 0.9)
             for k, v in p.items()}
    after1 = {name[k]: v.detach().clone() for k, v in p.items()}
    return (blob0, {name[k]: v for k, v in theta0.items()},
            float(loss.detach()), first, after1)


def leaf_gaps(prog, ref, keep=None):
    """The worst leaf's gap of norms: |‖prog‖ - ‖ref‖| over the larger of
    the reference leaf's norm and the median leaf's, over the leaves in
    ``keep`` (all when None)."""
    names = [k for k in ref if keep is None or k in keep]
    norms = {k: float(ref[k].double().norm()) for k in names}
    med = sorted(norms.values())[len(norms) // 2]
    # a leaf the program never produced (an optimizer that never stepped)
    # reads a norm of 0
    got = {k: float(prog[k].double().norm()) if k in prog else 0.0
           for k in names}
    return max(abs(got[k] - norms[k]) / max(norms[k], med, 1e-30)
               for k in names)


def moved_leaves(first):
    """Leaves whose first gradient is not nought to rounding: a norm at
    least a thousandth of the median leaf's."""
    norms = {k: float(v.double().norm()) for k, v in first.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return {k for k, v in norms.items() if v >= 1e-3 * med}
