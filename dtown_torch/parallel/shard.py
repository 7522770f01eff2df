"""Sharded env stepping and PPO training over torch.distributed ranks.

Counterpart of dtown/parallel/shard.py. Each rank owns its slice of the
global env batch (parallel.mesh.env_sharding: ``num_envs // world`` envs
in rank order) and steps it on its own card, auto-resets included, with
the kernels of the path it runs (K1 and K2 on the fused rollout). The
learner's parameters are replicated: every minibatch's gradients are
averaged over the ranks by one all_reduce before the clip and Adam
(learn.ppo.pmean_grads_, the reference's pmean before tx.update), so
every rank takes the same step and the parameters stay bit-identical.

Random streams. The reference folds the shard index into one shared
key. Here each rank draws its env spawns, policy noise and minibatch
permutations from its own torch.Generator, seeded with
``rank_seed(seed, rank)``, which is ``seed`` itself on rank 0: a world of
one draws exactly what the unsharded learner draws from
``torch.Generator().manual_seed(seed)``. The network is drawn on every
rank and then broadcast from rank 0, so every rank starts from rank 0's
parameters, which are the unsharded learner's.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from dtown_torch.parallel.mesh import Mesh, env_sharding, make_mesh
from dtown_torch.utils.metrics import all_device_mean

# odd 64-bit constants (splitmix64's) that spread ranks and iterations
# over the seed space
_RANK_MIX = 0x9E3779B97F4A7C15
_ITER_MIX = 0xBF58476D1CE4E5B9


def rank_seed(seed: int, rank: int, it: int = 0) -> int:
    """The seed of ``rank``'s own stream, derived from the shared ``seed``
    (and the iteration ``it`` when a resume on another world size
    re-derives the streams). ``rank_seed(seed, 0) == seed``."""
    return (seed + _RANK_MIX * rank + _ITER_MIX * it) % 2 ** 63


def rank_generator(seed: int, mesh: Mesh, it: int = 0) -> torch.Generator:
    """A generator on this rank's device, seeded with its own stream."""
    return torch.Generator(device=mesh.device).manual_seed(
        rank_seed(seed, mesh.rank, it))


def broadcast_params(net: torch.nn.Module, mesh: Mesh, src: int = 0):
    """Every rank's parameters and buffers set to rank ``src``'s."""
    if mesh.world == 1:
        return
    with torch.no_grad():
        for t in net.state_dict().values():
            dist.broadcast(t, src=src, group=mesh.group)


def make_sharded_env(cfg, maps, num_envs: int, mesh: Mesh = None):
    """(mesh, reset, step) of this rank's slice of a global batch of
    ``num_envs`` envs (env.make_vec_env on the rank's device).
    reset(seed) draws the slice's states from the rank's own stream; on a
    stack env b of the global batch starts on member b % n_maps, as the
    reference's global reset does. step(states, actions) steps the slice.
    """
    from dtown_torch.env import make_vec_env

    mesh = mesh or make_mesh()
    sl = env_sharding(mesh, num_envs)
    v_reset, v_step = make_vec_env(cfg, maps, sl.stop - sl.start,
                                   device=mesh.device, env_offset=sl.start)

    def reset(seed: int):
        return v_reset(rank_generator(seed, mesh))

    return mesh, reset, v_step


def make_sharded_ppo(cfg, maps, num_envs: int, ppo=None, mesh: Mesh = None,
                     fused: bool = False, rnn: bool = False,
                     rnn_hidden: int = 128):
    """(mesh, init, train_step) of PPO data-parallel over the ranks of
    ``mesh`` (make_mesh() when None): each rank runs make_ppo (or, with
    ``rnn``, make_ppo_rnn) over its ``num_envs // world`` envs.

    init(seed) -> this rank's TrainState: env states from its own stream,
    the network broadcast from rank 0 (identical everywhere), the
    generator kept in the state. train_step(ts) -> (ts, metrics): one
    iteration with every minibatch's gradients averaged over the ranks,
    and the metrics averaged over them (all_device_mean).

    fused=True steps each rank's envs through the fused rollout (the
    blob's env axis, dim 1, and the observations' dim 0 are the rank's
    slice); rnn=True shards the recurrent learner, whose (c, h) carry is
    the rank's slice on dim 0. On a stack each rank's env b is on member
    b % n_maps of its own slice, as in the reference's shard_map."""
    from dtown_torch.learn.ppo import PPOConfig, make_ppo

    mesh = mesh or make_mesh()
    sl = env_sharding(mesh, num_envs)
    per = sl.stop - sl.start
    ppo = ppo or PPOConfig()
    if rnn:
        if fused:
            raise ValueError("rnn PPO runs on the step path: no fused")
        from dtown_torch.learn.ppo_rnn import make_ppo_rnn

        init_local, train_local = make_ppo_rnn(cfg, maps, per, ppo,
                                               hidden=rnn_hidden,
                                               device=mesh.device)
    else:
        init_local, train_local = make_ppo(cfg, maps, per, ppo, fused=fused,
                                           device=mesh.device)

    def init(seed: int):
        ts = init_local(rank_generator(seed, mesh))
        broadcast_params(ts.net, mesh)
        return ts

    def train_step(ts):
        ts, metrics = train_local(ts, axis_name=mesh.group)
        return ts, all_device_mean(metrics, mesh.group)

    train_step.local = train_local
    return mesh, init, train_step
