"""Train a PPO lane-following (or Nav) policy, on one card or data-parallel
over several, with crash-safe checkpoints and resume.

Counterpart of scripts/train_ppo.py, with its flags and defaults.
Observations never leave the device; the host reads the scalar metrics
once an iteration. Runs on the card unless ``--cpu`` is given (the
kernels' plain versions then run on the CPU).

    python -m dtown_torch.train_ppo --fused --map loop_obstacles --envs 4096
    python -m dtown_torch.train_ppo --cpu --fused --envs 16 --size 32 \
        --rollout 4 --iters 2
    torchrun --nproc_per_node 4 -m dtown_torch.train_ppo --envs 4096

Under torchrun (or any launcher that sets RANK / WORLD_SIZE) the step
path and ``--rnn`` train sharded over the ranks, one card each (NCCL;
gloo with ``--cpu``): parallel.make_sharded_ppo, every minibatch's
gradients averaged over the ranks. ``--fused`` trains on one device, as
the reference's does.

``--ckpt DIR`` writes the whole training state (parameters, optimizer,
the env state of the global batch in rank order, every rank's generator,
the iteration; the LSTM carry under ``--rnn``) at the end and, with
``--ckpt-every N``, every N iterations, through
utils.checkpoint.save_atomic; only rank 0 writes. ``--resume DIR``
continues such a run: on the same world size every rank continues its
own stream exactly; on another world size each rank's stream is derived
again from the shared seed and the iteration.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch
import torch.distributed as dist


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--map", default="small_loop", nargs="+")
    ap.add_argument("--envs", type=int, default=256)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--rollout", type=int, default=64)
    ap.add_argument("--domain-rand", action="store_true")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory; written at the end and, "
                         "with --ckpt-every, periodically")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save the whole training state to --ckpt every N "
                         "iterations (crash-safe: a killed run resumes "
                         "from the last snapshot with --resume)")
    ap.add_argument("--ckpt-keep", type=int, default=2,
                    help="snapshots kept in the --ckpt rotation")
    ap.add_argument("--resume", default=None,
                    help="restore a --ckpt snapshot and continue from its "
                         "iteration (also on another number of ranks)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--renderer", default="pallas", choices=["xla", "pallas"])
    ap.add_argument("--fused", action="store_true",
                    help="blob-carried rollouts through the fused kernels")
    ap.add_argument("--obs", default="rgb", choices=["rgb", "state"])
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ent-coef", type=float, default=0.01)
    ap.add_argument("--gamma", type=float, default=0.99)
    ap.add_argument("--gae-lambda", type=float, default=0.95)
    ap.add_argument("--clip-eps", type=float, default=0.2)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--minibatches", type=int, default=8)
    ap.add_argument("--reward-scale", type=float, default=0.02)
    ap.add_argument("--trunk", default="nature", choices=["nature", "impala"])
    ap.add_argument("--nav", action="store_true",
                    help="the Nav task (goal tiles); fused only")
    ap.add_argument("--nav-shaping", type=float, default=0.0,
                    help="Nav goal-distance shaping coefficient")
    ap.add_argument("--goal-in-obs", action="store_true",
                    help="add the agent-frame goal to the observations")
    ap.add_argument("--rnn", action="store_true",
                    help="recurrent (LSTM) policy on the step path")
    ap.add_argument("--rnn-hidden", type=int, default=128)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.ckpt_every and not args.ckpt:
        ap.error("--ckpt-every requires --ckpt")
    return args


def build(args, mesh=None):
    """(init, train_step, device) of the learner the flags select:
    init(seed) -> train state, train_step(ts) -> (ts, metrics). With a
    ``mesh`` (parallel.make_mesh) the step path and --rnn train sharded
    over its ranks."""
    from dtown_torch import EnvConfig, load_map, stack_maps
    from dtown_torch.learn.ppo import PPOConfig, make_ppo

    cfg = EnvConfig(obs_type=args.obs, camera_width=args.size,
                    camera_height=args.size, domain_rand=args.domain_rand,
                    renderer=args.renderer,
                    nav_shaping_coef=args.nav_shaping)
    names = [args.map] if isinstance(args.map, str) else args.map
    maps = stack_maps(names) if len(names) > 1 else load_map(names[0])
    ppo = PPOConfig(
        rollout_len=args.rollout, lr=args.lr, ent_coef=args.ent_coef,
        gamma=args.gamma, gae_lambda=args.gae_lambda,
        clip_eps=args.clip_eps, epochs=args.epochs,
        minibatches=args.minibatches, reward_scale=args.reward_scale,
        trunk=args.trunk)
    if args.rnn and (args.fused or args.nav):
        raise ValueError("--rnn runs on the step path: no --fused or --nav")
    if args.nav and not args.fused:
        raise ValueError("--nav requires --fused")
    if mesh is not None and args.fused and mesh.world > 1:
        raise ValueError("--fused trains on one device, as the reference's "
                         "does: run it without a launcher of several ranks")
    if mesh is not None and not args.fused:
        from dtown_torch.parallel.shard import make_sharded_ppo

        _, init, train = make_sharded_ppo(cfg, maps, args.envs, ppo, mesh,
                                          rnn=args.rnn,
                                          rnn_hidden=args.rnn_hidden)
        return init, train, mesh.device
    device = mesh.device if mesh is not None else \
        torch.device("cpu" if args.cpu else "cuda")
    if args.rnn:
        from dtown_torch.learn.ppo_rnn import make_ppo_rnn

        init_g, train = make_ppo_rnn(cfg, maps, args.envs, ppo,
                                     hidden=args.rnn_hidden, device=device)
    else:
        init_g, train = make_ppo(cfg, maps, args.envs, ppo, fused=args.fused,
                                 nav=args.nav, goal_in_obs=args.goal_in_obs,
                                 device=device)

    def init(seed):
        return init_g(torch.Generator(device=device).manual_seed(seed))

    return init, train, device


class Ranks:
    """This process's place among the ranks: ``world``, ``rank`` and the
    ``mesh`` (None when the trainer runs alone)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.world = mesh.world if mesh is not None else 1
        self.rank = mesh.rank if mesh is not None else 0

    def gather(self, x, dim=0):
        """The global batch of an env-batched tensor, in rank order."""
        from dtown_torch.parallel.mesh import gather_envs

        return x if self.mesh is None else gather_envs(x, self.mesh, dim)

    def barrier(self):
        if self.mesh is not None:
            dist.barrier(group=self.mesh.group)


def _env_map(tree, fn):
    """fn(tensor) over an env state (an EnvState, or its checkpoint form:
    dicts of fields, tuples, tensors); dataclasses become dicts."""
    if dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: _env_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_env_map(v, fn) for v in tree)
    return fn(tree)


def env_state_of(ts, ranks, fused):
    """The global batch's env state in checkpoint form: the fused path's
    (blob [NF, B], observation) with the blob gathered on its env axis
    (dim 1), or the step path's EnvState fields on dim 0."""
    if fused:
        blob, raw = ts.env_states
        return (ranks.gather(blob, 1).cpu(),
                _env_map(raw, lambda x: ranks.gather(x).cpu()))
    return _env_map(ts.env_states, lambda x: ranks.gather(x).cpu())


def env_slice_of(saved, sl, fused):
    """This rank's slice ``sl`` of a saved global env state."""
    if fused:
        blob, raw = saved
        return blob[:, sl], _env_map(raw, lambda x: x[sl])
    return _env_map(saved, lambda x: x[sl])


def payload(ts, it, args, ranks):
    """The whole training state entering iteration ``it``, in checkpoint
    form (utils.checkpoint.to_saved): parameters, optimizer, the global
    env state, every rank's generator state, the shared seed, the world
    size and the global env count; the LSTM carry under --rnn. Every rank
    takes part (the gathers); rank 0 writes it."""
    from dtown_torch.utils.checkpoint import to_saved

    gen = ts.generator.get_state()
    gens = ranks.gather(gen.to(ts.generator.device)[None]).cpu()
    state = dict(net=to_saved(ts.net), opt=to_saved(ts.opt),
                 env_states=env_state_of(ts, ranks, args.fused),
                 generators=[g.clone() for g in gens], seed=args.seed,
                 world=ranks.world, num_envs=args.envs, it=int(it))
    if hasattr(ts, "carry"):
        state["carry"] = tuple(ranks.gather(c).cpu() for c in ts.carry)
    return state


def restore_state(ts, path, args, ranks):
    """(ts, it): the snapshot at ``path`` loaded into this rank's fresh
    train state ``ts``: the parameters and optimizer whole, the rank's
    slice of the env state (and carry), and its generator (its own saved
    state on the same world size, else its stream derived again from the
    shared seed at the snapshot's iteration)."""
    from dtown_torch.parallel.shard import rank_seed
    from dtown_torch.utils import checkpoint

    saved = checkpoint.restore_any(path)
    if saved["num_envs"] != args.envs:
        raise ValueError(f"the checkpoint holds {saved['num_envs']} envs, "
                         f"--envs is {args.envs}")
    it = int(saved["it"])
    per = args.envs // ranks.world
    sl = slice(ranks.rank * per, (ranks.rank + 1) * per)
    checkpoint.load_into(ts.net, saved["net"])
    checkpoint.load_into(ts.opt, saved["opt"])
    ts = ts._replace(env_states=checkpoint.load_into(
        ts.env_states, env_slice_of(saved["env_states"], sl, args.fused)))
    if "carry" in saved:
        ts = ts._replace(carry=checkpoint.load_into(
            ts.carry, tuple(c[sl] for c in saved["carry"])))
    if saved["world"] == ranks.world:
        checkpoint.load_into(ts.generator, saved["generators"][ranks.rank])
    else:
        ts.generator.manual_seed(rank_seed(saved["seed"], ranks.rank, it))
    return ts, it


def main(argv=None):
    args = parse_args(argv)
    if "WORLD_SIZE" not in os.environ:
        return train_loop(args, None)
    from dtown_torch.parallel.mesh import make_mesh

    own = not dist.is_initialized()
    mesh = make_mesh("cpu" if args.cpu else "cuda")
    try:
        return train_loop(args, mesh)
    finally:
        if own:
            dist.destroy_process_group()


def train_loop(args, mesh):
    """main's loop over the iterations, alone (``mesh`` None) or as one
    rank of ``mesh``; returns the final train state."""
    from dtown_torch.utils import checkpoint
    from dtown_torch.utils.profiling import PhaseTimer

    ranks = Ranks(mesh)
    lead = ranks.rank == 0
    init, train, dev = build(args, mesh)
    if lead:
        print(f"devices: {ranks.world} x {dev.type}")
    timer = PhaseTimer()
    with timer.phase("init"):
        ts = init(args.seed)

    start = 0
    if args.resume:
        with timer.phase("restore"):
            ts, start = restore_state(ts, args.resume, args, ranks)
        if lead:
            print(f"resumed from {args.resume} at iter {start}")
        if start >= args.iters:
            if lead:
                print(f"checkpoint already at iter {start} >= --iters "
                      f"{args.iters}; nothing to do")
            return ts

    def save_ckpt(ts, it):
        # crash-safe: a kill at any instant leaves one intact snapshot
        with timer.phase("checkpoint"):
            state = payload(ts, it, args, ranks)
            if lead:
                checkpoint.save_atomic(args.ckpt, state, keep=args.ckpt_keep)
            ranks.barrier()
        if lead:
            print(f"saved full train state to {args.ckpt} (iter {it})",
                  file=sys.stderr, flush=True)

    steps_per_iter = args.envs * args.rollout
    for it in range(start, args.iters):
        with timer.phase("train", steps=steps_per_iter):
            ts, metrics = train(ts)
            metrics = {k: float(v) for k, v in metrics.items()}  # waits
        if lead and (it % args.log_every == 0 or it == args.iters - 1):
            print(json.dumps({"iter": it, **{k: round(v, 4)
                                             for k, v in metrics.items()}}),
                  flush=True)
        if args.ckpt_every and (it + 1) % args.ckpt_every == 0:
            # the snapshot is the state entering iteration it + 1
            save_ckpt(ts, it + 1)
    if lead:
        print(timer.report(), flush=True)
    if args.ckpt:
        save_ckpt(ts, args.iters)
    return ts


if __name__ == "__main__":
    main()
