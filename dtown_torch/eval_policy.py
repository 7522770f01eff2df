"""Closed-loop evaluation of a trained policy checkpoint.

Counterpart of scripts/eval_policy.py. Loads the parameters that
``python -m dtown_torch.train_ppo --ckpt DIR`` saved (a whole training
state, or a bare state dict), drives a batch of envs on the device with
the deterministic policy tanh(mean) (or a sampled one), and reports the
episode statistics: mean return, episode length, crash rate, survival;
on the Nav task the goal success rate and steps to the goal. Optionally
writes a GIF of one env driving (PIL, imported there) or streams it to a
browser (utils.viewer.LiveViewer). Runs on the card unless ``--cpu``.

    python -m dtown_torch.train_ppo --map small_loop --obs state \\
        --iters 60 --ckpt ppo_ck
    python -m dtown_torch.eval_policy --ckpt ppo_ck --map small_loop \\
        --obs state --envs 256 --steps 500
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def load_params(path: str):
    """The network's state dict in the snapshot at ``path``: the ``net``
    of a whole training state, or the snapshot itself when it is a bare
    state dict."""
    from dtown_torch.utils import checkpoint

    tree = checkpoint.restore_any(path)
    return tree["net"] if "net" in tree else tree


def make_obs_fn(cfg, v_step):
    """obs_of(states) -> the policy's batched observation of a step-path
    batch (frames [B, H, W, C] through the row-fed kernels with
    renderer="pallas", else the ray-caster or state vectors)."""
    from dtown_torch import env

    def obs_of(states):
        return env.render_obs_batch(cfg, v_step.maps, states,
                                    pack=v_step.pack)

    return obs_of


def episode_records(rewards: np.ndarray, dones: np.ndarray):
    """Completed-episode records (length, terminal reward, return) from
    [T, E] reward and done arrays. An episode is a span ending at a done
    step; each env's trailing partial span is dropped, as the reference's
    scripts tally per-episode reward on ``done``."""
    T, E = rewards.shape
    recs = []
    for e in range(E):
        acc, n = 0.0, 0
        for t in range(T):
            acc += float(rewards[t, e])
            n += 1
            if dones[t, e]:
                recs.append((n, float(rewards[t, e]), acc))
                acc, n = 0.0, 0
    return recs


def episode_stats(rewards: np.ndarray, dones: np.ndarray, recs=None):
    """Per-episode statistics derived from episode_records; a terminal
    reward of -1000 (the invalid-pose penalty) marks a crash."""
    recs = episode_records(rewards, dones) if recs is None else recs
    n_ep = len(recs)
    crashes = sum(1 for _, tr, _ in recs if tr <= -999.0)
    return {
        "episodes": n_ep,
        "mean_return": (float(np.mean([r for _, _, r in recs]))
                        if n_ep else None),
        "mean_ep_len": (float(np.mean([n for n, _, _ in recs]))
                        if n_ep else None),
        "crash_rate": crashes / n_ep if n_ep else None,
        "survived_full_horizon": int((~dones.any(axis=0)).sum()),
        "mean_step_reward": float(rewards.mean()),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--map", default="small_loop", nargs="+")
    ap.add_argument("--envs", type=int, default=256)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--obs", default="rgb", choices=["rgb", "state"])
    ap.add_argument("--trunk", default="nature", choices=["nature", "impala"])
    ap.add_argument("--renderer", default="pallas", choices=["xla", "pallas"])
    ap.add_argument("--domain-rand", action="store_true")
    ap.add_argument("--nav", action="store_true",
                    help="evaluate on the Nav task: goal success rate and "
                         "steps to the goal")
    ap.add_argument("--goal-in-obs", action="store_true",
                    help="the policy was trained goal-conditioned")
    ap.add_argument("--stochastic", action="store_true",
                    help="sample actions instead of tanh(mean)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gif", default=None,
                    help="write a GIF of env 0 driving under the policy")
    ap.add_argument("--gif-steps", type=int, default=300)
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="stream env 0 driving to a browser (LiveViewer)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    return ap.parse_args(argv)


def build(args):
    """(cfg, maps, net, device) of the flags, the network loaded from the
    checkpoint."""
    from dtown_torch import EnvConfig, load_map, stack_maps
    from dtown_torch.learn.networks import ActorCritic

    dev = torch.device("cpu" if args.cpu else "cuda")
    cfg = EnvConfig(obs_type=args.obs, camera_width=args.size,
                    camera_height=args.size, domain_rand=args.domain_rand,
                    renderer=args.renderer)
    names = args.map if isinstance(args.map, list) else [args.map]
    maps = stack_maps(names) if len(names) > 1 else load_map(names[0])
    C = cfg.obs_channels
    img = (args.size, args.size, C)
    if args.obs == "state":
        shape = (14,) if args.nav and args.goal_in_obs else (11,)
    else:
        shape = (img, (3,)) if args.nav and args.goal_in_obs else img
    net = ActorCritic(shape, trunk=args.trunk, device=dev)
    net.load_state_dict(load_params(args.ckpt))
    net.eval()
    return cfg, maps, net, dev


def policy_fn(net, stochastic, generator):
    def policy(obs):
        mean, log_std, _ = net(obs)
        if stochastic:
            noise = torch.randn(mean.shape, generator=generator,
                                device=mean.device)
            return torch.tanh(mean + torch.exp(log_std) * noise)
        return torch.tanh(mean)

    return policy


def evaluate(args, cfg, maps, net, dev):
    """Drive args.envs envs for args.steps: the statistics dict."""
    from dtown_torch import env, tasks

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    policy = policy_fn(net, args.stochastic,
                       torch.Generator(device=dev).manual_seed(args.seed + 7))
    if args.nav:
        v_reset, v_step = tasks.make_nav_vec(cfg, maps, args.envs,
                                             goal_in_obs=args.goal_in_obs,
                                             device=dev)
        states = v_reset(gen)
        obs = env.render_obs_batch(cfg, v_step.maps, states.env,
                                   pack=v_step.pack)
        if args.goal_in_obs:
            feats = tasks.goal_features(v_step.maps, states)
            obs = (torch.cat([obs, feats], -1) if cfg.obs_type == "state"
                   else (obs, feats))
    else:
        v_reset, v_step = env.make_vec_env(cfg, maps, args.envs, device=dev)
        states = v_reset(gen)
        obs = make_obs_fn(cfg, v_step)(states)
    rew, done = [], []
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(args.steps):
            states, out = v_step(states, policy(obs))
            obs = out.obs
            rew.append(out.reward)
            done.append(out.done)
    rew = torch.stack(rew).cpu().numpy()  # waits for the device
    done = torch.stack(done).cpu().numpy()
    dt = time.perf_counter() - t0
    recs = episode_records(rew, done)
    stats = episode_stats(rew, done, recs=recs)
    if args.nav:
        # a goal step pays +500 (the lane term is O(1), a crash -1000)
        ttg = [n for n, tr, _ in recs if tr > 400.0]
        n_eps = stats["episodes"] or 0
        stats.update({
            "goals_reached": len(ttg),
            "success_rate": len(ttg) / n_eps if n_eps else None,
            "goal_steps_frac": float((rew > 400.0).mean()),
            "mean_steps_to_goal": float(np.mean(ttg)) if ttg else None})
    stats.update({"envs": args.envs, "steps": args.steps,
                  "map": ",".join(args.map if isinstance(args.map, list)
                                  else [args.map]),
                  "obs": args.obs, "deterministic": not args.stochastic,
                  "steps_per_s": round(args.envs * args.steps / dt)})
    return stats


def drive_one(args, cfg, maps, net, dev, viewer=None):
    """Env 0 driving under the deterministic policy for at most
    args.gif_steps steps (until its episode ends): the frames, uint8
    [H, W, 3] numpy, from the ray-caster at >= 128x128."""
    import dataclasses

    from dtown_torch import env

    rgb_cfg = dataclasses.replace(
        cfg, obs_type="rgb", renderer="xla", auto_reset=False,
        camera_width=max(args.size, 128), camera_height=max(args.size, 128))
    v_reset, v_step = env.make_vec_env(
        dataclasses.replace(cfg, auto_reset=False), maps, 1, device=dev)
    state = v_reset(torch.Generator(device=dev).manual_seed(args.seed + 1))
    obs_of = make_obs_fn(cfg, v_step)
    policy = policy_fn(net, False, None)

    def frame(s):
        return env.render_obs_batch(rgb_cfg, v_step.maps, s)[0].cpu().numpy()

    frames = [frame(state)]
    with torch.no_grad():
        for t in range(args.gif_steps):
            state, out = v_step(state, policy(obs_of(state)))
            frames.append(frame(state))
            if viewer is not None:
                viewer.update(frames[-1],
                              caption=f"step {t} r={float(out.reward):+.2f}")
            if bool(out.done):
                break
    return frames


def write_gif(path, frames):
    """An animated GIF of the frames (PIL); raw frames to ``path.npy``
    where PIL is missing."""
    try:
        from PIL import Image
    except ImportError:
        np.save(path + ".npy", np.stack(frames))
        print(f"PIL missing; wrote raw frames to {path}.npy")
        return
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=33,
                 loop=0)
    print(f"wrote {len(frames)} frames to {path}")


def main(argv=None):
    args = parse_args(argv)
    cfg, maps, net, dev = build(args)
    stats = evaluate(args, cfg, maps, net, dev)
    print(json.dumps(stats))
    if args.gif or args.serve is not None:
        viewer = None
        if args.serve is not None:
            from dtown_torch.utils.viewer import LiveViewer

            viewer = LiveViewer(port=args.serve)
            print(f"live view: {viewer.url}", file=sys.stderr)
        try:
            frames = drive_one(args, cfg, maps, net, dev, viewer)
        finally:
            if viewer is not None:
                viewer.close()
        if args.gif:
            write_gif(args.gif, frames)
        else:
            print(f"streamed {len(frames)} frames")
    return stats


if __name__ == "__main__":
    main()
