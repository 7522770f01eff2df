"""Manual driving, headless.

Counterpart of the reference's ``manual_control.py`` over the port's gym
env (``dtown_torch.make``). Modes:

* TTY (the default when stdin is a terminal): curses keyboard driving
  (arrows/WASD steer, backspace resets, q quits) with an ASCII view of
  the camera image;
* ``--record``: a scripted lane-following controller drives and the
  frames go to an animated GIF (PIL; raw frames to ``.npy`` without it);
* ``--serve PORT``: the live view also streams to a browser
  (utils.viewer.LiveViewer), the stand-in for the reference's window.

curses, PIL and the viewer are imported only by the modes that use them.
Runs on the card unless ``--cpu``.

    python -m dtown_torch.manual_control --record --steps 100 --cpu
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def build_env(args):
    import dtown_torch

    return dtown_torch.make(args.env_name or args.map_name,
                            camera_width=args.width,
                            camera_height=args.height,
                            domain_rand=args.domain_rand,
                            distortion=args.distortion, seed=args.seed,
                            device="cpu" if args.cpu else "cuda")


def _make_viewer(args):
    if args.serve is None:
        return None
    from dtown_torch.utils.viewer import LiveViewer

    v = LiveViewer(port=args.serve)
    print(f"live view: {v.url}", file=sys.stderr)
    return v


def _lane_action(info):
    lp = info["Simulator"]["lane_position"]
    steer = 10.0 * lp["dist"] + 0.12 * lp["angle_deg"]
    return [0.5, float(np.clip(steer, -4, 4))]


def record(args):
    """Drive the lane controller for args.steps (or to the episode's end)
    and write the frames to args.out; returns (frames, return)."""
    env = build_env(args)
    viewer = _make_viewer(args)
    top = args.view == "top_down"
    try:
        obs = env.reset()
        frames = [env.render("top_down") if top else obs]
        obs, r, done, info = env.step([0.4, 0.0])
        ret = r
        frames.append(env.render("top_down") if top else obs)
        for t in range(args.steps - 1):
            if done:
                break
            obs, r, done, info = env.step(_lane_action(info))
            ret += r
            frames.append(env.render("top_down") if top else obs)
            if viewer is not None:
                viewer.update(frames[-1], caption=f"step {t} r={r:+.2f}")
    finally:
        if viewer is not None:
            viewer.close()
    try:
        from PIL import Image
    except ImportError:
        np.save(args.out + ".npy", np.stack(frames))
        print(f"PIL missing; wrote raw frames to {args.out}.npy")
        return frames, ret
    imgs = [Image.fromarray(np.asarray(f)) for f in frames]
    imgs[0].save(args.out, save_all=True, append_images=imgs[1:],
                 duration=33, loop=0)
    print(f"wrote {len(frames)} frames to {args.out}; return={ret:.1f}")
    return frames, ret


KEYS = {"up": [0.44, 0.0], "down": [-0.44, 0.0], "left": [0.35, 1.0],
        "right": [0.35, -1.0], "stop": [0.0, 0.0]}
SHADES = " .:-=+*#%@"


def ascii_view(obs, rows: int, cols: int):
    """The frame as lines of characters by luminance, at most rows x
    cols."""
    obs = np.asarray(obs)
    small = obs[::max(1, obs.shape[0] // rows), ::max(1, obs.shape[1] // cols)]
    lum = small.mean(axis=-1) / 255.0
    return ["".join(SHADES[int(v * (len(SHADES) - 1))] for v in line[:cols])
            for line in lum[:rows]]


def tty(args):
    import curses

    env = build_env(args)
    viewer = _make_viewer(args)
    keys = {curses.KEY_UP: "up", ord("w"): "up", curses.KEY_DOWN: "down",
            ord("s"): "down", curses.KEY_LEFT: "left", ord("a"): "left",
            curses.KEY_RIGHT: "right", ord("d"): "right", ord(" "): "stop"}

    def loop(scr):
        curses.curs_set(0)
        scr.nodelay(True)
        env.reset()
        action, ret = KEYS["stop"], 0.0
        while True:
            key = scr.getch()
            if key in (ord("q"), 27):
                break
            if key in (curses.KEY_BACKSPACE, 127):
                env.reset()
                action, ret = KEYS["stop"], 0.0
            elif key in keys:
                action = KEYS[keys[key]]
            obs, r, done, info = env.step(action)
            ret += r
            if viewer is not None:
                viewer.update(obs, caption=f"r={r:+.2f} ret={ret:+.1f}")
            if done:
                env.reset()
                ret = 0.0
            h, w = scr.getmaxyx()
            vh, vw = min(h - 2, 24), min(w - 1, 80)
            for y, line in enumerate(ascii_view(obs, vh, vw)):
                scr.addstr(y, 0, line)
            scr.addstr(vh, 0, f"r={r:+.2f} ret={ret:+.1f} speed="
                       f"{info['Simulator']['robot_speed']:.2f}  (q quit, "
                       f"bksp reset)")
            scr.refresh()

    try:
        curses.wrapper(loop)
    finally:
        if viewer is not None:
            viewer.close()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--env-name", default=None)
    ap.add_argument("--map-name", default="udem1")
    ap.add_argument("--domain-rand", action="store_true")
    ap.add_argument("--distortion", action="store_true")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--record", action="store_true",
                    help="headless: write a GIF instead of TTY driving")
    ap.add_argument("--view", default="camera",
                    choices=["camera", "top_down"],
                    help="--record viewpoint: the agent camera or the "
                         "bird's-eye map")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--out", default="dtown_torch_drive.gif")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="stream the live view to a browser on PORT (0 "
                         "picks a free port)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.record or not sys.stdin.isatty():
        return record(args)
    return tty(args)


if __name__ == "__main__":
    main()
