"""Loop of data-parallel fused PPO: ``make_sharded_ppo(cfg,
stack_maps(config["maps"]), num_envs, PPOConfig(**ppo), fused=True)``'s
``train_step`` back to back on ``traffic["world"]`` ranks, as a
synchronous data-parallel trainer calls it.

The harness's process is rank 0 (``cuda:0``; the CPU in the harness's own
tests). It starts ranks 1.. as processes running this module (``python -m
simbench.loops.ppo_dp <job.json> <rank>``, the environment that torchrun
sets), and every rank joins one group through the program's ``make_mesh``:
NCCL with rank r on ``cuda:r``, gloo on the CPU. Every rank runs the same
iterations, and so the same collectives, in the same order: before each
one rank 0 alone decides what comes next (an iteration, a traced
iteration, the end) and tells the others with one broadcast of a
one-element tensor. Timing and tracing are rank 0's.

Set-up builds each rank's learner from the seed and drives it through its
first ``setup_iters`` iterations, recording the first optimizer step (on
rank 0: its first minibatch's loss, the averaged gradient as Adam got it;
on every rank: the parameters after it) and the reset blob; those
iterations warm every shape. Each iteration of the window ends in a
synchronise on rank 0. ``free()`` ends the ranks: each drops its learner,
leaves the group, computes its share of the reference's first step
(reference/ppo_dp.py) on its own card and writes it, its reset blob and
its parameters after the first step to the job's directory; rank 0 does
the same for its share, then joins every rank under ``JOIN_S``. The check
compares them with the reference's step on the averaged gradient. A rank
that exits before the end, or with an error, ends rank 0 at once with exit
code 1 (no collective can be left waiting); a rank whose rank 0 has gone
ends itself.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from simbench import cells, faults_dp
from simbench import trace as tr
from simbench.counts import impala as impala_flops
from simbench.counts import policy as flops
from simbench.reference import fused as ref_fused
from simbench.reference import ppo as ref_ppo
from simbench.reference import ppo_dp as ref_dp

# what rank 0 tells the other ranks before each step
STOP, TRAIN, TRACED = 0, 1, 2
# how long free() waits for the ranks to write their shares and exit
JOIN_S = 600.0
# how often a watcher looks at the other processes
POLL_S = 0.2


def _init_seed(seed):
    return int(np.random.SeedSequence(int(seed))
               .generate_state(1, np.uint64)[0])


class _Rank:
    """One rank's learner: the group joined through ``make_mesh``, the
    sharded learner built from the seed and driven through its set-up
    iterations, and its first optimizer step."""

    def __init__(self, config, traffic, seed, device):
        import dtown_torch
        from dtown_torch.learn import ppo as P
        from dtown_torch.parallel.mesh import make_mesh
        from dtown_torch.parallel.shard import make_sharded_ppo

        self.mesh = make_mesh(device)
        self.device = self.mesh.device
        self.ppo = P.PPOConfig(**traffic["ppo"])
        self.maps = dtown_torch.stack_maps(config["maps"])
        cfg = dtown_torch.EnvConfig(**config["env"])
        self.B = int(config["num_envs"]) // self.mesh.world
        _, init, self.train = make_sharded_ppo(
            cfg, self.maps, int(config["num_envs"]), self.ppo, self.mesh,
            fused=True)
        self.ts = init(_init_seed(seed))
        self.blob0 = self.ts.env_states[0].clone()
        net = self.ts.net
        self.theta0 = {k: v.detach().clone()
                       for k, v in net.named_parameters()}
        names = {id(p): k for k, p in net.named_parameters()}
        # the first optimizer step: its minibatch's loss, the gradient as
        # Adam got it (its first moment over 1 - beta1), the parameters
        # after it
        self.loss1, self.first, self.after1 = None, {}, None

        def grab(optimizer, args, kwargs):
            if self.after1 is None:
                b1 = optimizer.param_groups[0]["betas"][0]
                for p, s in optimizer.state.items():
                    self.first[names[id(p)]] = (s["exp_avg"].detach()
                                                / (1.0 - b1))
                self.after1 = {k: v.detach().clone()
                               for k, v in net.named_parameters()}

        loss_fn = P.ppo_loss

        def first_loss(*args):
            out = loss_fn(*args)
            if self.loss1 is None:
                self.loss1 = float(out[0].detach())
            return out

        hook = self.ts.opt.register_step_post_hook(grab)
        P.ppo_loss = first_loss
        try:
            for _ in range(int(traffic["setup_iters"])):
                self.ts, _ = self.train(self.ts)
        finally:
            P.ppo_loss = loss_fn
            hook.remove()
        if self.after1 is None:     # no optimizer step was taken
            self.after1 = self.theta0
        tr.sync(self.device.type)

    def command(self, cmd=None):
        """Rank 0 sends ``cmd``; every other rank returns what it got."""
        t = torch.tensor([STOP if cmd is None else cmd], dtype=torch.int64,
                         device=self.device)
        torch.distributed.broadcast(t, 0, group=self.mesh.group)
        return cmd if cmd is not None else int(t.item())

    def iteration(self):
        self.ts, _ = self.train(self.ts)

    def traced_iteration(self, update_ms=None):
        """One iteration through train_step's pieces, drawn as it draws
        them; rank 0 (``update_ms`` a list) marks them with the harness's
        spans and CUDA events around the update. No rank averages the
        iteration's metrics here."""
        on = update_ms is not None
        ts, T, B = self.ts, self.ppo.rollout_len, self.B
        local = self.train.local
        noise = torch.randn((T, B, 2), generator=ts.generator,
                            device=self.device)
        perms = torch.stack([torch.randperm(T * B, generator=ts.generator,
                                            device=self.device)
                             for _ in range(self.ppo.epochs)])
        with tr.span("rollout", on):
            ts, traj, last_value = local.rollout(ts, noise)
        with tr.span("gae", on):
            adv, ret = local.gae(traj, last_value)
        if on:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        with tr.span("update", on):
            ts, _ = local.update(ts, traj, adv, ret, perms, self.mesh.group)
        if on:
            ev[1].record()
            torch.cuda.synchronize()
            update_ms.append(ev[0].elapsed_time(ev[1]))
        self.ts = ts

    def close(self):
        """Drop the learner and leave the group."""
        self.ts = self.train = None
        torch.distributed.destroy_process_group()

    def results(self):
        return dict(blob0=self.blob0, after1=self.after1)


@contextlib.contextmanager
def _environ(values):
    """Set environment variables for a block, then restore them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _tail(path, n=3000):
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return ""


class Cell:

    def __init__(self, config, traffic, seed, device):
        from dtown_torch import EnvConfig
        from dtown_torch import types as ptypes
        from dtown_torch.parallel.mesh import free_port

        self.config, self.traffic, self.device = config, traffic, device
        self.seed, self.world = int(seed), int(traffic["world"])
        self.dir = tempfile.mkdtemp(prefix="simbench-ppo-dp-")
        job = os.path.join(self.dir, "job.json")
        with open(job, "w") as f:
            json.dump(dict(config=config, traffic=traffic, seed=self.seed,
                           device=device, dir=self.dir), f)
        ranks = {"WORLD_SIZE": str(self.world), "MASTER_ADDR": "localhost",
                 "MASTER_PORT": str(free_port())}
        path = os.environ.get("PYTHONPATH")
        self.procs, self._ending = [], threading.Event()
        try:
            for r in range(1, self.world):
                env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                           PYTHONPATH=cells.ROOT + (os.pathsep + path
                                                    if path else ""),
                           **ranks)
                with open(self._log(r), "w") as log:
                    self.procs.append(subprocess.Popen(
                        [sys.executable, "-m", "simbench.loops.ppo_dp",
                         job, str(r)], cwd=cells.ROOT, env=env,
                        stdout=log, stderr=subprocess.STDOUT))
            threading.Thread(target=self._watch, daemon=True).start()
            with _environ(dict(ranks, RANK="0", LOCAL_RANK="0")):
                self.rank = _Rank(config, traffic, seed, device)
        except BaseException:
            self._kill()
            raise
        self.map_host = self.rank.maps.numpy()
        self.kind_ids = dict(ptypes.OBJ_KIND_IDS)
        self.accept_deg = EnvConfig(**config["env"]).accept_start_angle_deg

    def _log(self, r):
        return os.path.join(self.dir, f"rank{r}.log")

    def _watch(self):
        """End this process at once when another rank has exited before
        free() asked it to, or with an error: a collective would wait for
        it for ever."""
        while not self._ending.wait(POLL_S):
            for r, p in enumerate(self.procs, 1):
                if p.poll() is not None:
                    print(f"simbench: rank {r} of {self.world} exited with "
                          f"{p.returncode} during the run:\n"
                          f"{_tail(self._log(r))}", file=sys.stderr,
                          flush=True)
                    self._kill()
                    os._exit(1)

    def _kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()

    def _step(self, cmd, update_ms=None):
        self.rank.command(cmd)
        if cmd == TRACED:
            self.rank.traced_iteration(update_ms)
        else:
            self.rank.iteration()
            tr.sync(self.device)

    def window(self, seconds, trace):
        record, iters = None, 0
        t0 = time.perf_counter()
        if trace:
            update_ms = []
            n = int(self.traffic["trace_iters"])
            record = tr.profile(lambda: [self._step(TRACED, update_ms)
                                         for _ in range(n)])
            record.pop("result")
            record.update(iterations=n, update_ms=sum(update_ms) / n)
            iters += n
        while True:
            self._step(TRAIN)
            iters += 1
            t1 = time.perf_counter()
            if t1 - t0 >= seconds:
                break
        rate = iters * self.rank.ppo.rollout_len * int(
            self.config["num_envs"]) / (t1 - t0)
        return dict(train_env_steps_per_s=rate), record, iters

    def free(self):
        """End the ranks and gather every rank's share of the check."""
        rank = self.rank
        self._ending.set()
        rank.command(STOP)
        tr.sync(self.device)
        mine = rank.results()
        self.theta0, self.loss1, self.first = (rank.theta0, rank.loss1,
                                               rank.first)
        device = rank.device
        rank.close()
        self.rank = rank = None
        share = ref_dp.rank_share(self.config, self.traffic["ppo"],
                                  _init_seed(self.seed), 0, self.world,
                                  device)
        deadline = time.monotonic() + JOIN_S
        while any(p.poll() is None for p in self.procs) and \
                time.monotonic() < deadline:
            time.sleep(POLL_S)
        bad = [(r, p.poll()) for r, p in enumerate(self.procs, 1)
               if p.poll() != 0]
        self._kill()
        try:
            if bad:
                raise RuntimeError("\n".join(
                    f"rank {r} of {self.world} exited with {code} (None: "
                    f"still running at the {JOIN_S} s limit):\n"
                    f"{_tail(self._log(r))}" for r, code in bad))
            self.ranks = [dict(mine, share=share)] + [
                torch.load(os.path.join(self.dir, f"rank{r}.pt"),
                           map_location=device, weights_only=True)
                for r in range(1, self.world)]
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)

    def layer_inputs(self, record):
        env = self.config["env"]
        f_fwd = impala_flops.impala_forward_flops(
            env["camera_height"], env["camera_width"],
            1 if env.get("grayscale") else 3)
        record["flops"] = record["iterations"] * flops.ppo_iteration_flops(
            f_fwd, self.traffic["ppo"],
            int(self.config["num_envs"]) // self.world)
        return record

    def check(self, control=False):
        """The stack's compiled maps and every rank's reset poses against
        the towns worked out from the YAMLs alone; every rank's reset blob
        and rank 0's initial parameters (exact); the parameters after the
        first optimizer step across the ranks (exact); rank 0's first
        minibatch's loss, the averaged gradient as Adam got it and the
        change of the parameters, the last two by the worst leaf, against
        the reference (or the float8 control in the program's place)."""
        hp = self.traffic["ppo"]
        blobs = [r["blob0"] for r in self.ranks]
        if control:
            device = next(iter(self.theta0.values())).device
            shares, first, after1 = ref_dp.first_step(
                self.config, hp, _init_seed(self.seed), self.world, device,
                control=True)
            start = ref_dp.control_town_readings(
                self.config, device, [s["blob0"] for s in shares])
        else:
            shares = [r["share"] for r in self.ranks]
            first, after1 = ref_dp.combine(
                shares[0]["theta0"], [s["grads"] for s in shares], hp)
            start = ref_dp.town_readings(self.config, self.map_host,
                                         self.kind_ids, blobs,
                                         self.accept_deg)
        theta0 = shares[0]["theta0"]
        moved = ref_ppo.moved_leaves(first)
        mine = self.ranks[0]["after1"]
        prog_loss = float("inf") if self.loss1 is None else self.loss1
        return dict(
            start,
            reset_max_abs=max(ref_fused.max_abs(s["blob0"], b)
                              for s, b in zip(shares, blobs)),
            init_max_abs=max(ref_fused.max_abs(theta0[k], self.theta0[k])
                             for k in theta0),
            ranks_gap=max((ref_fused.max_abs(r["after1"][k], mine[k])
                           for r in self.ranks[1:] for k in mine),
                          default=0.0),
            loss_gap=abs(prog_loss - shares[0]["loss"]) / max(
                abs(shares[0]["loss"]), 1e-30),
            grad_gap=ref_ppo.leaf_gaps(self.first, first),
            change_gap=ref_ppo.leaf_gaps(
                {k: mine[k] - self.theta0[k] for k in moved},
                {k: after1[k] - theta0[k] for k in moved}))


def _watch_parent():
    """End this rank when the process that started it has gone."""
    parent = os.getppid()
    while True:
        time.sleep(POLL_S)
        if os.getppid() != parent:
            os._exit(1)


def main(argv):
    """Rank ``argv[1]`` of the job in the file ``argv[0]``: set up, follow
    rank 0's commands, then write this rank's share of the check."""
    with open(argv[0]) as f:
        job = json.load(f)
    r = int(argv[1])
    threading.Thread(target=_watch_parent, daemon=True).start()
    with contextlib.ExitStack() as stack:
        faults_dp.plant_from_environment(stack)
        rank = _Rank(job["config"], job["traffic"], job["seed"],
                     job["device"])
        while True:
            cmd = rank.command()
            if cmd == TRAIN:
                rank.iteration()
            elif cmd == TRACED:
                rank.traced_iteration()
            else:
                break
    out = rank.results()
    device = rank.device
    rank.close()
    out["share"] = ref_dp.rank_share(
        job["config"], job["traffic"]["ppo"], _init_seed(job["seed"]), r,
        int(job["traffic"]["world"]), device)
    path = os.path.join(job["dir"], f"rank{r}.pt")
    torch.save(out, path + ".tmp")
    os.replace(path + ".tmp", path)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
