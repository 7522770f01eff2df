"""Loop of fused PPO: ``make_ppo(cfg, maps, envs, PPOConfig(**ppo),
fused=True)``'s ``train_step`` back to back, as a trainer calls it.

Set-up builds the learner from the seed (network initialised on the
device) and drives it through its first ``setup_iters`` iterations
through ``train_step`` itself, recording its first optimizer step: that
minibatch's loss, the gradient as Adam got it (its first moment over
1 - beta1) and the parameters after it; those iterations warm every
shape, and the same learner goes on into the window. Each iteration of the
window ends in a synchronise, as a trainer reading its metrics does. After
the window the reference takes the first optimizer step again from the
seed (the first rollout, GAE, the first minibatch) and the numbers are
compared; the compiled map and the reset's spawn poses are judged against
the town worked out from the YAML alone. Later steps are not compared: an
independent reference departs from them by rounding that Adam and the
env amplify (PERF.md §2).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from simbench import trace as tr
from simbench.counts import policy as flops
from simbench.reference import fused as ref_fused
from simbench.reference import ppo as ref_ppo


class Cell:

    def __init__(self, config, traffic, seed, device):
        import dtown_torch
        from dtown_torch import types as ptypes
        from dtown_torch.learn import ppo as P

        self.config, self.traffic, self.device = config, traffic, device
        self.init_seed = int(np.random.SeedSequence(int(seed))
                             .generate_state(1, np.uint64)[0])
        self.B = int(config["num_envs"])
        self.ppo = P.PPOConfig(**traffic["ppo"])
        cfg = dtown_torch.EnvConfig(**config["env"])
        maps = dtown_torch.load_map(config["map"])
        # the compiled map (numpy) and its vocabulary, for the check
        self.map_host = maps.numpy()
        self.kind_ids = dict(ptypes.OBJ_KIND_IDS)
        self.accept_deg = cfg.accept_start_angle_deg
        init, self.train = P.make_ppo(cfg, maps, self.B, self.ppo,
                                      fused=True, device=device)
        self.ts = init(torch.Generator(device=device).manual_seed(
            self.init_seed))
        self.blob0 = self.ts.env_states[0].clone()
        net = self.ts.net
        self.theta0 = {k: v.detach().clone()
                       for k, v in net.named_parameters()}
        names = {id(p): k for k, p in net.named_parameters()}
        # the first optimizer step as the program takes it: its minibatch's
        # loss, the gradient as Adam got it (its first moment over
        # 1 - beta1) and the parameters after it
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
        tr.sync(self.device)

    def _traced_iteration(self, update_ms):
        """One iteration through train_step's pieces, drawn as it draws
        them, with CUDA events around the update."""
        ts, T, B = self.ts, self.ppo.rollout_len, self.B
        noise = torch.randn((T, B, 2), generator=ts.generator,
                            device=self.device)
        perms = torch.stack([torch.randperm(T * B, generator=ts.generator,
                                            device=self.device)
                             for _ in range(self.ppo.epochs)])
        with tr.span("rollout", True):
            ts, traj, last_value = self.train.rollout(ts, noise)
        with tr.span("gae", True):
            adv, ret = self.train.gae(traj, last_value)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        with tr.span("update", True):
            ts, _ = self.train.update(ts, traj, adv, ret, perms)
        ev[1].record()
        torch.cuda.synchronize()
        update_ms.append(ev[0].elapsed_time(ev[1]))
        self.ts = ts

    def window(self, seconds, trace):
        record, iters = None, 0
        t0 = time.perf_counter()
        if trace:
            update_ms = []
            n = int(self.traffic["trace_iters"])
            record = tr.profile(lambda: [self._traced_iteration(update_ms)
                                         for _ in range(n)])
            record.pop("result")
            record.update(iterations=n, update_ms=sum(update_ms) / n)
            iters += n
        while True:
            self.ts, _ = self.train(self.ts)
            tr.sync(self.device)
            iters += 1
            t1 = time.perf_counter()
            if t1 - t0 >= seconds:
                break
        rate = iters * self.ppo.rollout_len * self.B / (t1 - t0)
        return dict(train_env_steps_per_s=rate), record, iters

    def free(self):
        self.ts = self.train = None

    def layer_inputs(self, record):
        env = self.config["env"]
        f_fwd = flops.nature_forward_flops(
            env["camera_height"], env["camera_width"],
            1 if env.get("grayscale") else 3)
        record["flops"] = record["iterations"] * flops.ppo_iteration_flops(
            f_fwd, self.traffic["ppo"], self.B)
        return record

    def check(self, control=False):
        """The compiled map and the reset's spawn poses against the town
        worked out from the YAML alone; the reset blob and the initial
        parameters (exact); the first optimizer step's loss, gradient (as
        Adam got it) and change of the parameters, the last two by the
        worst leaf, against the reference (or the float8 control in the
        program's place)."""
        blob0, theta0, loss1, first, after1 = ref_ppo.first_step(
            self.config, self.traffic["ppo"], self.init_seed, self.device,
            control)
        moved = ref_ppo.moved_leaves(first)
        if control:
            start = ref_fused.control_town_readings(
                ref_fused.build(self.config, self.device), self.config,
                [ref_fused._bf16(blob0)])
        else:
            start = ref_fused.town_readings(
                self.config, self.map_host, self.kind_ids, [self.blob0],
                self.accept_deg)
        prog_loss = float("inf") if self.loss1 is None else self.loss1
        return dict(
            start,
            reset_max_abs=ref_fused.max_abs(blob0, self.blob0),
            init_max_abs=max(ref_fused.max_abs(theta0[k], self.theta0[k])
                             for k in theta0),
            loss_gap=abs(prog_loss - loss1) / max(abs(loss1), 1e-30),
            grad_gap=ref_ppo.leaf_gaps(self.first, first),
            change_gap=ref_ppo.leaf_gaps(
                {k: self.after1[k] - self.theta0[k] for k in moved},
                {k: after1[k] - theta0[k] for k in moved}))
