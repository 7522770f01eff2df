"""Loop of the fused rollout (``dtown_torch.make_fused_rollout``): a
closed loop of chunks of ``chunk_steps`` fused steps, as a synchronous
trainer collects its trajectory.

Each step's action for each env is drawn uniformly from [action_low,
action_high]^2 (an untrained policy on the gym action space) out of a bank
made on the device at set-up; every step's frames, rewards and dones stay
referenced until the chunk ends, and each chunk ends in a synchronise.
After the window the reference checks the compiled map and every spawn
pose against the town (reference/town.py), the reset blob, every state
step of the last chunk and the frames of ``check_frames`` of its steps
drawn from the seed.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from simbench import trace as tr
from simbench.counts import k1 as k1c
from simbench.counts import k2 as k2c
from simbench.counts.peaks import bound_ms
from simbench.reference import fused as ref_fused

K1_KERNEL = "state_step_kernel"
K2_KERNEL = "blob_render_kernel"


def p95(values):
    """The 95th percentile of all values (nearest rank)."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


class Cell:
    """One run of a fused-rollout cell: set-up in the constructor, then
    ``window``, then ``check`` (or ``check(control=True)``)."""

    def __init__(self, config, traffic, seed, device):
        import dtown_torch
        from dtown_torch import types as ptypes

        self.config, self.traffic, self.device = config, traffic, device
        ss = np.random.SeedSequence(int(seed)).generate_state(3, np.uint64)
        self.init_seed, act_seed, sample_seed = (int(s) for s in ss)
        self.B = int(config["num_envs"])
        self.T = int(traffic["chunk_steps"])
        cfg = dtown_torch.EnvConfig(**config["env"])
        maps = dtown_torch.load_map(config["map"])
        # the compiled map (numpy) and its vocabulary, for the check
        self.map_host = maps.numpy()
        self.kind_ids = dict(ptypes.OBJ_KIND_IDS)
        self.accept_deg = cfg.accept_start_angle_deg
        init_blob, self.fused_step, _ = dtown_torch.make_fused_rollout(
            cfg, maps, self.B, device=device)
        self.blob = init_blob(
            torch.Generator(device=device).manual_seed(self.init_seed))
        self.blob0 = self.blob.clone()
        lo, hi = float(traffic["action_low"]), float(traffic["action_high"])
        self.bank = torch.rand(
            (int(traffic["action_bank_steps"]), self.B, 2),
            generator=torch.Generator(device=device).manual_seed(act_seed),
            device=device) * (hi - lo) + lo
        rs = np.random.default_rng(sample_seed)
        self.frame_steps = sorted(rs.choice(
            self.T, size=min(self.T, int(traffic["check_frames"])),
            replace=False).tolist())
        self.k = 0          # chunks run so far
        self.last = None    # (blob before, chunk index, blobs, trajectory)
        self._chunk()       # warm-up: every shape the window uses
        self.warm_k = self.k

    def actions(self, k, j):
        return self.bank[(k * self.T + j) % self.bank.shape[0]]

    def _chunk(self, spans=False):
        self.last = None    # the trainer's previous trajectory is consumed
        before, blob = self.blob, self.blob
        blobs, traj = [], []
        for j in range(self.T):
            with tr.span("fused_step", spans):
                blob, out, obs = self.fused_step(blob, self.actions(self.k, j))
            blobs.append(blob)
            traj.append((obs, out.reward, out.done))
        with tr.span("chunk_sync", spans):
            tr.sync(self.device)
        self.blob = blob
        self.last = (before, self.k, blobs, traj)
        self.k += 1

    def window(self, seconds, trace):
        """Chunks until ``seconds`` have passed. Returns the end-to-end
        metrics' values and, with ``trace``, the traced record of the
        first ``trace_chunks`` chunks."""
        chunk_ms, record = [], None
        t0 = time.perf_counter()
        if trace:
            n = int(self.traffic["trace_chunks"])
            k0 = self.k

            def traced():
                for _ in range(n):
                    self._chunk(spans=True)
                # each step made a new blob: the references are enough
                return [self.last[2][j] for j in range(
                    0, self.T, self.T // int(self.traffic["count_blobs"]))]

            record = tr.profile(traced)
            record.update(steps=(self.k - k0) * self.T, envs=self.B,
                          count_blobs=record.pop("result"))
        while True:
            c0 = time.perf_counter()
            self._chunk()
            c1 = time.perf_counter()
            chunk_ms.append((c1 - c0) * 1e3)
            if c1 - t0 >= seconds:
                break
        steps = (self.k - self.warm_k) * self.T * self.B
        e2e = dict(env_steps_per_s=steps / (c1 - t0),
                   rollout_ms_p95=p95(chunk_ms))
        return e2e, record, self.k - self.warm_k

    def free(self):
        """Drop what the check does not read: the program and its tables."""
        self.fused_step = None

    def layer_inputs(self, record):
        """The traced record with the frozen bounds of each kernel a
        launch: K1 by bytes, K2 by bytes and instructions averaged over
        the blobs sampled from the traced chunks."""
        ref = ref_fused.build(self.config, self.device)
        nf = self.blob.shape[0]
        blobs = record.pop("count_blobs")
        bounds = {K1_KERNEL: bound_ms(k1c.k1_bytes(ref.st, nf, self.B), 0)}
        if ref.pk is not None:
            ops = sum(k2c.k2_ops(b, ref.pk) for b in blobs) / len(blobs)
            bounds[K2_KERNEL] = bound_ms(k2c.k2_bytes(ref.pk, self.B), ops)
        record["bounds"] = bounds
        return record

    def check(self, control=False):
        """The numbers compared: the compiled map and every spawn pose
        against the town worked out from the YAML alone; the reset blob,
        every state step of the last chunk and the frames of the sampled
        steps against the reference (or, with ``control``, against the
        bfloat16 control in the program's place). Returns {name: value}."""
        ref = ref_fused.build(self.config, self.device)
        step = ref_fused.control_step if control else ref_fused.step
        render = ref_fused.control_render if control else ref_fused.render
        b0 = ref_fused.init_blob(
            ref, torch.Generator(device=self.device).manual_seed(
                self.init_seed))
        if control:
            b0 = ref_fused._bf16(b0)
        out = dict(reset_max_abs=ref_fused.max_abs(b0, self.blob0))
        before, k, blobs, traj = self.last
        worst, mine = 0.0, [b0]
        for j in range(self.T):
            r = step(ref, before if j == 0 else blobs[j - 1],
                     self.actions(k, j))
            worst = max(worst, ref_fused.max_abs(r, blobs[j]))
            mine.append(r)
        out["state_max_abs"] = worst
        if ref.pk is not None:
            worst = 0.0
            for j in self.frame_steps:
                worst = max(worst, ref_fused.max_abs(render(ref, blobs[j]),
                                                     traj[j][0]))
            out["frame_max_abs"] = worst
        if control:
            out.update(ref_fused.control_town_readings(ref, self.config,
                                                       mine))
        else:
            out.update(ref_fused.town_readings(
                self.config, self.map_host, self.kind_ids,
                [self.blob0] + blobs, self.accept_deg))
        return out
