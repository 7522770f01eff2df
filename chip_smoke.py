#!/usr/bin/env python3
"""Smoke run of dtown_torch on one NVIDIA card: builds the CUDA kernels,
holds each against its plain torch version, drives the fused rollout
(the default bench configuration, then moving NPCs, domain randomization,
grayscale and state observations, then stacks of maps and the Nav task,
then fisheye, the reference's native 640x480 and triangle-mesh objects)
and the vectorized step API (make_vec) on a static-scene map, a row-fed
map and a domain-randomized map, then both with fisheye, the default
env surface (make_vec's defaults through the XLA ray-caster, a stack on
the step path, the gym env, the fused rollout past its render plan),
trains the PPO learner (dtown_torch.learn) on the fused rollout and the
step path, then data-parallel over ranks with checkpoints and resume
(dtown_torch.parallel, dtown_torch.train_ppo), runs the float32/bfloat16
throughput probe and the measurement tools (python -m dtown_torch.bench
and the others), and prints what it measured.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. the card's name and power limit (nvidia-smi);
  2. build the four kernel sources from dtown_torch/csrc (one nvcc each,
     in parallel), printing registers and spill of every specialisation
     and, per source, the kernel count, register range and the kernels
     that spill (state_kernel.cu and row_render.cu must spill nowhere);
  3. the fused RGB rollout on loop_obstacles, 64 envs 32x32, 5 steps, on
     the card vs on the CPU from the same blob;
  4. the fused rollout in each configuration, each with its own launch
     counts (4096 envs unless stated): the bench's default
     (loop_obstacles, 64x64 RGB); (a) BASELINE config 4, udem1 with domain
     randomization, 96x96 RGB; (b) town_dyn_duckiebots (both NPC kinds),
     64x64 RGB; (c) bigtown_pedestrians with domain randomization and
     grayscale, 64x64; (d) BASELINE config 2, small_loop grayscale 64x64,
     256 envs; (e) state observations on loop_pedestrians (the state
     kernel alone); npc10_state, state observations on the stack
     loop_pedestrians/town_dyn_duckiebots/metro (10 NPCs, whose state the
     state kernel keeps in shared memory); stacks of maps (stack_maps,
     env b on member b % n_maps), 64x64 RGB: stack3, BASELINE config 5's
     maps zigzag_dists/4way/udem1 at its 8192 envs; stack6, the 6-map
     curriculum stack of scripts/bench_all.sh; stack_npc_dr,
     town_dyn_duckiebots + udem1 with domain randomization (map-gated
     NPCs of both kinds, optional objects); nav_stack, the Nav task
     (make_fused_nav_rollout, goal_in_obs, no shaping as train_ppo.py
     defaults; its check runs goal-distance shaping 2.0) on stack3's
     maps; fisheye (scripts/bench_all.sh --distortion: loop_obstacles
     64x64, the fisheye ray planes); fisheye_dr (tests/test_fused_matrix.py
     distortion_dr: small_loop with domain randomization and fisheye, the
     NDC table path); native_res (bench_all.sh --width 640 --height 480
     --envs 512) and fisheye_native (the same with fisheye); tri_mesh
     (loop_obstacles plus one OBJ-registered object, the sample mesh of
     tests/test_objmesh.py, at mesh_fidelity="triangles"; then one fixed
     pose per env facing it, kernel vs plain, and the pixels a triangle
     won, which must be > 0). Each first
     holds both kernels against their plain versions for 12 steps through
     auto-resets (max_steps=5): the state blob max |diff| 0 on every row,
     frames max |diff| 0, the DR rows redrawn and the NPCs re-placed at a
     reset, respawns (and Nav goals, redrawn at resets) on
     drivable tiles of the env's own map; then times
     the configuration as given (CUDA events, 256 or 64 steps), checks
     its output, traces 32 steps with torch.profiler (device ms per
     launch, idle share, and the launch floor: a one-element op's device
     ms in the same trace, outside the window), times the plain versions
     on the timed run's last blob, holds both kernels against those
     outputs (same bars) and
     computes the bounds from that run's inputs (the blob render's by its
     own culls, blob_raster.kept and sphere_pass, and again without the
     view cull; frames of more than 2^25 pixels in all go through the plain
     version in slices of envs); then the state kernel on its edge states
     (k1_edge_blob) at 4096 envs, on udem1 with domain randomization and
     on npc10_state's 10-NPC stack: tile centres with headings across
     straight lanes (curve-select ties) and at k·π/4 on junctions, agents
     on static objects and NPC start poses, agents off the grid, every env
     reset in the first step; max |diff| 0 on every row of two steps;
  5. the vector env on the card vs the CPU at 64 envs 32x32 from the
     same states, 5 steps without auto-reset, on loop_obstacles (K3),
     town_dyn_duckiebots (K4, scripted bots), udem1 with domain
     randomization (K4), and loop_obstacles and bigtown with fisheye:
     poses within 1e-5, reward within 1e-4, discrete outputs equal, obs
     mean |diff| <= 0.01;
  6. the step path at full width: make_vec(<map>, 4096, renderer="pallas")
     (64x64 RGB, auto-reset, marking AA) on loop_obstacles, on bigtown, on
     udem1 with domain randomization, and on loop_obstacles and bigtown
     with fisheye (bench_all.sh --distortion), timed with CUDA events
     after a warm-up; row_render_static must launch on the static-scene
     runs, row_render on the others; uint8 [4096, 64, 64, 3] frames with
     std > 5 and finite rewards; the split between physics and render,
     and a torch.profiler trace of 32 steps (kernel device time per
     launch, idle share);
  7. K3 and K4 vs their plain versions on those runs' 4096-env states
     (max |diff| 0) and on the same envs posed 0.3-0.8 m from the map's
     objects, half facing one (max |diff| 0), the plain versions' times
     and the bounds, counted by the kernels' own culls (row_raster.
     row_kept, row_sphere_pass) like the blob render's;
  8. the default env surface (surface_phase), 4096 envs 64x64 with the
     default EnvConfig (auto-reset, marking AA, obj_lod_px 2.0) unless
     stated: (g) make_vec("loop_obstacles", 4096) with default arguments,
     renderer "xla", the XLA ray-caster as batched torch (no kernel):
     first the card vs the CPU on 8 envs 32x32 after 16 steps (poses 1e-5,
     rewards 1e-4, speeds 3e-4, discrete outputs equal, frames mean |diff|
     <= 0.25 and share > 1 <= 0.5%), then 64 timed steps (CUDA events;
     env-steps/s, peak memory, the render's share of a step on the host
     clock, the device's idle share over a profiler window), and, for
     information, the frames against the row-fed K3 on the same states at
     dtown's bar between renderers; (h) make_vec(stack3) timed the same
     way over 32 steps; (i) dtown_torch.make("loop_obstacles"), one env
     at 640x480: 200 steps with numpy frames (steps/s) and one top-down
     frame with the agent marker; (j) the fused rollout past the blob
     render's budget on one map (build/chip_smoke/dense_obstacles.yaml,
     56 objects): the
     state kernel and K4 once a step each, timed (device ms per launch),
     then both against their plain versions on the run's last blob and
     states (max |diff| 0) and on posed states, with the bounds; (k) the
     same on the stack udem1 x 4, frames from the ray-caster, the state
     kernel held as in (j);
  9. the PPO learner (dtown_torch.learn.make_ppo): (a) one fused
     iteration on loop_obstacles, 64 envs 32x32, rollout 4, 2 epochs x 2
     minibatches, on the card and on the CPU from the same parameters,
     blob, noise and permutations (dones equal, rewards within 1e-3, loss
     within 1e-2 relative, each parameter's update within cosine 0.9);
     (b) the bench's default configuration, loop_obstacles 4096 envs 64x64
     RGB, NatureCNN, PPOConfig() (rollout 128, 4 epochs x 8 minibatches of
     65,536): one
     warm-up and three timed iterations (CUDA events: rollout, update,
     training env-steps/s), the state kernel and the blob render 128
     launches each an iteration, a profiler window of one rollout (their
     device ms, idle share) and of one update, peak memory, the policy's
     FLOPs counted from its layer shapes and train_mfu against the dense
     bf16 peak, then both kernels against their plain versions on the
     last blob; (c) one Nav iteration on nav_stack (stack3's maps, 4096
     envs, goal in the observation, rollout 16: goal_frac); (d) a
     learning check, state observations on small_loop, 1024 envs, rollout
     32, 30 iterations, with tests/test_learning.py's bars; (e) one
     step-path iteration (make_ppo(fused=False), renderer="pallas",
     loop_obstacles 4096 envs 64x64, rollout 32) after a warm-up, with its
     env-steps/s, the static-scene row render launched;
  10. the throughput probe (K5, python -m dtown_torch.probes) in float32
     and bfloat16 at the reference probe's [4096, 32, 128], 256 steps:
     the probe's loop (its launches counted), the kernel vs its plain
     version on seeded inputs (max |diff| 0), the device time per launch
     from a trace of 64 launches of the probe's loop body (CUDA events,
     said so, and the trace's keys printed, if the trace misses it), the
     rate and the bound.
  11. training at scale (scale_phase): (a) in a fresh process under the
     deterministic settings (torch.use_deterministic_algorithms,
     cudnn.benchmark off, CUBLAS_WORKSPACE_CONFIG=:4096:8, set before CUDA
     starts), dtown_torch.parallel.make_sharded_ppo(fused=True) on an NCCL
     group of one at the bench config (loop_obstacles, 4096 envs, 64x64
     RGB, NatureCNN, PPOConfig()) against the unsharded make_ppo from the
     same seed, one iteration: parameters max |diff| 0 and metrics equal
     (rank 0's stream is the shared seed, and the all_reduce of one rank
     returns its input); then here, at the default settings, one warm-up
     and two timed iterations of the sharded learner (CUDA events:
     training env-steps/s beside train (b)'s of this run, K1/K2 128
     launches each an iteration, the gradient all_reduce timed alone), a
     traced rollout for K1/K2's device ms, and both kernels against their
     plain versions on its last blob; (b) two ranks on the card over gloo
     with CUDA tensors (NCCL refuses two ranks on one GPU), 2 x 64 envs
     32x32, PPOConfig(): all_reduce, broadcast and all_gather on CUDA
     tensors, one fused iteration, parameters bit-identical across the
     ranks, each rank's K1/K2 (128 launches) against their plain versions
     on its last blob at max |diff| 0; (c) python -m dtown_torch.train_ppo
     --fused at the bench config in three fresh deterministic processes:
     2 iterations with --ckpt-every 1, --resume for a third, and 3
     uninterrupted; the resumed parameters equal the uninterrupted ones
     (max |diff| 0), with the checkpoint's size and the seconds to save
     and restore. The parent built the kernels (phase 2), so the ranks
     and processes load them and build nothing.
  12. the measurement tools (tools_phase), through their entry functions
     at full width, each step with kernels counting its own launches
     (every kernel it runs must launch): (a) python -m dtown_torch.bench
     at its defaults (K1 + K2), its env-steps/s within 0.5-2x of the same
     configuration's fused rate in phase 4 of this run (the "bench"
     cell); (b) bench --obs state (K1; printed only, host-bound); (c)
     bench --no-fused --renderer pallas --iters 32 (K3); (d) perf_probe
     at its defaults, full >= max(state, render); (e) bench_profile on udem1, 1024
     envs 64x64 (the step path's eight phases; no kernel); (f)
     roofline_objpass on udem1, 4096 envs (K2), its gap to the
     instruction bound >= 1.0; (g) benchmark --steps 50 (the gym env at
     640x480); (h) dtown_torch.native's compiler against map_loader on
     every shipped map, and native/libdtown_mapc.so unchanged.
Needs CUDA; imports nothing of JAX. K2's counts and the card's peaks are
dtown_torch/roofline.py's.
"""
import json
import os
import subprocess
import sys
import time

from dtown_torch.device import nvidia_smi_line
from dtown_torch.roofline import PEAK_BF16, bound, k2_ops

REPO = os.path.dirname(os.path.abspath(__file__))

# Instruction counts per unit of work, counted by hand from the kernel
# sources (arithmetic, compare and select instructions; a sqrt, divide or
# table load counts as one). Estimates: they set the operation bound.
K1_OPS_ENV = 900          # state_kernel.cu without the SAT loop
K1_OPS_OBJECT = 160       # SAT (4 axes x 8 projections) + proximity
K1_OPS_LANE = 650         # one lane query: tile, 12-curve select, bisection
K1_OPS_DUCKIE = 30        # a walking duckie's substep (sincos, walk)
K1_OPS_BOT = 2 * K1_OPS_LANE + 110  # pure pursuit + differential drive
K1_OPS_NPC_SAT = 50       # a live footprint (sincos, 4 corners)
K1_OPS_HASH = 22          # one hashed uniform
K1_OPS_RESET_DUCKIE = 4 * K1_OPS_HASH + 10   # fresh walk speed
K1_OPS_RESET_DR = 16 * K1_OPS_HASH + 60      # the DR redraw
K1_OPS_MAP_GATE = 2       # a stack's map test of one object column
K1_OPS_NAV = 10           # the goal check (two floors, compares, bonus)
K1_OPS_NAV_SHAPING = 20   # the goal-distance shaping term
K1_OPS_RESET_GOAL = K1_OPS_HASH + 8          # the goal redraw

# BASELINE config 5's maps and scripts/bench_all.sh's 6-map curriculum
STACK3 = ["zigzag_dists", "4way", "udem1"]
STACK6 = STACK3 + ["small_loop", "loop_obstacles", "s_bend"]
# npc10_state's stack: 3 + 4 + 3 = 10 moving NPCs
NPC10 = ["loop_pedestrians", "town_dyn_duckiebots", "metro"]
# row_render.cu (K3 and K4 share the pixel pass, the culls, the primitive
# tests and the shading); per pixel
K34_OPS_PIXEL = 165       # NDC table, ray normalize, ground, tile, sky, output
K34_OPS_BOUND = 12        # a kept object's bounding-sphere test (record load,
                          # b = oc . d, compares)
K34_OPS_OBJECT = 14       # an object's ray in model space where its sphere is
                          # met (2 record loads, dmx, dmz, its prim range)
K34_OPS_BOX_OBJECT = 12   # 1/dmx and 1/dmz of an object that holds a box
K34_OPS_BOX = 35          # one box: 2 record loads, slabs from the folded
                          # offsets, hit, nearest-hit update
K34_OPS_SPHERE = 26       # one sphere (K4's padded slots too): 2 loads, b,
                          # disc, root, hit, nearest-hit update
K34_OPS_SHADE = 55        # the winner's hit point, normal, Lambert term and
                          # colour, once on a pixel an object covers
# once per env (the kernels' per-block prologue; the bound counts it once
# per env, not once per block)
K34_OPS_SLOT = 4          # the keep flag of one object slot, compaction
K34_OPS_OBJECT_ENV = 40   # a kept object's eye in model space, bounding
                          # sphere, lamp colour, records
K34_OPS_RADIUS_SLOT = 12  # K4: one slot's reach in the object's radius
K34_OPS_PRIM_ENV = 20     # a kept primitive's folded record
# K2's plain version in slices of envs above this many pixels in all
PLAIN_PIXELS = 1 << 25
# the sample mesh of tests/test_objmesh.py: two wall quads and a roof
SAMPLE_OBJ = """mtllib duckhouse.mtl
v -1 0 -1
v  1 0 -1
v  1 2 -1
v -1 2 -1
v -1 0 1
v  1 0 1
v  1 2 1
v -1 2 1
usemtl walls
f 1 2 3 4
f 5 6 7 8
v -1.2 2 -1.2
v  1.2 2 -1.2
v  0 3 0
usemtl roof
f 9 10 11
"""
SAMPLE_MTL = """newmtl walls
Kd 0.7 0.5 0.3
newmtl roof
Kd 0.8 0.1 0.1
"""


def ptxas_report(log):
    """One line per compiled kernel of an nvcc -Xptxas -v log: the kernel
    with its template flags, then its registers and spill stores/loads."""
    import re

    def kernel_name(mangled):
        # walk the nested name _ZN<len><id><len><id>... to the identifier
        # that ends in _kernel, then read its bool template arguments
        pos = 3 if mangled.startswith("_ZN") else 0
        while True:
            m = re.match(r"\d+", mangled[pos:])
            if not m:
                return mangled
            pos += m.end()
            ident = mangled[pos:pos + int(m.group())]
            pos += len(ident)
            if ident.endswith("_kernel"):
                t = re.match(r"I((?:Lb[01]E)+)E", mangled[pos:])
                flags = re.findall(r"Lb([01])E", t.group(1)) if t else []
                return ident + (f"<{','.join(flags)}>" if flags else "")

    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
        elif "spill" in line and name:
            spill = line.strip()
        elif "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line)
            out.append(f"{name}: {regs.group(1) if regs else line.strip()}"
                       f" registers; {spill}")
            name, spill = None, ""
    return out


def spill_summary(lines):
    """Kernel count, register range and the specialisations that spill,
    of one source's ptxas_report lines."""
    import re

    regs = [int(m.group(1)) for m in (re.search(r": (\d+) registers", x)
                                      for x in lines) if m]
    spills = [x.split(":")[0] for x in lines
              if re.search(r"[1-9]\d* bytes spill", x)]
    return (f"{len(lines)} kernels, {min(regs, default=0)}-"
            f"{max(regs, default=0)} registers, spilling: "
            f"{', '.join(spills) if spills else 'none'}")


def cuda_ms(fn, n):
    """Mean ms per call of fn over n calls, CUDA events, after a warm-up
    call. Returns (ms, the warm-up call's result)."""
    import torch

    first = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, first


# the launch floor: a one-element op's kernel, traced after the window
FLOOR_KERNEL = "lgamma"


def profile_window(window, kernels, keys=False, floor=False, top=0):
    """torch.profiler over one call of window(). Returns (device ms per
    launch of each named kernel found, device ms of all kernels, window
    ms), and with keys the names of the trace's device events. With floor,
    32 one-element ops (FLOOR_KERNEL) follow the window in the same trace,
    outside its time and busy sum, and their device ms per launch is
    returned as the launch floor under "launch_floor". With top, the top
    device kernels by time are printed (ms in all, launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    one = torch.ones(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        window()
        end.record()
        for _ in range(32 if floor else 0):
            one.lgamma_()
        torch.cuda.synchronize()
    per, busy, names, totals = {}, 0.0, [], []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host events; kernels are the device-side entries
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
        if floor and FLOOR_KERNEL in ev.key and ev.count:
            per["launch_floor"] = t / ev.count
            continue
        busy += t
        names.append(ev.key)
        totals.append((t, ev.count, ev.key[:60]))
        for k in kernels:
            if k in ev.key and ev.count:
                per[k] = t / ev.count
    for t, n, key in sorted(totals, reverse=True)[:top]:
        print(f"    {t:10.3f} ms {n:6d}x {key}")
    if keys:
        return per, busy, start.elapsed_time(end), names
    return per, busy, start.elapsed_time(end)


def k34_ops(rows, pk, covered):
    """Operations the row-fed render needs on these rows, by the kernels'
    own culls: per pixel the ground pass and the bounding-sphere test of
    each object its env keeps (row_raster.row_kept); an object's model ray
    and primitive tests (K4's padded slots at their folded sphere cost)
    only on the pixels whose rays meet its sphere (row_raster.
    row_sphere_pass, on the card in slices of envs); the winner's shading
    once on each pixel an object covers (``covered`` [B], counted where the
    frame differs from the frame without objects, so never above the
    kernel's count); per env the prologue: each slot's keep flag, a kept
    object's model eye and sphere (K4: its radius from every slot) and a
    kept primitive's folded record."""
    import torch
    from dtown_torch.render import row_raster as rr

    P = pk["H"] * pk["W"]
    B = rows[0].shape[0]
    kept = rr.row_kept(rows, pk).double().cpu()        # [B, n]
    hits = torch.zeros_like(kept)
    n = max(1, (1 << 24) // (P * max(kept.shape[1], 1)))
    for i in range(0, B, n):
        hits[i:i + n] = rr.row_sphere_pass(
            [r[i:i + n] for r in rows], pk).sum(2).double().cpu()
    if pk["static"]:
        soi, spi = pk["soi"].cpu().tolist(), pk["spi"].cpu().tolist()
        box = [[spi[j][rr.SPI_BOX] for j in range(j0, j0 + n_p)]
               for j0, n_p in soi[:pk["n_objs"]]]
        prim_cost = torch.tensor([[sum(K34_OPS_BOX if b else K34_OPS_SPHERE
                                       for b in bs) for bs in box]],
                                 dtype=torch.float64)
        n_prims = torch.tensor([[len(bs) for bs in box]],
                               dtype=torch.float64)
        box_obj = torch.tensor([[float(any(bs)) for bs in box]],
                               dtype=torch.float64)
        radius = 0
    else:
        prim = rows[3].cpu().double().reshape(B, -1, rr.P_MAX, rr.PRIM_F)
        is_box = (prim[..., 0] > 0.5).double()
        prim_cost = (is_box * K34_OPS_BOX
                     + (1 - is_box) * K34_OPS_SPHERE).sum(-1)
        n_prims = rr.P_MAX
        box_obj = (is_box.sum(-1) > 0).double()
        radius = rr.P_MAX * K34_OPS_RADIUS_SLOT
    per_env = (P * K34_OPS_PIXEL + covered.double().cpu() * K34_OPS_SHADE
               + kept.shape[1] * K34_OPS_SLOT
               + (kept * (K34_OPS_OBJECT_ENV + radius
                          + n_prims * K34_OPS_PRIM_ENV
                          + P * K34_OPS_BOUND)).sum(1)
               + (hits * (K34_OPS_OBJECT + box_obj * K34_OPS_BOX_OBJECT
                          + prim_cost)).sum(1))
    return float(per_env.sum())


def without_objects(rows, pk):
    """The rows with every object culled: K3's cull flags, K4's active
    flags off."""
    from dtown_torch.render import row_raster as rr

    rows = [r.clone() for r in rows]
    if pk["static"]:
        rows[2][:, 0::2] = 0.0
    else:
        rows[2].view(rows[2].shape[0], -1, rr.OBJ_F)[..., 7] = 0.0
    return rows


def posed_states(states, maps, seed):
    """The states with env b at 0.3-0.8 m from live object b % n_live,
    facing it (even b) or turned away from it (odd b): the poses of
    tests/test_torch_row_render_cull.py."""
    import math
    import numpy as np
    import torch

    B, dev = states.batch_size, states.pos.device
    rng = np.random.default_rng(seed)
    live = torch.nonzero(maps.obj_mask).flatten()
    b = torch.arange(B, device=dev)
    opos = states.dyn.pos[b, live[b % len(live)]]
    a = torch.as_tensor(rng.uniform(-math.pi, math.pi, B),
                        dtype=torch.float32, device=dev)
    d = torch.as_tensor(rng.uniform(0.3, 0.8, B), dtype=torch.float32,
                        device=dev)
    pos = states.pos.clone()
    pos[:, 0] = opos[:, 0] - d * torch.cos(a)
    pos[:, 2] = opos[:, 2] + d * torch.sin(a)
    angle = torch.where(b % 2 == 0, a, a + math.pi)
    return states.replace(pos=pos, angle=angle)


def _wrappers():
    from dtown_torch import probes
    from dtown_torch.ops import state_kernel as sk
    from dtown_torch.render import blob_raster as br
    from dtown_torch.render import row_raster as rr

    return {"state_step": sk.state_step,
            "blob_render": br.render_frames_from_blob,
            "row_render_static": rr.row_render_static,
            "row_render": rr.row_render, "fma_chain": probes.fma_chain}


def reset_counts():
    """Set every kernel wrapper's launch count to 0."""
    for fn in _wrappers().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in _wrappers().items()}


def card_and_cpu(cfg, map_name, B, n_steps, dev):
    """The step path (make_vec_env) on the card and on the CPU from the
    same CPU-built states of B envs, n_steps seeded actions (auto-reset
    off in cfg). Returns ((states, outputs) on the card, the same on the
    CPU), all on the CPU."""
    import torch
    import dtown_torch
    from dtown_torch import env as tenv

    maps = dtown_torch.load_map(map_name)
    start = tenv.reset(cfg, maps.to("cpu"),
                       torch.Generator().manual_seed(3), B)
    gen = torch.Generator().manual_seed(4)
    acts = [torch.rand((B, 2), generator=gen) * torch.tensor([1.0, 2.0])
            - torch.tensor([0.0, 1.0]) for _ in range(n_steps)]
    res = {}
    for d in ("cpu", dev):
        _, v_step = tenv.make_vec_env(cfg, maps, B, device=d)
        s = start.to(d)
        for a in acts:
            s, out = v_step(s, a.to(d))
        res[str(d)] = (s.to("cpu"), {k: v.cpu() for k, v in
                                     vars(out).items()})
    return res[str(dev)], res["cpu"]


def vec_card_vs_cpu(map_name, dev, **kw):
    """The vector env on the card vs on the CPU, 64 envs 32x32, from the
    same CPU-built states, 5 steps without auto-reset; kw are further
    EnvConfig fields."""
    import torch
    import dtown_torch

    cfg = dtown_torch.EnvConfig(camera_width=32, camera_height=32,
                                renderer="pallas", auto_reset=False, **kw)
    (sg, og), (sc, oc) = card_and_cpu(cfg, map_name, 64, 5, dev)
    pose = max(float((sg.pos - sc.pos).abs().max()),
               float((sg.angle - sc.angle).abs().max()),
               float((sg.dyn.pos - sc.dyn.pos).abs().max()))
    rew = float((og["reward"] - oc["reward"]).abs().max())
    same = all(torch.equal(og[k], oc[k])
               for k in ("done", "collision", "in_lane")) and torch.equal(
        sg.step_count, sc.step_count)
    obs = float((og["obs"].int() - oc["obs"].int()).abs().float().mean())
    print(f"vec env card vs cpu, {map_name} {kw} (64 envs 32x32, 5 steps): "
          f"pose max |diff| {pose:.3g}, reward {rew:.3g}, discrete equal "
          f"{same}, "
          f"obs mean |diff| {obs:.3g}")
    if not (pose <= 1e-5 and rew <= 1e-4 and same and obs <= 0.01):
        raise AssertionError(f"card vector env disagrees with the CPU on "
                             f"{map_name}")


def vec_main_path(map_name, dev, smi, n_steps=256, **kw):
    """The step path at full width on one map: timed run, output checks,
    physics/render split and a profiler trace; kw are further EnvConfig
    fields. Returns a dict with the launches of the timed run, the final
    states and the trace times."""
    import torch
    import dtown_torch
    from dtown_torch import env as tenv

    B = 4096
    cfg, maps, v_reset, v_step = dtown_torch.make_vec(
        map_name, B, renderer="pallas", **kw)
    pk, facts = v_step.pack, tenv.host_facts(cfg, maps)
    states = v_reset(torch.Generator(device=dev).manual_seed(0))
    actions = torch.rand((B, 2), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    actions[:, 1] = actions[:, 1] * 2.0 - 1.0
    for _ in range(8):                                   # warm-up
        states, out = v_step(states, actions)
    torch.cuda.synchronize()
    reset_counts()  # counts of this path's run only
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    n_done = torch.zeros((), dtype=torch.int64, device=dev)
    start.record()
    for _ in range(n_steps):
        states, out = v_step(states, actions)
        n_done += out.done.sum()
    end.record()
    torch.cuda.synchronize()
    launches = read_counts()
    ms = start.elapsed_time(end)
    rate = B * n_steps / (ms / 1e3)
    print(f"vec step path, {map_name} {kw} {B} envs 64x64: {n_steps} steps in "
          f"{ms:.2f} ms = {rate:.6g} env-steps/s ({ms / n_steps:.4f} "
          f"ms/step) on {smi}; auto-resets {int(n_done)}")
    print(f"launches in the timed run: {launches}")
    obs = out.obs
    if not (obs.shape == (B, 64, 64, 3) and obs.dtype == torch.uint8
            and bool(torch.isfinite(out.reward).all())
            and float(obs.float().std()) > 5.0):
        raise AssertionError(f"vec step output malformed on {map_name}")

    # physics alone, then render alone (host clock, synchronized)
    gen = torch.Generator(device=dev).manual_seed(2)
    split = {}
    for name, fn in (
            ("physics", lambda s: tenv.step_physics(
                cfg, maps, s, actions, generator=gen, facts=facts)[0]),
            ("render", lambda s: (tenv.render_obs_batch(
                cfg, maps, s, pack=pk), s)[1])):
        s = states
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(32):
            s = fn(s)
        torch.cuda.synchronize()
        split[name] = (time.perf_counter() - t0) / 32 * 1e3
    print(f"split, host clock per step: physics {split['physics']:.4f} ms, "
          f"render {split['render']:.4f} ms")

    kname = "row_render_static_kernel" if pk["static"] else \
        "row_render_kernel"

    def window():
        s = states
        for _ in range(32):
            s, _ = v_step(s, actions)

    dev_ms, busy, win = profile_window(window, [kname])
    print(f"profiler, 32 steps: window {win:.3f} ms, kernels busy "
          f"{busy:.3f} ms, device idle share {1.0 - busy / win:.4f}; "
          f"device ms/launch {dev_ms}")
    if kname not in dev_ms:
        raise AssertionError(f"no device time in the trace for {kname}")
    return dict(cfg=cfg, maps=maps, pk=pk, states=states, launches=launches,
                ms=dev_ms[kname], rate=rate)


def row_kernel_check(run, dev):
    """K3 or K4 vs its plain version on the main path's 4096-env states
    (max |diff| 0, the bars below as a floor) and on those states posed
    near the map's objects (posed_states); returns (max |diff|, plain ms,
    bound ms, bound_by)."""
    import torch
    from dtown_torch.render import row_raster as rr

    cfg, maps, pk, states = run["cfg"], run["maps"], run["pk"], run["states"]
    rows = rr.prepare_rows(cfg, maps, states, pk)
    if pk["static"]:
        name, kern, plain = ("row_render_static", rr.row_render_static,
                             rr.render_frames_static_reference)
    else:
        name, kern, plain = ("row_render", rr.row_render,
                             rr.render_frames_rows_reference)
    img_k = kern(*rows, pk)
    plain_ms, img_r = cuda_ms(lambda: plain(*rows, pk), 3)
    diff = (img_k.int() - img_r.int()).abs()
    mean = float(diff.float().mean())
    frac = float((diff > 2).float().mean())
    err = float(diff.max())
    del img_k, diff
    print(f"{name} vs plain: {states.batch_size} envs 64x64, mean |diff| "
          f"{mean:.3g}, share |diff|>2 {frac:.3g}, max {err:.0f}")
    if not (mean <= 0.01 and frac <= 1e-4) or err > 0:
        raise AssertionError(f"{name} kernel differs from its plain version")
    # the pixels an object covers: where the frame differs from the frame
    # without objects
    img_g = plain(*without_objects(rows, pk), pk)
    covered = (img_r != img_g).any(1).reshape(img_r.shape[0], -1).sum(1)
    del img_r, img_g
    # the same envs posed near objects, half of them facing one
    posed = rr.prepare_rows(cfg, maps, posed_states(states, maps, 4), pk)
    err_p = float((kern(*posed, pk).int() - plain(*posed, pk).int())
                  .abs().max())
    kept = rr.row_kept(posed, pk).sum(1).float()
    print(f"{name} vs plain on posed states: max |diff| {err_p:.0f} "
          f"(objects kept per env {float(kept.mean()):.3g}, the unposed "
          f"states {float(rr.row_kept(rows, pk).sum(1).float().mean()):.3g})")
    if err_p > 0:
        raise AssertionError(f"{name} kernel differs from its plain version "
                             f"on the posed states")
    P = pk["H"] * pk["W"]
    tabs = ("ndc",) + (("sof", "soi", "spf", "spi") if pk["static"]
                       else ())
    nbytes = (states.batch_size * 3 * P
              + sum(r.numel() * r.element_size() for r in rows)
              + sum(pk[k].numel() * pk[k].element_size() for k in tabs))
    nops = k34_ops(rows, pk, covered)
    b_ms, b_by = bound(nbytes, nops)
    print(f"{name}: {run['ms']:.5f} ms/launch (plain {plain_ms:.4f} ms), "
          f"bound {b_ms:.6f} ms by {b_by} ({nbytes} B, {nops:.4g} ops; "
          f"pixels covered by an object {float(covered.sum()):.6g})")
    return max(err, err_p), plain_ms, b_ms, b_by


def k1_ops(blob_out, st):
    """Operations the state step did for this output blob: per env the
    agent and one SAT test per object column (on a stack: a map test per
    column, and the SAT only for the env's own map's columns); per NPC and
    substep its state machine (two lane queries for a duckiebot; the
    kernel steps every NPC in every env); the Nav goal check; per reset
    env the NPCs' re-placement, the DR redraw and the goal redraw."""
    import torch
    from dtown_torch.ops import state_kernel as sk

    B = blob_out.shape[1]
    n_done = int(blob_out[sk.F_DONE].sum())
    kinds = st["npc"][sk.NPC_KIND].tolist()[:st["n_npc"]]
    n_duckie = sum(1 for k in kinds if int(k) == sk.NPC_DUCKIE)
    n_bot = len(kinds) - n_duckie
    if st["n_maps"] > 1:
        cmap = st["colmap"][2, :st["M"]].cpu()
        mid = blob_out[sk.F_MAPID].cpu().to(torch.int64)
        own = int((mid[:, None] == cmap[None, :]).sum())
        sat = K1_OPS_OBJECT * own + K1_OPS_MAP_GATE * st["M"] * B
    else:
        sat = K1_OPS_OBJECT * st["M"] * B
    per_env = (K1_OPS_ENV
               + st["frame_skip"] * (n_duckie * K1_OPS_DUCKIE
                                     + n_bot * K1_OPS_BOT)
               + K1_OPS_NPC_SAT * len(kinds))
    if st["nav"]:
        coef = float(st["prm"][sk._PARAM_NAMES.index("nav_coef")])
        per_env += K1_OPS_NAV + (K1_OPS_NAV_SHAPING if coef else 0)
    per_reset = n_duckie * K1_OPS_RESET_DUCKIE + (
        K1_OPS_RESET_DR + K1_OPS_HASH * st["n_opt"]
        if st["domain_rand"] else 0) + (
        K1_OPS_RESET_GOAL if st["nav"] else 0)
    return float(B * per_env + sat + n_done * per_reset)


def k1_bytes(st, nf, B):
    tab = sum(st[k].numel() * st[k].element_size()
              for k in ("words", "ct_t", "ot", "bank", "prm", "npc", "colmap",
                        "drp", "n_ok_v", "n_driv")
              ) + (st["goal"].numel() * 4 if st["nav"] else 0)
    return 2 * nf * B * 4 + 2 * B * 4 + tab


def k2_bytes(pk, B, P):
    """Frames written, blob rows and tables read once; the ray input is
    the static planes or, under DR, the NDC table."""
    tab = sum(pk[k].numel() * pk[k].element_size()
              for k in ("words", "scene", "of", "oi", "pf", "pi"))
    rays = pk["rays"].numel() * 4
    rows = (5 + pk["n_npc"] * 3 + (16 if pk["dr"] else 0)
            + (1 if pk["n_maps"] > 1 else 0))
    return B * pk["C"] * P + rows * B * 4 + tab + rays


def k1_edge_blob(blob, st, maps, max_steps):
    """The state step's edge states on a fused rollout's blob (any device;
    st = its device tables, maps the compiled map or stack). Env b on
    member m (its F_MAPID row) takes the next pose of m's list, which
    interleaves five kinds: a straight tile's centre with a heading
    perpendicular to its lanes (heading 0 across lanes along z first: both
    chords dot to ±0, a curve-select tie); a 3-way or 4-way tile's centre at
    k·π/4; the agent's box centred on a static object (the always-present
    ones first) or on an NPC's start pose of m; the agent off the grid (a
    clipped tile id). F_STEP is max_steps - frame_skip everywhere, so every
    env resets in one step (the DR redraw and the NPC re-placement in every
    env). Zero actions keep the poses through the step's drive. Returns a
    new blob."""
    import math
    import numpy as np
    import torch
    from dtown_torch import types as T
    from dtown_torch.ops import state_kernel as sk

    host = maps.numpy()
    members = ([host.map_at(m) for m in range(host.n_maps)] if host.is_stack
               else [host])
    ts = float(np.asarray(host.tile_size).reshape(-1)[0])
    Hg, Wg = st["Hg"], st["Wg"]
    cam_back = float(st["prm"][sk._PARAM_NAMES.index("cam_back")])
    ct, ot = st["ct"].cpu().numpy(), st["ot"].cpu().numpy()
    colmap = st["colmap"].cpu().numpy()

    def centred(x, z, a):
        # the pose whose box centre (pos + cam_back * dir) is (x, z)
        return (x - cam_back * math.cos(a), z + cam_back * math.sin(a), a)

    poses = []
    for m, h in enumerate(members):
        kind = np.asarray(h.tile_kind)
        t_off = m * st["t_pad"] if st["n_maps"] > 1 else 0
        across, along, junction = [], [], []
        for j, i in zip(*np.nonzero(kind == T.TILE_STRAIGHT)):
            x, z = (i + 0.5) * ts, (j + 0.5) * ts
            chx = ct[sk.CT_CHX, t_off + j * Wg + i]
            if chx == 0.0:      # lanes along z: heading 0 dots both to ±0
                across.append((x, z, 0.0))
                along.append((x, z, math.pi))
            else:
                along += [(x, z, 0.5 * math.pi), (x, z, 1.5 * math.pi)]
        for j, i in zip(*np.nonzero(np.isin(kind, (
                T.TILE_3WAY_LEFT, T.TILE_3WAY_RIGHT, T.TILE_4WAY)))):
            junction += [((i + 0.5) * ts, (j + 0.5) * ts, k * math.pi / 4)
                         for k in range(8)]
        cols = [c for c in range(st["M"]) if colmap[0, c] < 0
                and (st["n_maps"] == 1 or colmap[2, c] == m)]
        cols.sort(key=lambda c: colmap[1, c] >= 0)
        objects = [centred(float(ot[sk.OT_PX, c]), float(ot[sk.OT_PZ, c]),
                           0.25 * math.pi * (c % 2)) for c in cols]
        npcs = [centred(d["x0"], d["z0"], d["a0"] + 0.5 * math.pi)
                for d in st["npcs"] if d["map"] in (None, m)]
        off = [(-0.5 * ts, 0.5 * Hg * ts, 0.0),
               ((Wg + 0.5) * ts, 0.5 * Hg * ts, 0.0),
               (0.5 * Wg * ts, -0.5 * ts, 0.0),
               (0.5 * Wg * ts, (Hg + 0.5) * ts, 0.0)]
        kinds = [across + along, junction, objects, npcs, off]
        poses.append([k[n] for n in range(max(map(len, kinds)))
                      for k in kinds if n < len(k)])
    mid = blob[sk.F_MAPID].long().cpu().numpy()
    seen = [0] * len(members)
    xza = np.zeros((3, blob.shape[1]))
    for b, m in enumerate(mid):
        xza[:, b] = poses[m][seen[m] % len(poses[m])]
        seen[m] += 1
    out = blob.clone()
    for f, v in zip((sk.F_POS_X, sk.F_POS_Z, sk.F_ANGLE), xza):
        out[f] = torch.as_tensor(v, dtype=torch.float32, device=blob.device)
    out[sk.F_STEP] = float(max_steps - st["frame_skip"])
    return out


def curve_ties(blob, st):
    """Envs whose lane query on this blob's poses (as the step's drive
    leaves them under zero actions) meets a tie: two valid curves of the
    tile share the best chord dot."""
    import torch
    from dtown_torch.geometry import sincos
    from dtown_torch.ops import state_kernel as sk

    ts_inv = float(st["prm"][sk._PARAM_NAMES.index("ts_inv")])
    ii = torch.clamp(torch.floor(blob[sk.F_POS_X] * ts_inv).long(), 0,
                     st["Wg"] - 1)
    jj = torch.clamp(torch.floor(blob[sk.F_POS_Z] * ts_inv).long(), 0,
                     st["Hg"] - 1)
    tid = blob[sk.F_MAPID].long() * st["t_pad"] + jj * st["Wg"] + ii
    pkg = st["ct"][:, tid]
    s_a, c_a = sincos(blob[sk.F_ANGLE])
    c = slice(sk.CT_CHX, sk.CT_CHX + sk.N_CURVES)
    dots = pkg[c] * c_a + pkg[sk.CT_CHZ:sk.CT_CHZ + sk.N_CURVES] * -s_a
    valid = pkg[sk.CT_VALID:sk.CT_VALID + sk.N_CURVES] > 0.5
    dots = torch.where(valid, dots, torch.full_like(dots, -1e30))
    best = dots.max(0).values
    return int(((dots == best) & valid).sum(0).ge(2).sum())


def k1_collisions(blob, act, st):
    """(envs colliding with a static object, envs colliding with an NPC
    footprint alone) in one plain state step: a collision that stays when
    every NPC is moved far off the map is a static one."""
    from dtown_torch.ops import state_kernel as sk

    a0, a1 = act[:, 0].contiguous(), act[:, 1].contiguous()
    hit = sk.state_step_reference(blob, a0, a1, st)[sk.F_COLL] > 0.5
    away = blob.clone()
    for i in range(st["n_npc"]):
        away[sk.F_NPC_BASE + sk.NPC_ROWS * i:
             sk.F_NPC_BASE + sk.NPC_ROWS * i + 2] = 1e4
    static = sk.state_step_reference(away, a0, a1, st)[sk.F_COLL] > 0.5
    return int(static.sum()), int((hit & ~static).sum())


def k1_edge_phase(dev):
    """K1 against its plain version on the edge states (k1_edge_blob) at
    4096 envs, on udem1 with domain randomization and on npc10_state's
    10-NPC stack: the storm step (every env resets) from zero actions, then
    a step of random actions, then the storm step again at the launch
    shape of a huge NPC count (fewer envs a block, the object and NPC
    tables read from global memory); max |diff| 0 on every row of each.
    Returns the largest difference."""
    import torch
    import dtown_torch
    from dtown_torch.ops import state_kernel as sk

    B, worst = 4096, 0.0
    for tag, spec, kw in (("udem1_dr", "udem1", dict(domain_rand=True)),
                          ("npc10", NPC10, {})):
        cfg = dtown_torch.EnvConfig(obs_type="state", **kw)
        maps = (dtown_torch.stack_maps(spec) if isinstance(spec, list)
                else dtown_torch.load_map(spec))
        ib, fs, _ = dtown_torch.make_fused_rollout(cfg, maps, B, device=dev)
        st = fs.tables
        blob = k1_edge_blob(ib(torch.Generator(device=dev).manual_seed(21)),
                            st, maps, cfg.max_steps)
        act = torch.zeros((B, 2), device=dev)
        ties = curve_ties(blob, st)
        n_static, n_npc = k1_collisions(blob, act, st)
        gen = torch.Generator(device=dev).manual_seed(22)
        errs, resets, storm = [], [], None
        for _ in range(2):
            ref = sk.state_step_reference(blob, act[:, 0].contiguous(),
                                          act[:, 1].contiguous(), st)
            out = sk.state_step(blob, act, st)
            torch.cuda.synchronize()
            errs.append(k1_diff(out, ref, f"edge states {tag}"))
            resets.append(int(out[sk.F_DONE].sum()))
            if storm is None:
                storm = (blob, act, ref)
            blob = out
            act = torch.rand((B, 2), generator=gen, device=dev) * 2.0 - 1.0
        # the storm step again at the launch shape that only huge NPC counts
        # reach: 2 envs a block, the tables left in global memory
        per_env = st["nf"] + sk.K1_ENV_WORDS + 2 * st["M"]
        saved, sk.K1_SMEM_MAX = sk.K1_SMEM_MAX, 4 * (sk.K1_TABLE_WORDS
                                                     + 2 * per_env)
        try:
            shape = sk.launch_shape(st["nf"], st["M"], st["n_npc"],
                                    st["n_words"])
            out = sk.state_step(storm[0], storm[1], st)
        finally:
            sk.K1_SMEM_MAX = saved
        torch.cuda.synchronize()
        errs.append(k1_diff(out, storm[2], f"edge states {tag} {shape}"))
        print(f"edge states {tag}, {B} envs: curve-select ties {ties}, "
              f"static collisions {n_static}, NPC collisions {n_npc}, resets "
              f"{resets}; state kernel vs plain max |diff| {errs} (the last "
              f"at the launch shape {shape}: unstaged tables)")
        if resets[0] != B or ties <= 0 or n_static <= 0 or shape[1] != 2:
            raise AssertionError(f"edge states {tag}: a branch or the "
                                 f"unstaged launch shape was not reached")
        if st["n_npc"] and n_npc <= 0:
            raise AssertionError(f"edge states {tag}: no NPC collision")
        worst = max(worst, *errs)
    return worst


def k1_diff(out, ref, tag):
    """max |out - ref| of the state kernel's blob against the plain
    version's; raises unless it is 0 on every row (a NaN included)."""
    import torch

    d = (out - ref).abs().amax(1)
    rows = torch.nonzero(~(d == 0)).flatten().tolist()
    if rows:
        raise AssertionError(f"{tag}: state kernel rows {rows} differ from "
                             f"the plain version (max |diff| "
                             f"{float(d.max()):.3g})")
    return float(d.max())


def make_rollout(cfg, maps, B, dev, nav):
    """(init_blob, fused_step, rollout) of the fused rollout, or of the
    fused Nav rollout with the goal in the observation."""
    import dtown_torch

    if nav:
        return dtown_torch.make_fused_nav_rollout(cfg, maps, B,
                                                  goal_in_obs=True, device=dev)
    return dtown_torch.make_fused_rollout(cfg, maps, B, device=dev)


def on_own_map(blob, envs, drivable, ts, rows):
    """Whether the tiles (rows = (x, z) world rows, or (i, j) tile rows
    when ts is None) of the given envs are drivable tiles of each env's own
    map; drivable is bool [n_maps, H, W] on the blob's device."""
    import torch
    from dtown_torch.ops import state_kernel as sk

    x, z = blob[rows[0]][envs], blob[rows[1]][envs]
    i = torch.floor(x / ts) if ts else x
    j = torch.floor(z / ts) if ts else z
    i, j = i.long(), j.long()
    mi = blob[sk.F_MAPID][envs].long()
    H, W = drivable.shape[1:]
    ok = (i >= 0) & (i < W) & (j >= 0) & (j < H)
    return bool((ok & drivable[mi, j.clamp(0, H - 1),
                               i.clamp(0, W - 1)]).all())


def render_plain(blob, pk):
    """K2's plain version on the blob, in slices of envs when the frames
    hold more than PLAIN_PIXELS pixels in all (its float32 temporaries at
    512 envs of 640x480 would not fit the card)."""
    import torch
    from dtown_torch.render import blob_raster as br

    B, P = blob.shape[1], pk["H"] * pk["W"]
    n = max(8, PLAIN_PIXELS // P // 8 * 8)
    if n >= B:
        return br.render_frames_reference(blob, pk)
    return torch.cat([br.render_frames_reference(
        blob[:, i:i + n].contiguous(), pk) for i in range(0, B, n)])


def held_rows(tag, blob, actions, st, pk, launches, dev_ms, k1_err=0.0,
              k2_err=0.0):
    """The state kernel (and, with a render plan ``pk``, the blob render)
    against its plain version on ``blob`` stepped by ``actions`` (max
    |diff| 0), the plain versions' times and the bounds from these inputs:
    the kernels' rows of the JSON line, with the launches and device ms of
    the caller's run; k1_err / k2_err are the caller's earlier checks.
    "bench" keeps the bare kernel names."""
    import torch
    from dtown_torch.ops import state_kernel as sk
    from dtown_torch.render import blob_raster as br

    B = blob.shape[1]
    act0, act1 = actions[:, 0].contiguous(), actions[:, 1].contiguous()
    k1_plain, blob2 = cuda_ms(
        lambda: sk.state_step_reference(blob, act0, act1, st), 3)
    out = sk.state_step(blob, actions, st)
    torch.cuda.synchronize()
    k1_last = k1_diff(out, blob2, f"{tag} (last blob)")
    print(f"{tag}: state kernel vs plain on the run's last blob: max "
          f"|diff| {k1_last:.3g}")
    k1_err = max(k1_err, k1_last)
    del out
    k1_b = bound(k1_bytes(st, blob.shape[0], B), k1_ops(blob2, st))
    sfx = "" if tag == "bench" else f"[{tag}]"
    rows = [dict(name="state_step" + sfx, route="cuda",
                 source="dtown_torch/csrc/state_kernel.cu",
                 replaces="dtown/ops/state_kernel.py:203",
                 launches=launches["state_step"], max_abs_err=k1_err,
                 ms=dev_ms["state_step_kernel"], plain_ms=k1_plain,
                 bound_ms=k1_b[0], bound_by=k1_b[1], library_ms=None)]
    print(f"{tag}: state kernel {dev_ms['state_step_kernel']:.5f} ms/launch"
          f" (plain {k1_plain:.4f} ms), bound {k1_b[0]:.6f} ms by "
          f"{k1_b[1]}")
    if pk is not None:
        P = pk["H"] * pk["W"]
        k2_plain, img_r = cuda_ms(lambda: render_plain(blob, pk), 2)
        img_k = br.render_frames_from_blob(blob, pk)
        k2_last = float((img_k.int() - img_r.int()).abs().max())
        del img_k, img_r
        print(f"{tag}: blob render vs plain on the run's last blob: "
              f"max |diff| {k2_last:.0f}")
        if k2_last > 0:
            raise AssertionError(f"{tag}: blob render kernel differs from "
                                 f"its plain version on the last blob")
        k2_err = max(k2_err, k2_last)
        k2_b = bound(k2_bytes(pk, B, P), k2_ops(blob, pk, P))
        # the same bound without the view cull (what the pixels need when
        # no object behind the camera is skipped)
        k2_nv = bound(k2_bytes(pk, B, P), k2_ops(blob, dict(pk, view=False),
                                                 P))
        rows.append(dict(name="blob_render" + sfx, route="cuda",
                         source="dtown_torch/csrc/blob_render.cu",
                         replaces="dtown/render/blob_raster.py:574",
                         launches=launches["blob_render"],
                         max_abs_err=k2_err, ms=dev_ms["blob_render_kernel"],
                         plain_ms=k2_plain, bound_ms=k2_b[0],
                         bound_by=k2_b[1], library_ms=None))
        print(f"{tag}: blob render {dev_ms['blob_render_kernel']:.5f} "
              f"ms/launch (plain {k2_plain:.4f} ms), bound {k2_b[0]:.6f} "
              f"ms by {k2_b[1]} (view cull {'on' if pk['view'] else 'off'}"
              f"; without it {k2_nv[0]:.6f} ms)")
    return rows


# each fused cell's env-steps/s in this run, beside which the tools phase
# prints the bench's
FUSED_RATE = {}


def fused_phase(tag, map_spec, dev, smi, B, size, n_timed, nav=False,
                check=None, **kw):
    """One configuration of the fused rollout on the card: the state
    kernel and the blob render against their plain versions through
    auto-resets (max_steps=5), then a timed run of the configuration as
    given, a profiler window, the plain versions' times and the bounds.
    map_spec is a map name, a list of names (a stack) or a compiled map;
    size is S (S x S frames) or (W, H); nav runs the Nav task with the
    goal in the observation; ``check`` holds EnvConfig options that only
    the kernel-vs-plain check takes (a branch that the timed traffic
    leaves off). Returns the kernels' rows of the JSON line ("bench" keeps
    the bare kernel names)."""
    import torch
    import dtown_torch
    from dtown_torch.ops import state_kernel as sk
    from dtown_torch.render import blob_raster as br

    state_only = kw.get("obs_type") == "state"
    W, H = (size, size) if isinstance(size, int) else size
    if isinstance(map_spec, str):
        maps = dtown_torch.load_map(map_spec)
        name = map_spec
    elif isinstance(map_spec, list):
        maps = dtown_torch.stack_maps(map_spec)
        name = map_spec
    else:
        maps, name = map_spec, tag
    drivable = torch.as_tensor(maps.drivable, device=dev)
    if not maps.is_stack:
        drivable = drivable[None]
    ts = float(maps.tile_size.reshape(-1)[0])
    # -- kernels vs plain versions through auto-resets
    cfg_c = dtown_torch.EnvConfig(camera_width=W, camera_height=H,
                                  **dict(kw, max_steps=5, **(check or {})))
    ib, fs, _ = make_rollout(cfg_c, maps, B, dev, nav)
    st, pk = fs.tables, fs.pack
    navb = sk.nav_base(st["n_npc"], st["domain_rand"])
    blob = ib(torch.Generator(device=dev).manual_seed(11))
    gen = torch.Generator(device=dev).manual_seed(12)
    drb = sk.dr_base(st["n_npc"])
    k1_err = 0.0
    n_done = redrawn = replaced = goals = 0
    own_map = True
    for _ in range(12):
        act = torch.rand((B, 2), generator=gen, device=dev) * 2.0 - 1.0
        ref = sk.state_step_reference(blob, act[:, 0], act[:, 1], st)
        out = sk.state_step(blob, act, st)
        torch.cuda.synchronize()
        k1_err = max(k1_err, k1_diff(out, ref, tag))
        done = out[sk.F_DONE] > 0.5
        n_done += int(done.sum())
        if st["domain_rand"]:
            redrawn += int((out[drb + sk.DR_FOV][done]
                            != blob[drb + sk.DR_FOV][done]).sum())
        for i, npc in enumerate(st["npcs"]):
            row = out[sk.F_NPC_BASE + sk.NPC_ROWS * i][done]
            replaced += int((row == float(npc["x0"])).sum())
        # respawns (and fresh goals) on drivable tiles of the env's map
        own_map &= on_own_map(out, done, drivable, ts,
                              (sk.F_POS_X, sk.F_POS_Z))
        if st["nav"]:
            goals += int((out[navb:navb + 2][:, done]
                          != blob[navb:navb + 2][:, done]).any(0).sum())
            own_map &= on_own_map(out, done, drivable, None,
                                  (navb, navb + 1))
        if st["n_maps"] > 1 and not torch.equal(
                out[sk.F_MAPID], blob[sk.F_MAPID]):
            raise AssertionError(f"{tag}: an env changed maps")
        blob = out
    print(f"{tag}: state kernel vs plain, 12 steps x {B} envs: {n_done} "
          f"auto-resets, DR rows redrawn in {redrawn} envs, NPCs "
          f"re-placed {replaced} times, goals redrawn {goals}; respawns "
          f"and goals on the env's own map {own_map}; max |diff| "
          f"{k1_err:.3g}")
    if n_done <= 0 or (st["domain_rand"] and redrawn <= 0) or (
            st["n_npc"] and replaced <= 0) or (st["nav"] and goals <= 0):
        raise AssertionError(f"{tag}: no auto-reset, redraw or re-placement")
    if not own_map:
        raise AssertionError(f"{tag}: a respawn or goal left its env's map")
    k2_err = None
    if not state_only:
        img_k = br.render_frames_from_blob(blob, pk)
        img_r = render_plain(blob, pk)
        diff = (img_k.int() - img_r.int()).abs()
        k2_err = float(diff.max())
        mean = float(diff.float().mean())
        del img_k, img_r, diff
        print(f"{tag}: blob render vs plain on that blob, {B} envs {W}x{H}"
              f" C={pk['C']}: max |diff| {k2_err:.0f}, mean {mean:.3g}")
        if k2_err > 0:
            raise AssertionError(f"{tag}: blob render kernel differs from "
                                 f"its plain version")
    del fs, ib
    # -- the configuration as given, timed
    cfg = dtown_torch.EnvConfig(camera_width=W, camera_height=H, **kw)
    init_blob, fused_step, rollout = make_rollout(cfg, maps, B, dev, nav)
    st, pk = fused_step.tables, fused_step.pack
    blob = init_blob(torch.Generator(device=dev).manual_seed(1))
    actions = torch.rand((B, 2), generator=torch.Generator(
        device=dev).manual_seed(2), device=dev)
    blob, _, _ = rollout(blob, actions, 8)               # warm-up
    torch.cuda.synchronize()
    reset_counts()  # counts of this path's run only
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    blob, _, _ = rollout(blob, actions, n_timed)
    end.record()
    torch.cuda.synchronize()
    launches = read_counts()
    ms = start.elapsed_time(end)
    rate = B * n_timed / (ms / 1e3)
    FUSED_RATE[tag] = rate
    _, out, obs = fused_step(blob, actions)
    torch.cuda.synchronize()
    print(f"{tag}: fused {'Nav ' if nav else ''}rollout {name} {kw} "
          f"{B} envs {W}x{H}: {n_timed} steps in {ms:.2f} ms = {rate:.6g} "
          f"env-steps/s ({ms / n_timed:.4f} ms/step) on {smi}; launches "
          f"{launches}")
    want = (B, 11) if state_only else (B, pk["C"], W * H // 128, 128)
    if nav:
        goal = obs[1]
        obs = obs[0]
        if not (tuple(goal.shape) == (B, 3)
                and bool(torch.isfinite(goal).all())):
            raise AssertionError(f"{tag}: Nav goal features malformed")
    if not (tuple(obs.shape) == want and bool(torch.isfinite(blob).all())
            and bool(torch.isfinite(out.reward).all())
            and float(obs.float().std()) > (0.1 if state_only else 5.0)):
        raise AssertionError(f"{tag}: rollout output malformed")
    if launches["state_step"] <= 0 or (
            not state_only and launches["blob_render"] <= 0):
        raise AssertionError(f"{tag}: a kernel of the path never launched")
    names = ["state_step_kernel"] + ([] if state_only
                                     else ["blob_render_kernel"])
    dev_ms, busy, win = profile_window(lambda: rollout(blob, actions, 32),
                                       names, floor=True)
    print(f"{tag}: profiler, 32 steps: window {win:.3f} ms, kernels busy "
          f"{busy:.3f} ms, device idle share {1.0 - busy / win:.4f}; "
          f"device ms/launch {dev_ms} (state kernel "
          f"{dev_ms.get('state_step_kernel', float('nan')):.5f} ms beside a "
          f"launch floor of {dev_ms.get('launch_floor', float('nan')):.5f} "
          f"ms)")
    if set(names + ["launch_floor"]) - dev_ms.keys():
        raise AssertionError(f"{tag}: no device time for "
                             f"{set(names) - dev_ms.keys()}")
    # -- the kernels against the plain versions it times, on the timed
    # run's last blob; then the bounds
    rows = held_rows(tag, blob, actions, st, pk, launches, dev_ms, k1_err,
                     k2_err)
    torch.cuda.empty_cache()
    return rows


def tri_mesh_map():
    """loop_obstacles' map with one more object: the sample mesh, written
    under build/chip_smoke/ and registered as kind "duckhouse", on the
    asphalt inside the loop beside the top straight (20 cm tall)."""
    import os
    import yaml
    import dtown_torch
    from dtown_torch import map_loader

    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "chip_smoke")
    os.makedirs(d, exist_ok=True)
    for fn, text in (("duckhouse.obj", SAMPLE_OBJ),
                     ("duckhouse.mtl", SAMPLE_MTL)):
        with open(os.path.join(d, fn), "w") as f:
            f.write(text)
    dtown_torch.register_custom_object("duckhouse",
                                       os.path.join(d, "duckhouse.obj"))
    with open(os.path.join(map_loader.MAPS_DIR, "loop_obstacles.yaml")) as f:
        data = yaml.safe_load(f)
    data["objects"].append({"kind": "duckhouse", "pos": [1.5, 1.5],
                            "rotate": 90, "height": 0.2, "static": True})
    return map_loader.compile_map(data)


DENSE_OBJECTS = 56


def dense_map_data():
    """Cell (j)'s map: loop_obstacles' tiles and objects plus static cones
    and duckies on a 7x7 grid over the tiles inside the loop, 56 objects
    in all, past the blob render's 48 (a YAML dict for
    map_loader.compile_map)."""
    import os
    import yaml
    from dtown_torch import map_loader

    with open(os.path.join(map_loader.MAPS_DIR, "loop_obstacles.yaml")) as f:
        data = yaml.safe_load(f)
    objs = data["objects"]
    k = 0
    while len(objs) < DENSE_OBJECTS:
        i, j = divmod(k, 7)
        objs.append({"kind": "cone" if k % 2 else "duckie",
                     "pos": [1.2 + 0.43 * i, 1.2 + 0.43 * j],
                     "rotate": (37 * k) % 360, "height": 0.08,
                     "static": True})
        k += 1
    return data


def write_dense_map():
    """dense_map_data() written as build/chip_smoke/dense_obstacles.yaml
    and compiled from that file."""
    import os
    import yaml
    from dtown_torch import map_loader

    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "chip_smoke")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "dense_obstacles.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(dense_map_data(), f)
    with open(path) as f:
        return map_loader.compile_map(yaml.safe_load(f))


def tri_pixels_won(maps, dev):
    """Eight envs posed 0.5 m from the mesh object, facing it from eight
    directions, 64x64 RGB at triangle fidelity: the blob render kernel vs
    its plain version (max |diff| 0), and the pixels a triangle won, those
    that change when the mesh object is culled. Returns that count."""
    import math
    import torch
    import dtown_torch
    from dtown_torch import types as T
    from dtown_torch.ops import state_kernel as sk
    from dtown_torch.render import blob_raster as br

    cfg = dtown_torch.EnvConfig(camera_width=64, camera_height=64,
                                mesh_fidelity="triangles")
    B = 8
    ib, fs, _ = dtown_torch.make_fused_rollout(cfg, maps, B, device=dev)
    pk = fs.pack
    blob = ib(torch.Generator(device=dev).manual_seed(5))
    kinds = maps.numpy().obj_kind
    slot = [i for i, k in enumerate(kinds) if k == T.OBJ_KIND_IDS[
        "duckhouse"]][0]
    ox, _, oz = (float(v) for v in maps.numpy().obj_pos[slot])
    for b in range(B):
        a = -math.pi + 2.0 * math.pi * b / B
        blob[sk.F_POS_X, b] = ox - 0.5 * math.cos(a)
        blob[sk.F_POS_Z, b] = oz + 0.5 * math.sin(a)
        blob[sk.F_ANGLE, b] = a
    img_k = br.render_frames_from_blob(blob, pk)
    img_r = br.render_frames_reference(blob, pk)
    err = float((img_k.int() - img_r.int()).abs().max())
    tri_objs = [o for o in range(pk["n_objs"])
                if int(pk["pi"][int(pk["oi"][o, br.OI_P0]), br.PI_TYPE])
                == br.TRI_T]
    culled = dict(pk, of=pk["of"].clone())
    culled["of"][tri_objs, br.O_CULL2] = 0.0
    img_c = br.render_frames_from_blob(blob, culled)
    won = int((img_c != img_k).any(1).sum())
    print(f"tri_mesh fixed poses, {B} envs 64x64: blob render vs plain max "
          f"|diff| {err:.0f}; pixels a triangle won {won} of "
          f"{B * 64 * 64} ({len(tri_objs)} mesh object(s), "
          f"{int((pk['pi'][:, br.PI_TYPE] == br.TRI_T).sum())} triangles)")
    if err > 0 or won <= 0:
        raise AssertionError("tri_mesh: triangles missing or the kernel "
                             "differs from its plain version")
    return won


def policy_flops(net, obs):
    """Forward FLOPs per env of the policy on one observation, counted
    from the layers' shapes: 2 x the multiply-adds of each convolution
    (output pixels x k x k x C_in x C_out) and dense layer (in x out);
    biases, activations and the pool are left out."""
    import torch
    from dtown_torch.learn import networks

    count = [0]

    def hook(mod, inp, out):
        w = mod.weight
        per_out = w[0].numel()  # k x k x C_in, or in
        rows = out.shape[0] if out.dim() > 1 else 1
        count[0] += 2 * per_out * out.numel() // rows

    hs = [m.register_forward_hook(hook) for m in net.modules()
          if isinstance(m, (networks.Conv, networks.Dense))]
    with torch.no_grad():
        net(obs)
    for h in hs:
        h.remove()
    return count[0]


def ppo_card_vs_cpu(dev):
    """One fused PPO iteration on loop_obstacles, 64 envs 32x32, rollout
    4, 2 epochs x 2 minibatches, on the card and on the CPU from the same
    parameters, blob, noise and permutations. Trajectory dones equal,
    rewards within 1e-3; loss within 1e-2 relative (+1e-4); each updated
    tensor's change within cosine 0.9 of the CPU's (cuDNN's bf16 against
    the CPU's: Adam's first steps turn bf16 noise in a small gradient into
    a +-lr step)."""
    import torch
    import dtown_torch
    from dtown_torch.learn import ppo as P
    from dtown_torch.learn.networks import ActorCritic

    cfg = dtown_torch.EnvConfig(camera_width=32, camera_height=32)
    maps = dtown_torch.load_map("loop_obstacles")
    ppo = P.PPOConfig(rollout_len=4, epochs=2, minibatches=2)
    B = 64
    res, start = {}, None
    for d in ("cpu", dev):
        init, train = P.make_ppo(cfg, maps, B, ppo, fused=True, device=d)
        if start is None:
            ts = init(torch.Generator().manual_seed(5))
            g = torch.Generator().manual_seed(6)
            start = (ts.net.state_dict(), ts.env_states,
                     P.obs_shape(train.obs_from(ts.env_states[1])),
                     torch.randn((4, B, 2), generator=g),
                     torch.stack([torch.randperm(4 * B, generator=g)
                                  for _ in range(2)]))
        sd, (blob, raw), shape, noise, perms = start
        net = ActorCritic(shape, device=d)
        net.load_state_dict(sd)
        ts = P.TrainState(net, P.make_optimizer(net, ppo),
                          (blob.to(d), raw.to(d)), None)
        ts, traj, last_value = train.rollout(ts, noise.to(d))
        adv, ret = train.gae(traj, last_value)
        ts, losses = train.update(ts, traj, adv, ret, perms.to(d))
        res[str(d)] = (traj["done"].cpu(), traj["reward"].cpu(),
                       float(losses.mean()),
                       {k: v.cpu() for k, v in ts.net.state_dict().items()})
    (dg, rg, lg, pg), (dc, rc, lc, pc) = res[str(dev)], res["cpu"]
    rew = float((rg - rc).abs().max())
    cos, pmax = 1.0, 0.0
    for k, p0 in start[0].items():
        a = (pg[k] - p0.cpu()).flatten()
        b = (pc[k] - p0.cpu()).flatten()
        pmax = max(pmax, float((a - b).abs().max()))
        if float(b.norm()) > 0:
            cos = min(cos, float(a @ b / (a.norm() * b.norm())))
    print(f"train (a) fused PPO card vs cpu (64 envs 32x32, rollout 4, 2x2):"
          f" dones equal {torch.equal(dg, dc)}, reward max |diff| {rew:.3g}"
          f" (bar 1e-3), loss {lg:.6g} vs {lc:.6g} (bar 1e-2 relative + "
          f"1e-4), updated parameters max |diff| {pmax:.3g}, least cosine "
          f"of a tensor's update {cos:.4f} (bar 0.9)")
    if not (torch.equal(dg, dc) and rew <= 1e-3
            and abs(lg - lc) <= 1e-2 * abs(lc) + 1e-4 and cos >= 0.9):
        raise AssertionError("fused PPO on the card disagrees with the CPU")


def timed_iteration(train, ts, gen, ppo, B, dev):
    """One PPO iteration through its pieces, as train_step draws them, with
    CUDA events at its edges: (ts, traj, losses, rollout ms, update ms,
    iteration ms)."""
    import torch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    T = ppo.rollout_len
    noise = torch.randn((T, B, 2), generator=gen, device=dev)
    perms = torch.stack([torch.randperm(T * B, generator=gen, device=dev)
                         for _ in range(ppo.epochs)])
    ev[1].record()
    ts, traj, last_value = train.rollout(ts, noise)
    adv, ret = train.gae(traj, last_value)
    ev[2].record()
    ts, losses = train.update(ts, traj, adv, ret, perms)
    ev[3].record()
    torch.cuda.synchronize()
    return (ts, traj, losses, ev[1].elapsed_time(ev[2]),
            ev[2].elapsed_time(ev[3]), ev[0].elapsed_time(ev[3]))


# train (b)'s training env-steps/s in this run, beside which phase 11 (a)
# prints its own
TRAIN_B = {}


def train_bench(dev, smi):
    """(b) Fused PPO at the bench's default: loop_obstacles, 4096 envs, 64x64
    RGB, NatureCNN, PPOConfig() (rollout 128, 4 epochs x 8 minibatches of
    65,536). One warm-up iteration, three timed; a profiler window of one
    rollout (K1 and K2) and one of one update; the kernels against their
    plain versions on the last blob. Returns the kernels' rows."""
    import torch
    import dtown_torch
    from dtown_torch.learn import ppo as P

    B = 4096
    cfg = dtown_torch.EnvConfig(camera_width=64, camera_height=64)
    ppo = P.PPOConfig()
    init, train = P.make_ppo(cfg, dtown_torch.load_map("loop_obstacles"), B,
                             ppo, fused=True, device=dev)
    torch.cuda.reset_peak_memory_stats()
    ts = init(torch.Generator(device=dev).manual_seed(0))
    gen = ts.generator
    ts, _, _, _, _, warm = timed_iteration(train, ts, gen, ppo, B, dev)
    reset_counts()  # counts of the timed iterations only
    runs = []
    for _ in range(3):
        ts, traj, losses, r_ms, u_ms, it_ms = timed_iteration(
            train, ts, gen, ppo, B, dev)
        runs.append((r_ms, u_ms, it_ms))
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    T = ppo.rollout_len
    raw = ts.env_states[1]
    f_fwd = policy_flops(ts.net, train.obs_from(raw[:1]))
    flops = f_fwd * (T * B + B) + 3 * f_fwd * ppo.epochs * T * B
    it_ms = sorted(r[2] for r in runs)[1]
    TRAIN_B["rate"] = T * B / (it_ms / 1e3)
    mfu = flops / (it_ms / 1e3) / PEAK_BF16
    print(f"train (b) fused PPO bench config, {B} envs 64x64 RGB, rollout "
          f"{T}, {ppo.epochs}x{ppo.minibatches} minibatches of "
          f"{T * B // ppo.minibatches} on {smi}: warm-up {warm:.1f} ms; "
          f"iterations (rollout, update, whole ms) {runs}; median "
          f"{it_ms:.1f} ms = {T * B / (it_ms / 1e3):.6g} training "
          f"env-steps/s; launches {launches}; peak memory "
          f"{peak / 2**30:.2f} GiB; policy forward {f_fwd / 1e6:.3f} MFLOP "
          f"an env, {flops:.4g} FLOP an iteration, train_mfu {mfu:.4f} "
          f"(of {PEAK_BF16:.3g} bf16 FLOP/s)")
    loss = float(losses.mean())
    if not (all(torch.isfinite(v).all() for v in ts.net.parameters())
            and torch.isfinite(traj["reward"]).all()
            and abs(loss) < float("inf")):
        raise AssertionError("train (b): non-finite loss, reward or weights")
    if launches["state_step"] != 3 * T or launches["blob_render"] != 3 * T:
        raise AssertionError(f"train (b): K1/K2 launches {launches}, want "
                             f"{3 * T} each")
    noise = torch.randn((T, B, 2), generator=gen, device=dev)
    box = {}

    def roll():
        box["ts"], box["traj"], _ = train.rollout(ts, noise)

    names = ["state_step_kernel", "blob_render_kernel"]
    dev_ms, busy, win = profile_window(roll, names, top=8)
    print(f"train (b): profiler, one rollout: window {win:.3f} ms, kernels "
          f"busy {busy:.3f} ms, device idle share {1.0 - busy / win:.4f}; "
          f"K1 {dev_ms.get(names[0], float('nan')):.5f} ms/launch, K2 "
          f"{dev_ms.get(names[1], float('nan')):.5f} ms/launch")
    if set(names) - dev_ms.keys():
        raise AssertionError(f"train (b): no device time for "
                             f"{set(names) - dev_ms.keys()}")
    traj = box["traj"]
    adv, ret = train.gae(traj, torch.zeros((B,), device=dev))
    perms = torch.stack([torch.randperm(T * B, generator=gen, device=dev)
                         for _ in range(ppo.epochs)])
    _, ubusy, uwin = profile_window(
        lambda: train.update(box["ts"], traj, adv, ret, perms), [], top=10)
    print(f"train (b): profiler, one update: window {uwin:.3f} ms, kernels "
          f"busy {ubusy:.3f} ms, device idle share {1.0 - ubusy / uwin:.4f}")
    blob = box["ts"].env_states[0]
    actions = torch.tanh(traj["action"][-1])
    fs = train.fused_step
    rows = held_rows("train", blob, actions, fs.tables, fs.pack, launches,
                     dev_ms)
    torch.cuda.empty_cache()
    return rows


def train_nav(dev, smi):
    """(c) One fused PPO iteration on nav_stack: stack3's maps, 4096 envs,
    64x64, Nav with the goal in the observation (the (image, goal)
    ActorCritic, K1 <1,1>), rollout 16."""
    import torch
    import dtown_torch
    from dtown_torch.learn import ppo as P

    B = 4096
    cfg = dtown_torch.EnvConfig(camera_width=64, camera_height=64)
    ppo = P.PPOConfig(rollout_len=16)
    init, train = P.make_ppo(cfg, dtown_torch.stack_maps(STACK3), B, ppo,
                             fused=True, nav=True, goal_in_obs=True,
                             device=dev)
    ts = init(torch.Generator(device=dev).manual_seed(1))
    reset_counts()
    t0 = time.perf_counter()
    ts, metrics = train(ts)
    metrics = {k: float(v) for k, v in metrics.items()}
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    print(f"train (c) fused Nav PPO nav_stack, {B} envs 64x64, goal in obs, "
          f"rollout 16: first iteration {ms:.1f} ms; metrics {metrics}; "
          f"launches {launches}")
    if not (abs(metrics["loss"]) < float("inf") and "goal_frac" in metrics
            and launches["state_step"] == 16
            and launches["blob_render"] == 16):
        raise AssertionError("train (c): Nav PPO malformed")


def train_learns(dev, smi):
    """(d) Fused PPO on state observations, small_loop, 1024 envs, rollout
    32, 30 iterations: tests/test_learning.py's bars (tail mean reward >
    head + 1.0, done_frac falling; head and tail are 5 iterations)."""
    import torch
    import dtown_torch
    from dtown_torch.learn import ppo as P

    cfg = dtown_torch.EnvConfig(obs_type="state")
    init, train = P.make_ppo(cfg, dtown_torch.load_map("small_loop"), 1024,
                             P.PPOConfig(rollout_len=32), fused=True,
                             device=dev)
    ts = init(torch.Generator(device=dev).manual_seed(0))
    hist = []
    t0 = time.perf_counter()
    for _ in range(30):
        ts, m = train(ts)
        hist.append((float(m["mean_reward"]), float(m["done_frac"])))
    s = time.perf_counter() - t0
    head = sum(h[0] for h in hist[:5]) / 5
    tail = sum(h[0] for h in hist[-5:]) / 5
    head_d = sum(h[1] for h in hist[:5]) / 5
    tail_d = sum(h[1] for h in hist[-5:]) / 5
    print(f"train (d) learning, state obs small_loop 1024 envs rollout 32, "
          f"30 iterations in {s:.1f} s: mean_reward head {head:.4f} -> tail "
          f"{tail:.4f} (bar: > head + 1.0), done_frac {head_d:.5f} -> "
          f"{tail_d:.5f} (bar: falling); per iteration "
          f"{[round(h[0], 3) for h in hist]}")
    if not (tail > head + 1.0 and tail_d < head_d):
        raise AssertionError("train (d): PPO did not learn on small_loop")


def train_step_path(dev, smi):
    """(e) One PPO iteration on the step path (make_ppo(fused=False) over
    env.make_vec_env, renderer="pallas"): loop_obstacles, 4096 envs,
    64x64, rollout 32, after a warm-up iteration. K3 must launch."""
    import torch
    import dtown_torch
    from dtown_torch.learn import ppo as P

    B, T = 4096, 32
    cfg = dtown_torch.EnvConfig(camera_width=64, camera_height=64,
                                renderer="pallas")
    init, train = P.make_ppo(cfg, dtown_torch.load_map("loop_obstacles"), B,
                             P.PPOConfig(rollout_len=T), device=dev)
    ts = init(torch.Generator(device=dev).manual_seed(2))
    ts, _ = train(ts)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ts, metrics = train(ts)
    metrics = {k: float(v) for k, v in metrics.items()}
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    print(f"train (e) step-path PPO, loop_obstacles {B} envs 64x64, rollout "
          f"{T}: {ms:.1f} ms = {T * B / (ms / 1e3):.6g} training "
          f"env-steps/s on {smi}; metrics {metrics}; launches {launches}")
    if not (abs(metrics["loss"]) < float("inf")
            and launches["row_render_static"] == T + 1):
        raise AssertionError("train (e): step-path PPO malformed or K3 "
                             "did not launch")


def train_phase(dev, smi):
    """The learner: (a) card vs CPU, (b) the bench's default timed, (c)
    nav_stack, (d) a learning check, (e) the step path. Returns the
    kernels' rows of (b)."""
    ppo_card_vs_cpu(dev)
    rows = train_bench(dev, smi)
    train_nav(dev, smi)
    train_learns(dev, smi)
    train_step_path(dev, smi)
    return rows



# ---- phase 11: training at scale -------------------------------------------------

DET_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
SCALE_DIR = "build/chip_smoke/scale"


def set_deterministic():
    """The settings under which two runs of one iteration agree to the bit
    on the card (cuDNN's convolution backward may otherwise pick
    non-deterministic engines); set before CUDA starts, CUBLAS_WORKSPACE_
    CONFIG comes from the environment (DET_ENV)."""
    import torch

    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False


def run_det(args, timeout):
    """``python chip_smoke.py --det <args>`` in a fresh process with the
    deterministic settings; returns its stdout, raises if it fails."""
    env = dict(os.environ, **DET_ENV)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--det",
                        *args], env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=timeout)
    if r.returncode != 0:
        raise AssertionError(f"--det {args[0]} failed ({r.returncode}):\n"
                             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    return r.stdout


def bench_cfg():
    import dtown_torch

    return (dtown_torch.EnvConfig(camera_width=64, camera_height=64),
            dtown_torch.load_map("loop_obstacles"))


def det_world1():
    """(a), in a deterministic process: one iteration of
    make_sharded_ppo(fused=True) on an NCCL group of one at the bench
    config, and one of the unsharded make_ppo from the same seed (rank 0's
    stream is the shared seed itself, and the all_reduce of one rank
    returns its input): the parameters must agree to the bit."""
    import torch
    import torch.distributed as dist
    from dtown_torch.learn import ppo as P
    from dtown_torch.parallel.mesh import make_mesh
    from dtown_torch.parallel.shard import make_sharded_ppo

    cfg, maps = bench_cfg()
    mesh = make_mesh("cuda")
    res = {}
    _, s_init, s_train = make_sharded_ppo(cfg, maps, 4096, P.PPOConfig(),
                                          mesh, fused=True)
    ts, m = s_train(s_init(0))
    res["sharded"] = {k: v.clone() for k, v in ts.net.state_dict().items()}
    del ts, s_train
    torch.cuda.empty_cache()
    u_init, u_train = P.make_ppo(cfg, maps, 4096, P.PPOConfig(), fused=True,
                                 device=mesh.device)
    ts, m2 = u_train(u_init(torch.Generator(device=mesh.device)
                            .manual_seed(0)))
    err = max(float((v - ts.net.state_dict()[k]).abs().max())
              for k, v in res["sharded"].items())
    same_m = {k: float(v) for k, v in m.items()} == \
        {k: float(v) for k, v in m2.items()}
    print(json.dumps({"backend": mesh.backend, "world": mesh.world,
                      "max_abs_err": err, "metrics_equal": same_m}))
    dist.destroy_process_group()


def scale_rank(out_dir):
    """(b), one of two ranks on the card over gloo with CUDA tensors: the
    collectives the learner uses on CUDA tensors, then one fused
    iteration of 2 x 64 envs 32x32 (rollout 128, 4 x 8 minibatches), its
    K1/K2 launches, and both kernels against their plain versions on the
    rank's last blob (max |diff| 0). Writes its parameters and results."""
    import torch
    import torch.distributed as dist
    import dtown_torch
    from dtown_torch.learn import ppo as P
    from dtown_torch.ops import state_kernel as sk
    from dtown_torch.parallel.mesh import make_mesh
    from dtown_torch.parallel.shard import make_sharded_ppo
    from dtown_torch.render import blob_raster as br

    mesh = make_mesh("cuda:0", backend="gloo")
    coll = {}
    x = torch.full((4,), float(mesh.rank + 1), device=mesh.device)
    for name, fn in (
            ("all_reduce", lambda: dist.all_reduce(x.clone())),
            ("broadcast", lambda: dist.broadcast(x.clone(), src=0)),
            ("all_gather", lambda: dist.all_gather(
                [torch.empty_like(x) for _ in range(mesh.world)], x))):
        fn()
        coll[name] = True
    y = x.clone()
    dist.all_reduce(y)
    coll["all_reduce_value"] = float(y[0])  # 1 + 2
    cfg = dtown_torch.EnvConfig(camera_width=32, camera_height=32)
    _, init, train = make_sharded_ppo(cfg, dtown_torch.load_map(
        "loop_obstacles"), 128, P.PPOConfig(), mesh, fused=True)
    ts = init(0)
    reset_counts()
    ts, metrics = train(ts)
    torch.cuda.synchronize()
    launches = read_counts()
    blob = ts.env_states[0]
    st, pk = train.local.fused_step.tables, train.local.fused_step.pack
    act = torch.tanh(torch.randn((blob.shape[1], 2), device=mesh.device,
                                 generator=torch.Generator(
                                     device=mesh.device).manual_seed(9)))
    k1 = sk.state_step(blob, act, st)
    k1_ref = sk.state_step_reference(blob, act[:, 0].contiguous(),
                                     act[:, 1].contiguous(), st)
    k1_err = float((k1 - k1_ref).abs().max())
    k2 = br.render_frames_from_blob(blob, pk)
    k2_err = float((k2.int() - render_plain(blob, pk).int()).abs().max())
    torch.save({k: v.cpu() for k, v in ts.net.state_dict().items()},
               os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    print(json.dumps({"rank": mesh.rank, "backend": mesh.backend,
                      "collectives_on_cuda": coll, "launches": launches,
                      "k1_max_abs_err": k1_err, "k2_max_abs_err": k2_err,
                      "metrics": {k: float(v) for k, v in metrics.items()}}))
    dist.destroy_process_group()


def scale_timed(dev, smi, train_b):
    """(a), timed at the default settings in this process: the bench
    config through make_sharded_ppo(fused=True) on an NCCL group of one,
    one warm-up and two timed iterations (CUDA events), K1/K2 launches,
    one rollout traced for their device ms, the all_reduce of the
    gradients timed alone, and both kernels against their plain versions
    on the last blob. Returns the kernels' rows."""
    import torch
    import torch.distributed as dist
    from dtown_torch.learn import ppo as P
    from dtown_torch.parallel.mesh import make_mesh
    from dtown_torch.parallel.shard import make_sharded_ppo

    cfg, maps = bench_cfg()
    ppo = P.PPOConfig()
    B, T = 4096, ppo.rollout_len
    mesh = make_mesh(dev)
    try:
        _, init, train = make_sharded_ppo(cfg, maps, B, ppo, mesh,
                                          fused=True)
        ts = init(0)
        ts, _ = train(ts)
        torch.cuda.synchronize()
        reset_counts()
        times = []
        for _ in range(2):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            ts, metrics = train(ts)
            ev[1].record()
            torch.cuda.synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
        launches = read_counts()
        metrics = {k: float(v) for k, v in metrics.items()}
        params = list(ts.net.parameters())
        n_grad = sum(p.numel() for p in params)
        ar_ms, _ = cuda_ms(lambda: P.pmean_grads_(params, mesh.group), 32)
        it_ms = sum(times) / len(times)
        rate = T * B / (it_ms / 1e3)
        print(f"scale (a) make_sharded_ppo fused, NCCL world {mesh.world}, "
              f"{B} envs 64x64, rollout {T}, {ppo.epochs}x"
              f"{ppo.minibatches} on {smi}: iterations {times} ms, mean "
              f"{it_ms:.1f} ms = {rate:.6g} training env-steps/s beside "
              f"train (b)'s {train_b.get('rate', float('nan')):.6g} in "
              f"this run ({rate / train_b.get('rate', float('nan')):.4f} "
              f"of it); launches {launches}; gradient all_reduce "
              f"({n_grad} f32, {4 * n_grad / 1e6:.2f} MB) {ar_ms:.4f} ms a "
              f"call, {ppo.epochs * ppo.minibatches} calls an iteration; "
              f"metrics {metrics}")
        if not (launches["state_step"] == 2 * T
                and launches["blob_render"] == 2 * T):
            raise AssertionError(f"scale (a): K1/K2 launches {launches}, "
                                 f"want {2 * T} each")
        if not all(abs(v) < float("inf") for v in metrics.values()):
            raise AssertionError("scale (a): non-finite metrics")
        noise = torch.randn((T, B, 2), generator=ts.generator, device=dev)
        box = {}

        def roll():
            box["ts"], box["traj"], _ = train.local.rollout(ts, noise)

        names = ["state_step_kernel", "blob_render_kernel"]
        dev_ms, busy, win = profile_window(roll, names)
        if set(names) - dev_ms.keys():
            raise AssertionError(f"scale (a): no device time for "
                                 f"{set(names) - dev_ms.keys()}")
        print(f"scale (a): profiler, one rollout: window {win:.3f} ms, "
              f"device idle share {1.0 - busy / win:.4f}")
        fs = train.local.fused_step
        rows = held_rows("scale", box["ts"].env_states[0],
                         torch.tanh(box["traj"]["action"][-1]), fs.tables,
                         fs.pack, launches, dev_ms)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return rows


def scale_phase(dev, smi, train_b):
    """Phase 11: (a) NCCL world 1 against the unsharded learner (a
    deterministic process), then timed here; (b) two ranks on the card
    over gloo; (c) train_ppo.main with checkpoints, killed and resumed as
    separate deterministic processes. Returns the kernels' rows of (a)."""
    import shutil
    import torch
    from dtown_torch.parallel.mesh import spawn_ranks
    from dtown_torch.utils import checkpoint

    t0 = time.time()
    out_dir = os.path.join(REPO, SCALE_DIR)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    res = json.loads(run_det(["world1"], 600).strip()
                     .splitlines()[-1])
    print(f"scale (a) deterministic, make_sharded_ppo fused on {res['backend']}"
          f" world {res['world']} vs make_ppo from the same seed, one "
          f"iteration at the bench config: parameters max |diff| "
          f"{res['max_abs_err']:.3g}, metrics equal {res['metrics_equal']}")
    if not (res["max_abs_err"] == 0 and res["metrics_equal"]):
        raise AssertionError("scale (a): world 1 differs from the unsharded "
                             "learner")
    rows = scale_timed(dev, smi, train_b)

    # (b) two ranks on one card over gloo; the parent built the kernels
    # (phase 2), so the ranks load the same libraries and build nothing
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    t1 = time.time()
    outs = spawn_ranks(2, [os.path.abspath(__file__), "--scale-rank",
                           out_dir], timeout=300, env=env, cwd=REPO)
    got = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    p0, p1 = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                         weights_only=True) for r in range(2)]
    same = all(torch.equal(p0[k], p1[k]) for k in p0)
    for g in got:
        print(f"scale (b) rank {g['rank']} of 2 on {g['backend']} (one "
              f"card): collectives on CUDA tensors {g['collectives_on_cuda']}"
              f"; launches {g['launches']}; K1 vs plain max |diff| "
              f"{g['k1_max_abs_err']:.3g}, K2 {g['k2_max_abs_err']:.3g}; "
              f"metrics {g['metrics']}")
    print(f"scale (b): parameters bit-identical across the ranks: {same} "
          f"({time.time() - t1:.1f} s)")
    if not same or any(g["k1_max_abs_err"] != 0 or g["k2_max_abs_err"] != 0
                       or g["launches"]["state_step"] != 128
                       or g["launches"]["blob_render"] != 128
                       or g["collectives_on_cuda"]["all_reduce_value"] != 3
                       for g in got):
        raise AssertionError("scale (b): ranks differ, a kernel differs "
                             "from its plain version, or a launch count "
                             "or a collective is wrong")

    # (c) the trainer: 2 iterations with a snapshot each, resumed for a
    # third, against 3 uninterrupted
    base = ["--fused", "--map", "loop_obstacles", "--envs", "4096",
            "--size", "64", "--rollout", "128", "--log-every", "1"]
    ck_a, ck_c = os.path.join(out_dir, "ck_a"), os.path.join(out_dir, "ck_c")
    t1 = time.time()
    outs = [run_det(["train", *base, "--iters", "2", "--ckpt", ck_a,
                     "--ckpt-every", "1"], 600),
            run_det(["train", *base, "--iters", "3", "--ckpt", ck_a,
                     "--resume", ck_a], 600),
            run_det(["train", *base, "--iters", "3", "--ckpt", ck_c], 600)]
    reports = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    fa, fc = checkpoint.restore_any(ck_a), checkpoint.restore_any(ck_c)
    err = max(float((fa["net"][k] - fc["net"][k]).abs().max())
              for k in fc["net"])
    size = os.path.getsize(os.path.join(checkpoint.resolve(ck_a),
                                        checkpoint.FILE))
    n_save = 2  # the report's saves: iterations 1 and 2 (the final save
    # follows the report)
    print(f"scale (c) train_ppo.main --fused at the bench config: 2 "
          f"iterations with --ckpt-every 1, then --resume for a third, "
          f"against 3 uninterrupted ({time.time() - t1:.1f} s in 3 "
          f"processes): resumed at iter {fa['it'] - 1} -> {fa['it']}, "
          f"parameters max |diff| {err:.3g}; checkpoint {size} bytes; save "
          f"{reports[0]['checkpoint']['seconds'] / n_save:.3f} s each "
          f"(of {n_save}), restore {reports[1]['restore']['seconds']:.3f} "
          f"s; resumed run {reports[1]}")
    if not (fa["it"] == fc["it"] == 3 and err == 0 and
            "resumed from" in outs[1]):
        raise AssertionError("scale (c): the resumed run differs from the "
                             "uninterrupted one")
    print(f"scale phase: {time.time() - t0:.1f} s")
    return rows



def probe_phase(dev, smi):
    """K5: the probe's loop in float32 and bfloat16 (counts of its run),
    the kernel vs its plain version on seeded inputs in [0.5, 1), the
    device time per launch from a trace, the rate and the bound. Returns
    the kernels' rows of the JSON line."""
    import torch
    from dtown_torch import probes

    x = torch.rand(probes.SHAPE, generator=torch.Generator(
        device=dev).manual_seed(3), device=dev) * 0.5 + 0.5
    n = x.numel()
    rows = []
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        kname = f"fma_chain_{tag}_kernel"
        reset_counts()  # counts of the probe's run only
        ms_iter, out = probes.run(dtype, torch.full(probes.SHAPE, 0.99,
                                                    device=dev))
        launches = read_counts()["fma_chain"]
        if launches <= 0 or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"probe {tag}: no launch or no output")
        y_k = probes.fma_chain(x, dtype)
        plain_ms, y_r = cuda_ms(
            lambda: probes.fma_chain_reference(x, dtype), 2)
        err = float((y_k - y_r).abs().max())
        def window(x=x, dtype=dtype):
            # the probe's loop body, long enough (~15-20 ms) that the
            # tracer is recording well before the last launches: an
            # 8-launch window (~2.5 ms) came back empty in some runs
            for _ in range(64):
                x = probes.fma_chain(x, dtype) * (1.0 - 1e-7)

        torch.cuda.synchronize()
        dev_ms, _, _, keys = profile_window(window, [kname], keys=True)
        how = "trace"
        if kname not in dev_ms:
            # the trace held no device time for it: say what it held, then
            # CUDA events around 20 back-to-back launches (the card runs
            # nothing else)
            print(f"probe {tag}: the trace's device keys: {keys}")
            dev_ms[kname] = cuda_ms(lambda: probes.fma_chain(x, dtype),
                                    20)[0]
            how = "CUDA events"
        # one instruction per multiply or add; bf16x2 instructions work on
        # two elements each, at the float32 issue rate
        nops = n * probes.OPS * 2 / (2 if tag == "bf16" else 1)
        b_ms, b_by = bound(n * 8, nops)
        rate = n * probes.OPS * 2 / (ms_iter / 1e3)
        print(f"probe {tag}: {ms_iter:.4f} ms/iter in the probe's loop "
              f"({rate / 1e12:.3f} Tflop/s, {launches} launches); kernel "
              f"{dev_ms[kname]:.5f} ms/launch ({how}; plain "
              f"{plain_ms:.3f} ms), "
              f"bound {b_ms:.6f} ms by {b_by}; vs plain max |diff| {err:.3g}"
              f" on {smi}")
        if err > 0:
            raise AssertionError(f"probe {tag}: kernel differs from its "
                                 f"plain version")
        rows.append(dict(name=f"fma_chain[{tag}]", route="cuda",
                         source="dtown_torch/csrc/fma_probe.cu",
                         replaces="scripts/bf16_probe.py:18",
                         launches=launches, max_abs_err=err,
                         ms=dev_ms[kname], plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None))
    return rows


def raster_diff(a, b):
    """(mean |diff|, share of values off by more than 1, max |diff|) of two
    uint8 frame batches, per frame (the worst frame's mean and share)."""
    d = (a.int() - b.int()).abs().reshape(a.shape[0], -1).float()
    return (float(d.mean(1).max()), float((d > 1).float().mean(1).max()),
            float(d.max()))


def vec_timed(tag, v_step, states, actions, dev, smi, n_steps, split=None):
    """A step-path run on the card: a warm-up, then n_steps timed with CUDA
    events (env-steps/s, peak memory), the render's share of a step (host
    clock, physics alone and render alone) and a profiler window of 2
    steps (the device's idle share). Returns (states, last output)."""
    import torch

    for _ in range(3):
        states, out = v_step(states, actions)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    B = states.batch_size
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_steps):
        states, out = v_step(states, actions)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"{tag}: {B} envs, {n_steps} steps in {ms:.2f} ms = "
          f"{B * n_steps / (ms / 1e3):.6g} env-steps/s ({ms / n_steps:.3f} "
          f"ms/step), peak memory {peak:.3f} GiB on {smi}")
    if split is not None:
        t = {}
        for name, fn in split.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(4):
                fn(states)
            torch.cuda.synchronize()
            t[name] = (time.perf_counter() - t0) / 4 * 1e3
        share = t["render"] / (t["render"] + t["physics"])
        print(f"{tag}: per step, host clock: physics {t['physics']:.3f} ms, "
              f"render {t['render']:.3f} ms (render share {share:.4f})")

    def window():
        s = states
        for _ in range(2):
            s, _ = v_step(s, actions)

    _, busy, win = profile_window(window, [])
    print(f"{tag}: profiler, 2 steps: window {win:.3f} ms, kernels busy "
          f"{busy:.3f} ms, device idle share {1.0 - busy / win:.4f}")
    if not (bool(torch.isfinite(out.reward).all())
            and float(out.obs.float().std()) > 5.0):
        raise AssertionError(f"{tag}: step output malformed")
    return states, out


def xla_card_vs_cpu(dev):
    """(g)'s check: make_vec with default arguments (renderer "xla") on the
    card vs the CPU, 8 envs 32x32 from the same states, 16 steps without
    auto-reset: poses within 1e-5, rewards 1e-4, speeds 3e-4, discrete
    outputs equal, the frames at the raster bars (mean |diff| <= 0.25,
    share > 1 <= 0.5% per frame)."""
    import torch
    import dtown_torch

    cfg = dtown_torch.EnvConfig(camera_width=32, camera_height=32,
                                auto_reset=False)
    (sg, og), (sc, oc) = card_and_cpu(cfg, "loop_obstacles", 8, 16, dev)
    pose = max(float((sg.pos - sc.pos).abs().max()),
               float((sg.angle - sc.angle).abs().max()))
    speed = float((sg.speed - sc.speed).abs().max())
    rew = float((og["reward"] - oc["reward"]).abs().max())
    same = all(torch.equal(og[k], oc[k])
               for k in ("done", "collision", "in_lane"))
    mean, share, mx = raster_diff(og["obs"], oc["obs"])
    print(f"(g) make_vec defaults card vs cpu (8 envs 32x32, 16 steps): "
          f"pose max |diff| {pose:.3g}, speed {speed:.3g}, reward "
          f"{rew:.3g}, discrete equal {same}; frames mean |diff| "
          f"{mean:.4g}, share >1 {share:.4g}, max {mx:.0f}")
    if not (pose < 1e-5 and speed <= 3e-4 and rew <= 1e-4 and same
            and mean <= 0.25 and share <= 0.005):
        raise AssertionError("(g): the card's step path disagrees with the "
                             "CPU's")


def planless_phase(tag, maps, dev, smi, n_steps, held):
    """A fused rollout past the blob render's budget, 4096 envs 64x64: the
    state kernel and (one map) K4 launch once a step; a timed run (CUDA
    events, per-launch device ms from a profiler window, peak memory), the
    output checked; then the kernels against their plain versions on the
    run's last blob and states (max |diff| 0). Returns the kernels' rows
    of the JSON line."""
    import torch
    import dtown_torch
    from dtown_torch.ops import fused_env as fe
    from dtown_torch.render import row_raster as rr

    B = 4096
    cfg = dtown_torch.EnvConfig()
    ib, fs, _ = dtown_torch.make_fused_rollout(cfg, maps, B, device=dev)
    st, pk = fs.tables, fs.pack
    if not pk.get("planless"):
        raise AssertionError(f"{tag}: the scene has a render plan")
    blob = ib(torch.Generator(device=dev).manual_seed(21))
    actions = torch.rand((B, 2), generator=torch.Generator(
        device=dev).manual_seed(22), device=dev)
    actions[:, 1] = actions[:, 1] * 2.0 - 1.0
    for _ in range(3):
        blob, out, obs = fs(blob, actions)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()  # counts of this path's run only
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    n_done = torch.zeros((), dtype=torch.int64, device=dev)
    start.record()
    for _ in range(n_steps):
        blob, out, obs = fs(blob, actions)
        n_done += out.done.sum()
    end.record()
    torch.cuda.synchronize()
    launches = read_counts()
    ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"{tag}: fused planless, {B} envs 64x64: {n_steps} steps in "
          f"{ms:.2f} ms = {B * n_steps / (ms / 1e3):.6g} env-steps/s "
          f"({ms / n_steps:.3f} ms/step), peak memory {peak:.3f} GiB on "
          f"{smi}; auto-resets {int(n_done)}; launches {launches}")
    want = {"state_step": n_steps,
            "row_render": 0 if maps.is_stack else n_steps}
    if any(launches[k] != n for k, n in want.items()) or \
            launches["blob_render"] or launches["row_render_static"]:
        raise AssertionError(f"{tag}: launches {launches}, want {want}")
    shape = (B, 64, 64, 3) if maps.is_stack else (B, 3, 32, 128)
    if not (tuple(obs.shape) == shape and obs.dtype == torch.uint8
            and float(obs.float().std()) > 5.0
            and bool(torch.isfinite(out.reward).all())):
        raise AssertionError(f"{tag}: output malformed {tuple(obs.shape)}")

    def window():
        b = blob
        for _ in range(4):
            b, _, _ = fs(b, actions)

    names = ["state_step_kernel", "row_render_kernel"]
    dev_ms, busy, win = profile_window(window, names)
    print(f"{tag}: profiler, 4 steps: window {win:.3f} ms, kernels busy "
          f"{busy:.3f} ms, device idle share {1.0 - busy / win:.4f}; "
          f"device ms/launch {dev_ms}")
    if "state_step_kernel" not in dev_ms or (
            not maps.is_stack and "row_render_kernel" not in dev_ms):
        raise AssertionError(f"{tag}: no device time in the trace")
    rows = held_rows(held, blob, actions, st, None, launches, dev_ms)
    if not maps.is_stack:
        maps_d = maps.to(dev)
        states = fe.update_states_from_blob(pk["template"], blob, maps_d,
                                            cfg.domain_rand)
        run = dict(cfg=cfg, maps=maps_d, pk=pk["rows"], states=states,
                   ms=dev_ms["row_render_kernel"])
        err, plain_ms, b_ms, b_by = row_kernel_check(run, dev)
        rows.append(dict(
            name=f"row_render[{held}]", route="cuda",
            source="dtown_torch/csrc/row_render.cu",
            replaces="dtown/render/pallas_raster.py:326",
            launches=launches["row_render"], max_abs_err=err,
            ms=dev_ms["row_render_kernel"], plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
    torch.cuda.empty_cache()
    return rows


def surface_phase(dev, smi):
    """The default env surface on the card: (g) make_vec with default
    arguments (the XLA ray-caster as batched torch), (h) a stack on the
    step path, (i) the gym env at 640x480, (j) the fused rollout past the
    render plan on one map (K1 and K4), (k) the same on a stack (K1 and
    the ray-caster). Returns (j)'s and (k)'s kernel rows."""
    import numpy as np
    import torch
    import dtown_torch
    from dtown_torch import env as tenv
    from dtown_torch.render import row_raster as rr

    B = 4096
    t0 = time.time()
    lap = lambda tag: print(f"{tag}: wall {time.time() - t0:.1f} s into "
                            f"the surface phase")
    # (g) ---------------------------------------------------------------
    xla_card_vs_cpu(dev)
    cfg, maps, v_reset, v_step = dtown_torch.make_vec("loop_obstacles", B)
    if v_step.pack is not None or cfg.renderer != "xla":
        raise AssertionError("(g): make_vec's defaults are not the "
                             "ray-caster")
    gen = torch.Generator(device=dev).manual_seed(0)
    actions = torch.rand((B, 2), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    actions[:, 1] = actions[:, 1] * 2.0 - 1.0
    split = {"physics": lambda s: tenv.step_physics(
        cfg, maps, s, actions, generator=gen, facts=v_step.facts),
        "render": lambda s: tenv.render_obs_batch(cfg, maps, s)}
    states, out = vec_timed("(g) make_vec loop_obstacles defaults",
                            v_step, v_reset(gen), actions, dev, smi, 64,
                            split)
    if out.obs.shape != (B, 64, 64, 3):
        raise AssertionError(f"(g): frames {tuple(out.obs.shape)}")
    # for information: the ray-caster against the row-fed static-scene
    # kernel (K3) on the same states, at dtown's bar between renderers
    pcfg = dtown_torch.EnvConfig(renderer="pallas")
    k3 = rr.planes_to_nhwc(pcfg, rr.render_frames_rows(
        pcfg, maps, states, pack=rr.pack_row_scene(pcfg, maps)))
    d = (k3.int() - out.obs.int()).abs().float()
    # out.obs are the frames of the states the step returned
    print(f"(g) ray-caster vs K3 on the same states: mean |diff| "
          f"{float(d.mean()):.4g}, share >10 {float((d > 10).float().mean()):.4g}"
          f" (dtown's bar between renderers: < 2.0 and < 0.03)")
    del states, out, k3, d
    torch.cuda.empty_cache()
    lap("(g)")

    # (h) ---------------------------------------------------------------
    cfg, maps, v_reset, v_step = dtown_torch.make_vec(STACK3, B)
    split = {"physics": lambda s: tenv.step_physics(
        cfg, maps, s, actions, generator=gen, facts=v_step.facts),
        "render": lambda s: tenv.render_obs_batch(cfg, maps, s)}
    states, out = vec_timed("(h) make_vec stack3", v_step, v_reset(gen),
                            actions, dev, smi, 32, split)
    if not (out.obs.shape == (B, 64, 64, 3) and torch.equal(
            states.map_idx.cpu(), torch.arange(B, dtype=torch.int32) % 3)):
        raise AssertionError("(h): frames or map indices malformed")
    del states, out
    torch.cuda.empty_cache()
    lap("(h)")

    # (i) ---------------------------------------------------------------
    env = dtown_torch.make("loop_obstacles")
    obs = env.reset()
    for _ in range(3):
        obs, r, done, info = env.step([0.5, 0.05])
    t_gym = time.perf_counter()
    for _ in range(200):
        obs, r, done, info = env.step([0.5, 0.05])
        if done:
            obs = env.reset()
    dt = time.perf_counter() - t_gym
    td = env.render("top_down")
    red = int(((td[..., 0] > 180) & (td[..., 1] < 90)
               & (td[..., 2] < 90)).sum())
    print(f"(i) gym make('loop_obstacles'), 640x480: 200 steps with numpy "
          f"frames in {dt * 1e3:.1f} ms = {200 / dt:.5g} steps/s on {smi}; "
          f"top-down {td.shape} {td.dtype}, marker pixels {red}")
    if not (obs.shape == (480, 640, 3) and obs.dtype == np.uint8
            and td.shape == (480, 640, 3) and td.dtype == np.uint8
            and red > 3 and np.isfinite(r)):
        raise AssertionError("(i): gym frames malformed")
    lap("(i)")

    # (j), (k) ----------------------------------------------------------
    rows = planless_phase("(j) dense_obstacles", write_dense_map(), dev,
                          smi, 32, "dense_fallback")
    lap("(j)")
    rows += planless_phase("(k) udem1 x 4", dtown_torch.stack_maps(
        ["udem1"] * 4), dev, smi, 32, "stack_fallback")
    lap("(k)")
    return rows


# ---- phase 12: the measurement tools -----------------------------------------------

def tool_launches(tag, fn, kernels):
    """fn() with every launch count set to 0 just before it; fails unless
    each of ``kernels`` launched in it. Returns fn's result."""
    import torch

    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"tools {tag}: launches {launches}")
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"tools {tag}: {missing} never launched")
    return out


def native_maps_check():
    """(h): dtown_torch.native on every shipped map against the port's
    python compiler, at tests/test_torch_native.py's bars (grids, curve
    masks, object kinds and packed tile words equal; curves and object
    fields within 1e-6), and native/libdtown_mapc.so unchanged."""
    import hashlib
    import numpy as np
    from dtown_torch import map_loader, native
    from dtown_torch.render.blob_raster import pack_tile_words

    tracked = os.path.join(REPO, "native", "libdtown_mapc.so")

    def sha():
        with open(tracked, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    before = sha()
    t0 = time.time()
    lib = native.build_library()
    print(f"tools (h): native library built in {time.time() - t0:.1f} s "
          f"({os.path.relpath(lib, REPO)})")
    bad = {}
    names = map_loader.list_maps()
    for name in names:
        nat = native.compile_map_native(
            os.path.join(map_loader.MAPS_DIR, f"{name}.yaml"))
        py = map_loader.load_map(name)
        M = int(nat["n_objects"])
        words = np.asarray(pack_tile_words(py.tile_kind, py.tile_angle),
                           np.int64).astype(np.int32)
        errs = [f for f in ("tile_kind", "tile_angle", "drivable",
                            "curve_mask") if not np.array_equal(
            nat[f], getattr(py, f))]
        errs += [f for f in ("obj_pos", "obj_y_rot", "obj_scale",
                             "obj_corners", "obj_norms", "obj_safety_rad",
                             "obj_halfdims", "obj_height", "obj_walk_dist")
                 if not np.allclose(nat[f][:M], getattr(py, f)[:M],
                                    rtol=0.0, atol=1e-6)]
        if not np.allclose(nat["curves"], py.curves, rtol=0.0, atol=1e-6):
            errs.append("curves")
        if not (np.array_equal(nat["obj_kind"][:M], py.obj_kind[:M])
                and np.array_equal(nat["obj_dynamic"][:M],
                                   py.obj_is_dynamic[:M])):
            errs.append("obj_kind/obj_dynamic")
        if not np.array_equal(nat["tile_words"], words):
            errs.append("tile_words")
        if errs:
            bad[name] = errs
    same = sha() == before
    print(f"tools (h): native map compiler vs map_loader on {len(names)} "
          f"maps: mismatches {bad or 'none'}; native/libdtown_mapc.so "
          f"unchanged {same}")
    if bad or not same:
        raise AssertionError("tools (h): the native map compiler disagrees "
                             "with map_loader, or native/ was written")


def tools_phase(dev, smi):
    """The measurement tools (python -m dtown_torch.<tool>) through their
    entry functions, each print prefixed "tools (x)": (a) bench at its
    defaults, its rate within 0.5-2x of fused_phase's "bench" cell of
    this run; (b) bench --obs state (printed only: host-bound); (c) bench
    --no-fused --renderer pallas --iters 32 (K3); (d) perf_probe at its
    defaults, full >= max(state, render); (e) bench_profile on
    udem1, 1024 envs 64x64; (f) roofline_objpass on udem1, 4096 envs, its
    gap >= 1.0; (g) benchmark --steps 50; (h) native_maps_check."""
    from dtown_torch import EnvConfig, bench, bench_profile, benchmark, \
        load_map, perf_probe, roofline_objpass

    t0 = time.time()
    print(f"tools phase on {smi}")
    out = tool_launches("(a)", lambda: bench.run(bench.parse_args([])),
                        ["state_step", "blob_render"])
    ratio = out["value"] / FUSED_RATE["bench"]
    print(f"tools (a) bench: {json.dumps(out)}; {ratio:.4f} of the fused "
          f"cell's {FUSED_RATE['bench']:.6g} env-steps/s")
    if not 0.5 <= ratio <= 2.0:
        raise AssertionError("tools (a): bench disagrees with fused_phase")
    out = tool_launches("(b)", lambda: bench.run(bench.parse_args(
        ["--obs", "state"])), ["state_step"])
    print(f"tools (b) bench --obs state: {json.dumps(out)}")
    out = tool_launches("(c)", lambda: bench.run(bench.parse_args(
        ["--no-fused", "--renderer", "pallas", "--iters", "32"])),
        ["row_render_static"])
    print(f"tools (c) bench --no-fused: {json.dumps(out)}")
    cfg = EnvConfig(obs_type="rgb", camera_width=64, camera_height=64,
                    renderer="pallas")
    rep = tool_launches("(d)", lambda: perf_probe.probe(
        cfg, load_map("loop_obstacles"), 4096, 200, dev),
        ["state_step", "blob_render"])
    print(f"tools (d) perf_probe, ms/step: "
          f"{json.dumps({k: v * 1e3 for k, v in rep.items()})}")
    if rep["full"] < max(rep["state"], rep["render"]):
        raise AssertionError("tools (d): full step below one of its parts")
    res = bench_profile.profile(
        EnvConfig(obs_type="rgb", camera_width=64, camera_height=64),
        load_map("udem1"), 1024, 10, dev)
    print(f"tools (e) bench_profile udem1 1024 envs, ms/iter: "
          f"{json.dumps(res)}")
    out = tool_launches("(f)", lambda: roofline_objpass.objpass(
        "udem1", 4096, 64, 64, dev), ["blob_render"])
    print(f"tools (f) roofline_objpass: {json.dumps(out)}")
    if not out["value"] >= 1.0:
        raise AssertionError("tools (f): object pass faster than its "
                             "bound: the count is wrong")
    out = benchmark.measure("udem1", 50, 640, 480, dev)
    print(f"tools (g) benchmark: {json.dumps(out)}")
    native_maps_check()
    print(f"tools phase: {time.time() - t0:.1f} s")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import dtown_torch
    from dtown_torch import _build

    t_start = time.time()
    smi = nvidia_smi_line()
    print(f"card: {smi}")
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind}")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    # ---- build ------------------------------------------------------------
    t0 = time.time()
    logs = _build.build_all()
    print(f"build: {time.time() - t0:.1f} s")
    for name, log in logs.items():
        lines = ptxas_report(log)
        for line in lines:
            print(f"  {name}: {line}")
        if log:
            summary = spill_summary(lines)
            print(f"  {name}: {summary}")
            if name in ("state_kernel", "row_render") and \
                    not summary.endswith("none"):
                raise AssertionError(f"{name}.cu spills: {summary}")

    # ---- fused rollout: card vs CPU on a small input -----------------------------
    maps = dtown_torch.load_map("loop_obstacles")
    cfg_small = dtown_torch.EnvConfig(camera_width=32, camera_height=32)
    outs = {}
    start_blob = None
    for d_ in ("cpu", dev):
        ib, fs, ro = dtown_torch.make_fused_rollout(cfg_small, maps, 64,
                                                    device=d_)
        if start_blob is None:
            start_blob = ib(torch.Generator().manual_seed(7))
        b_ = start_blob.to(d_)
        a_ = torch.full((64, 2), 0.3, device=d_)
        a_[:, 1] = 0.4
        b_, r_, o_ = ro(b_, a_, 4)
        _, _, obs_ = fs(b_, a_)
        outs[str(d_)] = (b_.cpu(), float(r_), int(o_), obs_.cpu())
    (bg, rg, og, obg), (bc, rc, oc, obc) = outs[str(dev)], outs["cpu"]
    small_err = float((bg - bc).abs().max())
    obs_diff = (obg.int() - obc.int()).abs().float().mean()
    print(f"rollout card vs cpu (64 envs 32x32, 5 steps): blob max |diff| "
          f"{small_err:.3g}, reward sum {rg:.6g} vs {rc:.6g}, obs checksum "
          f"{og} vs {oc}, obs mean |diff| {float(obs_diff):.3g}")
    if not (small_err <= 1e-4 and abs(rg - rc) <= 1e-3
            and float(obs_diff) <= 0.01):
        raise AssertionError("card rollout disagrees with the CPU rollout")

    # ---- the fused rollout in each configuration, the bench's first --------------
    kernels = []
    for tag, map_name, B, S, n_t, kw in (
            ("bench", "loop_obstacles", 4096, 64, 256, {}),
            ("baseline4", "udem1", 4096, 96, 256, dict(domain_rand=True)),
            ("npc", "town_dyn_duckiebots", 4096, 64, 64, {}),
            ("npc_dr_gray", "bigtown_pedestrians", 4096, 64, 64,
             dict(domain_rand=True, grayscale=True)),
            ("baseline2", "small_loop", 256, 64, 64, dict(grayscale=True)),
            ("state", "loop_pedestrians", 4096, 64, 256,
             dict(obs_type="state")),
            ("npc10_state", NPC10, 4096, 64, 256, dict(obs_type="state")),
            ("stack3", STACK3, 8192, 64, 128, {}),
            ("stack6", STACK6, 4096, 64, 64, {}),
            ("stack_npc_dr", ["town_dyn_duckiebots", "udem1"], 4096, 64,
             64, dict(domain_rand=True)),
            # Nav at train_ppo.py's default (no shaping); the check also
            # drives the shaping branch
            ("nav_stack", STACK3, 4096, 64, 64,
             dict(nav=True, check=dict(nav_shaping_coef=2.0))),
            ("fisheye", "loop_obstacles", 4096, 64, 256,
             dict(distortion=True)),
            ("fisheye_dr", "small_loop", 4096, 64, 64,
             dict(domain_rand=True, distortion=True)),
            ("native_res", "loop_obstacles", 512, (640, 480), 64, {}),
            ("fisheye_native", "loop_obstacles", 512, (640, 480), 64,
             dict(distortion=True))):
        kernels += fused_phase(tag, map_name, dev, smi, B, S, n_t, **kw)
    k1_edge_phase(dev)
    tri_map = tri_mesh_map()
    kernels += fused_phase("tri_mesh", tri_map, dev, smi, 4096, 64, 64,
                           mesh_fidelity="triangles")
    tri_pixels_won(tri_map, dev)

    # ---- the step path: vector env on the card vs the CPU ---------------------------
    for name, kw in (("loop_obstacles", {}), ("town_dyn_duckiebots", {}),
                     ("udem1", dict(domain_rand=True)),
                     ("loop_obstacles", dict(distortion=True)),
                     ("bigtown", dict(distortion=True))):
        vec_card_vs_cpu(name, dev, **kw)

    # ---- the step path at full width: K3 map, K4 map, K4 under DR --------------------
    replaces = {"row_render_static": "dtown/render/pallas_raster.py:861",
                "row_render": "dtown/render/pallas_raster.py:326"}
    for name, kname, sfx, n_t, kw in (
            ("loop_obstacles", "row_render_static", "", 128, {}),
            ("bigtown", "row_render", "", 128, {}),
            ("udem1", "row_render", "[udem1_dr]", 64,
             dict(domain_rand=True)),
            ("loop_obstacles", "row_render_static", "[fisheye]", 64,
             dict(distortion=True)),
            ("bigtown", "row_render", "[fisheye]", 64,
             dict(distortion=True))):
        run = vec_main_path(name, dev, smi, n_steps=n_t, **kw)
        if run["launches"][kname] <= 0:
            raise AssertionError(f"{kname} never launched on {name}")
        err, plain_ms, b_ms, b_by = row_kernel_check(run, dev)
        kernels.append(dict(
            name=kname + sfx, route="cuda",
            source="dtown_torch/csrc/row_render.cu", replaces=replaces[kname],
            launches=run["launches"][kname], max_abs_err=err, ms=run["ms"],
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None))
        del run
        torch.cuda.empty_cache()

    # ---- the default env surface: the ray-caster, stacks, gym, planless ------------
    t0 = time.time()
    kernels += surface_phase(dev, smi)
    print(f"surface phase: {time.time() - t0:.1f} s")

    # ---- the PPO learner on the fused rollout and the step path ----------------------
    kernels += train_phase(dev, smi)

    # ---- the throughput probe (K5) --------------------------------------------------
    kernels += probe_phase(dev, smi)

    # ---- training at scale: ranks, checkpoints, resume -------------------------------
    kernels += scale_phase(dev, smi, TRAIN_B)

    # ---- the measurement tools -----------------------------------------------------
    tools_phase(dev, smi)
    print(f"total wall {time.time() - t_start:.1f} s")
    print(nvidia_smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def sub_main(argv):
    """The processes that phase 11 starts: ``--det world1`` and ``--det
    train <trainer flags>`` under the deterministic settings, and
    ``--scale-rank <dir>`` as one of (b)'s two ranks."""
    if argv[0] == "--det":
        set_deterministic()
        if argv[1] == "world1":
            det_world1()
        else:  # (c): the trainer itself
            from dtown_torch.train_ppo import main as train_main

            train_main(argv[2:])
    else:
        scale_rank(argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(sub_main(sys.argv[1:]) if sys.argv[1:] else main())
