#!/usr/bin/env python3
"""Smoke run of dtown_torch on one NVIDIA card: builds the CUDA kernels,
holds each against its plain torch version, drives the fused RGB rollout
of the default bench configuration, and prints what it measured.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. the card's name and power limit (nvidia-smi);
  2. build both kernels from dtown_torch/csrc (one nvcc each, in parallel);
  3. state kernel vs state_step_reference: loop_obstacles, 4096 envs,
     16 steps, max_steps=5 so timeouts force auto-resets; discrete rows
     equal, pose within 1e-5, reward within 1e-4;
  4. the fused RGB rollout at the bench configuration (loop_obstacles, 4096 envs,
     64x64 RGB, auto-reset, marking AA, obj_lod_px=2.0) on the card vs the
     same rollout on the CPU at 64 envs 32x32, then 256 timed steps on the
     card (CUDA events); launch counts must be > 0 for both kernels;
  5. a torch.profiler trace of 32 steps: each kernel's device time per
     launch and the device's idle share; fails if a kernel is missing;
  6. blob render kernel vs render_frames_reference on the main path's
     4096-env blob at 64x64; mean |diff| <= 0.01 and share of |diff| > 2
     <= 1e-4 u8 counts;
  7. the plain versions' times, and the least time the card could take
     (bound) from this run's inputs.
Needs CUDA; imports nothing of JAX.
"""
import json
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA H100 datasheet): HBM bytes/s and
# float32 FLOP/s outside the tensor cores, which counts an FMA as two.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# Both kernels build with -fmad=false, so every add or mul is an
# instruction of its own: the float32 lanes issue PEAK_F32 / 2 of them a
# second. Integer, compare and select instructions issue on lanes no wider,
# so counted instructions over this rate is still the least time.
PEAK_INSTR = PEAK_F32 / 2

# Instruction counts per unit of work, counted by hand from the kernel
# sources (arithmetic, compare and select instructions; a sqrt, divide or
# table load counts as one). Estimates: they set the operation bound.
K1_OPS_ENV = 900          # state_kernel.cu without the SAT loop
K1_OPS_OBJECT = 160       # SAT (4 axes x 8 projections) + proximity
K2_OPS_PIXEL = 150        # camera, ground hit, tile shading, sky, output
K2_OPS_OBJECT = 8         # distance cull of one object
K2_OPS_BOX_OBJECT = 32    # model-space ray setup of a box object
K2_OPS_BOX = 40           # one box primitive (slabs, shading, fold)
K2_OPS_SPHERE = 32        # one sphere primitive


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


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


def profile_rollout(rollout, blob, actions, n):
    """torch.profiler over n rollout steps. Returns (device ms per launch
    of each of our kernels, device ms of all kernels, window ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        rollout(blob, actions, n)
        end.record()
        torch.cuda.synchronize()
    per, busy = {}, 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host events; kernels are the device-side entries
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
        busy += t
        for k in ("state_step_kernel", "blob_render_kernel"):
            if k in ev.key and ev.count:
                per[k] = t / ev.count
    return per, busy, start.elapsed_time(end)


def k2_ops(blob, pk, P):
    """Operations the render does on this blob: per pixel the ground pass,
    per env the objects and primitives its culls keep."""
    import torch
    from dtown_torch.geometry import sincos
    from dtown_torch.ops import state_kernel as sk
    from dtown_torch.render import blob_raster as br

    of, oi = pk["of"].cpu().double(), pk["oi"].cpu()
    pf, pi = pk["pf"].cpu().double(), pk["pi"].cpu()
    b = blob.cpu()
    s, c = sincos(b[sk.F_ANGLE])
    cam = float(pk["scene"][0])
    eye0 = (b[sk.F_POS_X] + cam * c).double()
    eye2 = (b[sk.F_POS_Z] - cam * s).double()
    per_env = torch.full_like(eye0, float(K2_OPS_PIXEL))
    for o in range(pk["n_objs"]):
        d2 = (of[o, br.O_X] - eye0) ** 2 + (of[o, br.O_Z] - eye2) ** 2
        act = d2 < of[o, br.O_CULL2]
        per_env += K2_OPS_OBJECT
        if oi[o, br.OI_BOX]:
            per_env += act.double() * K2_OPS_BOX_OBJECT
        p0, n_p = int(oi[o, br.OI_P0]), int(oi[o, br.OI_NP])
        for j in range(p0, p0 + n_p):
            gate = (d2 < pf[j, br.P_CD2]) if pi[j, br.PI_OWN] else act
            cost = K2_OPS_BOX if pi[j, br.PI_BOX] else K2_OPS_SPHERE
            per_env += gate.double() * cost
    return float(per_env.sum()) * P


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import dtown_torch
    from dtown_torch import _build
    from dtown_torch.ops import state_kernel as sk
    from dtown_torch.render import blob_raster as br

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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    maps = dtown_torch.load_map("loop_obstacles")
    B = 4096
    gen = torch.Generator().manual_seed(0)

    # ---- state kernel vs its plain version -----------------------------------
    cfg_s = dtown_torch.EnvConfig(max_steps=5)
    st = sk.device_tables(cfg_s, sk.build_tables(cfg_s, maps), dev)
    init_blob, _, _ = dtown_torch.make_fused_rollout(cfg_s, maps, B,
                                                     device=dev)
    blob = init_blob(gen)
    discrete = (sk.F_DONE, sk.F_STEP, sk.F_RNG, sk.F_COLL, sk.F_INLANE,
                sk.F_OINLANE)
    pose = (sk.F_POS_X, sk.F_POS_Y, sk.F_POS_Z, sk.F_ANGLE)
    k1_err = pose_err = rew_err = 0.0
    k1_rows = []
    n_done = 0
    for _ in range(16):
        act = torch.rand((B, 2), generator=gen).mul_(2.0).sub_(1.0).to(dev)
        ref = sk.state_step_reference(blob, act[:, 0], act[:, 1], st)
        out = sk.state_step(blob, act, st)
        torch.cuda.synchronize()
        for f in discrete:
            if not torch.equal(out[f], ref[f]):
                raise AssertionError(f"state kernel row {f} differs from "
                                     f"the plain version")
        d = (out - ref).abs()
        if float(d.max()) > k1_err:
            k1_err = float(d.max())
            k1_rows = torch.nonzero(d.amax(1)).flatten().tolist()
        pose_err = max(pose_err, float(d[list(pose)].max()))
        rew_err = max(rew_err, float(d[sk.F_REWARD].max()))
        n_done += int(out[sk.F_DONE].sum())
        blob = out
    print(f"state kernel vs plain: 16 steps x {B} envs, {n_done} auto-"
          f"resets; max |diff| all rows {k1_err:.3g} (rows that differ: "
          f"{k1_rows}), pose {pose_err:.3g}, reward {rew_err:.3g}")
    if not (pose_err <= 1e-5 and rew_err <= 1e-4 and n_done > 0):
        raise AssertionError("state kernel outside its bars")

    # ---- fused rollout: card vs CPU on a small input -----------------------------
    cfg_small = dtown_torch.EnvConfig(camera_width=32, camera_height=32)
    outs = {}
    for d_ in (dev, "cpu"):
        ib, fs, ro = dtown_torch.make_fused_rollout(cfg_small, maps, 64,
                                                    device=d_)
        b_ = ib(torch.Generator().manual_seed(7))
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

    # ---- the main path: fused RGB rollout at the bench configuration ------------
    cfg = dtown_torch.EnvConfig(camera_width=64, camera_height=64)
    init_blob, fused_step, rollout = dtown_torch.make_fused_rollout(
        cfg, maps, B, device=dev)
    blob = init_blob(torch.Generator().manual_seed(1))
    actions = torch.rand((B, 2), generator=gen).to(dev)
    blob, _, _ = rollout(blob, actions, 8)              # warm-up
    torch.cuda.synchronize()
    n_steps = 256
    sk.state_step.launches = 0
    br.render_frames_from_blob.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    blob, rsum, osum = rollout(blob, actions, n_steps)
    end.record()
    torch.cuda.synchronize()
    launches = {"state_step": sk.state_step.launches,
                "blob_render": br.render_frames_from_blob.launches}
    ms = start.elapsed_time(end)
    rate = B * n_steps / (ms / 1e3)
    _, out, obs = fused_step(blob, actions)
    torch.cuda.synchronize()
    print(f"fused RGB rollout, loop_obstacles {B} envs 64x64: {n_steps} "
          f"steps in {ms:.2f} ms = {rate:.6g} env-steps/s "
          f"({ms / n_steps:.4f} ms/step) on {smi}")
    print(f"launches in the timed run: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError("a kernel of the main path never launched")
    if not (obs.shape == (B, 3, 32, 128) and obs.dtype == torch.uint8
            and bool(torch.isfinite(blob).all())
            and bool(torch.isfinite(out.reward).all())
            and float(obs.float().std()) > 5.0):
        raise AssertionError("rollout output malformed")
    print(f"last step: reward sum {float(rsum):.6g}, obs checksum "
          f"{int(osum)}, done {int(out.done.sum())}")

    # ---- device trace of a short window of the main path ----------------------------
    dev_ms, busy_ms, win_ms = profile_rollout(rollout, blob, actions, 32)
    print(f"profiler, 32 steps: window {win_ms:.3f} ms, kernels busy "
          f"{busy_ms:.3f} ms, device idle share "
          f"{1.0 - busy_ms / win_ms:.4f}; device ms/launch {dev_ms}")
    missing = {"state_step_kernel", "blob_render_kernel"} - dev_ms.keys()
    if missing:
        raise AssertionError(f"no device time in the trace for {missing}")
    k1_ms = dev_ms["state_step_kernel"]
    k2_ms = dev_ms["blob_render_kernel"]

    # ---- blob render kernel vs its plain version on the main path's blob ----------
    pk = br.pack_plan(cfg, br.build_render_plan(cfg, maps), dev)
    img_k = br.render_frames_from_blob(blob, pk)
    k2_plain, img_r = cuda_ms(lambda: br.render_frames_reference(blob, pk), 3)
    diff = (img_k.int() - img_r.int()).abs()
    k2_mean = float(diff.float().mean())
    k2_frac = float((diff > 2).float().mean())
    k2_err = float(diff.max())
    del img_k, img_r, diff
    print(f"blob render vs plain: {B} envs 64x64, mean |diff| {k2_mean:.3g},"
          f" share |diff|>2 {k2_frac:.3g}, max {k2_err:.0f}")
    if not (k2_mean <= 0.01 and k2_frac <= 1e-4):
        raise AssertionError("blob render kernel outside its bars")

    # ---- plain versions' times and bounds -------------------------------------------
    st = sk.device_tables(cfg, sk.build_tables(cfg, maps), dev)
    act0, act1 = actions[:, 0].contiguous(), actions[:, 1].contiguous()
    k1_plain, _ = cuda_ms(
        lambda: sk.state_step_reference(blob, act0, act1, st), 5)
    nf = blob.shape[0]
    tab_bytes = sum(st[k].numel() * st[k].element_size()
                    for k in ("words", "ct", "ot", "bank", "prm"))
    k1_bytes = 2 * nf * B * 4 + 2 * B * 4 + tab_bytes
    k1_ops = B * (K1_OPS_ENV + K1_OPS_OBJECT * st["M"])
    P = 64 * 64
    pk_bytes = sum(pk[k].numel() * pk[k].element_size()
                   for k in ("rays", "words", "scene", "of", "oi", "pf",
                             "pi"))
    k2_bytes = B * 3 * P + 5 * B * 4 + pk_bytes
    k2_opc = k2_ops(blob, pk, P)

    def bound(nbytes, nops):
        tb, to = nbytes / PEAK_BYTES * 1e3, nops / PEAK_INSTR * 1e3
        return max(tb, to), ("bytes" if tb >= to else "operations")

    k1_bound, k1_by = bound(k1_bytes, k1_ops)
    k2_bound, k2_by = bound(k2_bytes, k2_opc)
    print(f"state kernel: {k1_ms:.5f} ms/launch (plain {k1_plain:.4f} ms), "
          f"bound {k1_bound:.6f} ms by {k1_by} ({k1_bytes} B, "
          f"{k1_ops:.4g} ops)")
    print(f"blob render: {k2_ms:.5f} ms/launch (plain {k2_plain:.4f} ms), "
          f"bound {k2_bound:.6f} ms by {k2_by} ({k2_bytes} B, "
          f"{k2_opc:.4g} ops)")
    print(f"total wall {time.time() - t_start:.1f} s")

    kernels = [
        dict(name="state_step", route="cuda",
             source="dtown_torch/csrc/state_kernel.cu",
             replaces="dtown/ops/state_kernel.py:203",
             launches=launches["state_step"], max_abs_err=k1_err,
             ms=k1_ms, plain_ms=k1_plain, bound_ms=k1_bound,
             bound_by=k1_by, library_ms=None),
        dict(name="blob_render", route="cuda",
             source="dtown_torch/csrc/blob_render.cu",
             replaces="dtown/render/blob_raster.py:574",
             launches=launches["blob_render"], max_abs_err=k2_err,
             ms=k2_ms, plain_ms=k2_plain, bound_ms=k2_bound,
             bound_by=k2_by, library_ms=None),
    ]
    print(nvidia_smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
