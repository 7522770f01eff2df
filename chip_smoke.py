#!/usr/bin/env python3
"""Smoke run of dtown_torch on one NVIDIA card: builds the CUDA kernels,
holds each against its plain torch version, drives the fused RGB rollout
of the default bench configuration and the vectorized step API
(make_vec) on a static-scene map and a row-fed map, and prints what it
measured.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. the card's name and power limit (nvidia-smi);
  2. build the three kernel sources from dtown_torch/csrc (one nvcc each,
     in parallel), printing registers and spill;
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
  7. the vector env on the card vs the CPU at 64 envs 32x32 from the same
     states, 5 steps without auto-reset, on loop_obstacles (K3) and
     town_dyn_duckiebots (K4, scripted bots): poses within 1e-5, reward
     within 1e-4, discrete outputs equal, obs mean |diff| <= 0.01;
  8. the step path at full width: make_vec(<map>, 4096, renderer="pallas")
     (64x64 RGB, auto-reset, marking AA) on loop_obstacles and on bigtown,
     256 steps timed with CUDA events after a warm-up; row_render_static
     must launch on the first, row_render on the second; uint8
     [4096, 64, 64, 3] frames with std > 5 and finite rewards; the split
     between physics and render, and a torch.profiler trace of 32 steps
     (kernel device time per launch, idle share);
  9. K3 and K4 vs their plain versions on that run's 4096-env states, at
     the blob render's bars;
 10. the plain versions' times, and the least time the card could take
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
# row_render.cu (K3 and K4 share the pixel pass and the primitive test)
K34_OPS_PIXEL = 175       # NDC ramps, ray normalize, ground, tile, sky, output
K34_OPS_SLOT = 2          # cull flag test of one object slot
K34_OPS_OBJECT = 35       # model-space ray and slab reciprocals of an object
K34_OPS_BOX = 85          # one box: slabs, hit, normal, Lambert, fold
K34_OPS_SPHERE = 66       # one sphere: quadratic, hit, normal, Lambert, fold


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


def profile_window(window, kernels):
    """torch.profiler over one call of window(). Returns (device ms per
    launch of each named kernel found, device ms of all kernels, window
    ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        window()
        end.record()
        torch.cuda.synchronize()
    per, busy = {}, 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host events; kernels are the device-side entries
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
        busy += t
        for k in kernels:
            if k in ev.key and ev.count:
                per[k] = t / ev.count
    return per, busy, start.elapsed_time(end)


def k34_ops(rows, pk, P):
    """Operations the row-fed render needs on these rows: per pixel the
    ground pass; per env the objects its cull flags keep and their real
    primitives. K4's rows pad every object to P_MAX primitive slots, and
    a padded slot (zero extents) is not counted; the kernel tests it all
    the same, as the reference does."""
    import torch
    from dtown_torch.render import row_raster as rr

    if pk["static"]:
        flags = rows[2].cpu().double()
        spi = pk["spi"].cpu()
        soi = pk["soi"].cpu()
        per_env = torch.full((flags.shape[0],), float(K34_OPS_PIXEL),
                             dtype=torch.float64)
        for o in range(pk["n_objs"]):
            act = (flags[:, 2 * o] > 0.5).double()
            j0, n_p = int(soi[o, 0]), int(soi[o, 1])
            cost = K34_OPS_OBJECT + sum(
                K34_OPS_BOX if int(spi[j, rr.SPI_BOX]) else K34_OPS_SPHERE
                for j in range(j0, j0 + n_p))
            per_env += K34_OPS_SLOT + act * cost
        return float(per_env.sum()) * P
    obj = rows[2].cpu().double().reshape(rows[2].shape[0], -1, rr.OBJ_F)
    prim = rows[3].cpu().double().reshape(
        obj.shape[0], obj.shape[1], rr.P_MAX, rr.PRIM_F)
    is_box = (prim[..., 0] > 0.5).double()
    real = (prim[..., 4] > 0.0).double()          # nonzero extent
    cost = (K34_OPS_OBJECT
            + (real * (is_box * K34_OPS_BOX
                       + (1 - is_box) * K34_OPS_SPHERE)).sum(-1))
    act = (obj[..., 7] > 0.5).double()
    per_env = K34_OPS_PIXEL + (K34_OPS_SLOT + act * cost).sum(-1)
    return float(per_env.sum()) * P


def bound(nbytes, nops):
    """The least time (ms) for nbytes of traffic and nops instructions,
    and which of the two sets it."""
    tb, to = nbytes / PEAK_BYTES * 1e3, nops / PEAK_INSTR * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def reset_counts():
    """Set every kernel wrapper's launch count to 0."""
    from dtown_torch.ops import state_kernel as sk
    from dtown_torch.render import blob_raster as br
    from dtown_torch.render import row_raster as rr

    for fn in (sk.state_step, br.render_frames_from_blob,
               rr.row_render_static, rr.row_render):
        fn.launches = 0


def read_counts():
    from dtown_torch.ops import state_kernel as sk
    from dtown_torch.render import blob_raster as br
    from dtown_torch.render import row_raster as rr

    return {"state_step": sk.state_step.launches,
            "blob_render": br.render_frames_from_blob.launches,
            "row_render_static": rr.row_render_static.launches,
            "row_render": rr.row_render.launches}


def vec_card_vs_cpu(map_name, dev):
    """The vector env on the card vs on the CPU, 64 envs 32x32, from the
    same CPU-built states, 5 steps without auto-reset."""
    import torch
    import dtown_torch
    from dtown_torch import env as tenv

    cfg = dtown_torch.EnvConfig(camera_width=32, camera_height=32,
                                renderer="pallas", auto_reset=False)
    maps = dtown_torch.load_map(map_name)
    start = tenv.reset(cfg, maps.to("cpu"),
                       torch.Generator().manual_seed(3), 64)
    gen = torch.Generator().manual_seed(4)
    acts = [torch.rand((64, 2), generator=gen) * torch.tensor([1.0, 2.0])
            - torch.tensor([0.0, 1.0]) for _ in range(5)]
    res = {}
    for d in ("cpu", dev):
        _, v_step = tenv.make_vec_env(cfg, maps, 64, device=d)
        s = start.to(d)
        for a in acts:
            s, out = v_step(s, a.to(d))
        res[str(d)] = (s.to("cpu"), {k: v.cpu() for k, v in
                                     vars(out).items()})
    (sg, og), (sc, oc) = res[str(dev)], res["cpu"]
    pose = max(float((sg.pos - sc.pos).abs().max()),
               float((sg.angle - sc.angle).abs().max()),
               float((sg.dyn.pos - sc.dyn.pos).abs().max()))
    rew = float((og["reward"] - oc["reward"]).abs().max())
    same = all(torch.equal(og[k], oc[k])
               for k in ("done", "collision", "in_lane")) and torch.equal(
        sg.step_count, sc.step_count)
    obs = float((og["obs"].int() - oc["obs"].int()).abs().float().mean())
    print(f"vec env card vs cpu, {map_name} (64 envs 32x32, 5 steps): pose "
          f"max |diff| {pose:.3g}, reward {rew:.3g}, discrete equal {same}, "
          f"obs mean |diff| {obs:.3g}")
    if not (pose <= 1e-5 and rew <= 1e-4 and same and obs <= 0.01):
        raise AssertionError(f"card vector env disagrees with the CPU on "
                             f"{map_name}")


def vec_main_path(map_name, dev, smi, n_steps=256):
    """The step path at full width on one map: timed run, output checks,
    physics/render split and a profiler trace. Returns a dict with the
    launches of the timed run, the final states and the trace times."""
    import torch
    import dtown_torch
    from dtown_torch import env as tenv

    B = 4096
    cfg, maps, v_reset, v_step = dtown_torch.make_vec(
        map_name, B, renderer="pallas")
    pk, facts = v_step.pack, tenv.host_facts(cfg, maps)
    states = v_reset(torch.Generator(device=dev).manual_seed(0))
    actions = torch.rand((B, 2), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    actions[:, 1] = actions[:, 1] * 2.0 - 1.0
    for _ in range(8):                                   # warm-up
        states, out = v_step(states, actions)
    torch.cuda.synchronize()
    reset_counts()
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
    print(f"vec step path, {map_name} {B} envs 64x64: {n_steps} steps in "
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
    """K3 or K4 vs its plain version on the main path's 4096-env states;
    returns (max |diff|, plain ms, bound ms, bound_by)."""
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
    del img_k, img_r, diff
    print(f"{name} vs plain: {states.batch_size} envs 64x64, mean |diff| "
          f"{mean:.3g}, share |diff|>2 {frac:.3g}, max {err:.0f}")
    if not (mean <= 0.01 and frac <= 1e-4):
        raise AssertionError(f"{name} kernel outside its bars")
    P = pk["H"] * pk["W"]
    tabs = ("sof", "soi", "spf", "spi") if pk["static"] else ()
    nbytes = (states.batch_size * 3 * P
              + sum(r.numel() * r.element_size() for r in rows)
              + sum(pk[k].numel() * pk[k].element_size() for k in tabs))
    nops = k34_ops(rows, pk, P)
    b_ms, b_by = bound(nbytes, nops)
    print(f"{name}: {run['ms']:.5f} ms/launch (plain {plain_ms:.4f} ms), "
          f"bound {b_ms:.6f} ms by {b_by} ({nbytes} B, {nops:.4g} ops)")
    return err, plain_ms, b_ms, b_by


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
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    blob, rsum, osum = rollout(blob, actions, n_steps)
    end.record()
    torch.cuda.synchronize()
    launches = read_counts()
    ms = start.elapsed_time(end)
    rate = B * n_steps / (ms / 1e3)
    _, out, obs = fused_step(blob, actions)
    torch.cuda.synchronize()
    print(f"fused RGB rollout, loop_obstacles {B} envs 64x64: {n_steps} "
          f"steps in {ms:.2f} ms = {rate:.6g} env-steps/s "
          f"({ms / n_steps:.4f} ms/step) on {smi}")
    print(f"launches in the timed run: {launches}")
    if min(launches["state_step"], launches["blob_render"]) <= 0:
        raise AssertionError("a kernel of the main path never launched")
    if not (obs.shape == (B, 3, 32, 128) and obs.dtype == torch.uint8
            and bool(torch.isfinite(blob).all())
            and bool(torch.isfinite(out.reward).all())
            and float(obs.float().std()) > 5.0):
        raise AssertionError("rollout output malformed")
    print(f"last step: reward sum {float(rsum):.6g}, obs checksum "
          f"{int(osum)}, done {int(out.done.sum())}")

    # ---- device trace of a short window of the main path ----------------------------
    dev_ms, busy_ms, win_ms = profile_window(
        lambda: rollout(blob, actions, 32),
        ["state_step_kernel", "blob_render_kernel"])
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

    k1_bound, k1_by = bound(k1_bytes, k1_ops)
    k2_bound, k2_by = bound(k2_bytes, k2_opc)
    print(f"state kernel: {k1_ms:.5f} ms/launch (plain {k1_plain:.4f} ms), "
          f"bound {k1_bound:.6f} ms by {k1_by} ({k1_bytes} B, "
          f"{k1_ops:.4g} ops)")
    print(f"blob render: {k2_ms:.5f} ms/launch (plain {k2_plain:.4f} ms), "
          f"bound {k2_bound:.6f} ms by {k2_by} ({k2_bytes} B, "
          f"{k2_opc:.4g} ops)")
    del blob, st, pk

    # ---- the step path: vector env on the card vs the CPU ---------------------------
    for name in ("loop_obstacles", "town_dyn_duckiebots"):
        vec_card_vs_cpu(name, dev)

    # ---- the step path at full width: K3 map, then K4 map ----------------------------
    row = {}
    for name, kname in (("loop_obstacles", "row_render_static"),
                        ("bigtown", "row_render")):
        run = vec_main_path(name, dev, smi)
        if run["launches"][kname] <= 0:
            raise AssertionError(f"{kname} never launched on {name}")
        err, plain_ms, b_ms, b_by = row_kernel_check(run, dev)
        row[kname] = dict(launches=run["launches"][kname], max_abs_err=err,
                          ms=run["ms"], plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, map=name)
        del run
        torch.cuda.empty_cache()
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
        dict(name="row_render_static", route="cuda",
             source="dtown_torch/csrc/row_render.cu",
             replaces="dtown/render/pallas_raster.py:861",
             **{k: v for k, v in row["row_render_static"].items()
                if k != "map"}, library_ms=None),
        dict(name="row_render", route="cuda",
             source="dtown_torch/csrc/row_render.cu",
             replaces="dtown/render/pallas_raster.py:326",
             **{k: v for k, v in row["row_render"].items() if k != "map"},
             library_ms=None),
    ]
    print(nvidia_smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
