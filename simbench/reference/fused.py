"""The plain reference of the fused rollout, and the control: the same
reference with its state stored in bfloat16, the nearest precision below
the configuration's float32.

Two parts. ``frozen/`` is a copy of the port's plain versions of its two
CUDA kernels and of what feeds them: the state step (K1's oracle) with its
tables, the blob render (K2's oracle) with its render plan, the map
compile and the reset; they are exact to the bit, as the port's kernels
are built to be. ``town.py`` is written from the map YAML's rules alone
and judges the compiled map (tiles, lanes, objects) and every spawn pose
(the reset's and each auto-reset's) of the program; it shares no code
with the port.

The state step and the render are followed step by step from the
program's own state (the blob before a step): a trajectory of thousands of
envs has no other record. The start (the reset blob) is checked alone.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from simbench.reference import town as town_lib
from simbench.reference.frozen import constants as C
from simbench.reference.frozen import env
from simbench.reference.frozen import map_loader
from simbench.reference.frozen import types as T
from simbench.reference.frozen.ops import state_kernel as sk
from simbench.reference.frozen.render import blob_raster as br
from simbench.reference.frozen.types import EnvConfig

# pixels the plain render holds at once; more go in slices of envs
RENDER_PIXELS = 1 << 25


@dataclass
class Reference:
    cfg: EnvConfig
    maps: object      # the compiled map on the device
    st: dict          # the state kernel's tables
    pk: dict          # the packed render plan (None for state obs)
    num_envs: int
    host: object      # the compiled map's numpy arrays


def build(config, device) -> Reference:
    """The reference of a configuration file's dict on ``device``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = EnvConfig(**config["env"])
    maps = map_loader.load_map(config["map"])
    st = sk.device_tables(cfg, sk.build_tables(cfg, maps), device)
    pk = None
    if cfg.obs_type == "rgb":
        plan = br.build_render_plan(cfg, maps)
        if plan is None:
            raise ValueError(f"{config['map']}: no blob render plan")
        pk = br.pack_plan(cfg, plan, device)
    return Reference(cfg, maps.to(device), st, pk, int(config["num_envs"]),
                     maps.numpy())


def _opt_bits(maps):
    """The optional objects in DR_OBJVIS bit order: (member, slot)."""
    host = maps.numpy()

    def slots(h):
        optional = np.asarray(h.obj_optional)
        return [int(s) for s in np.nonzero(np.asarray(h.obj_mask))[0]
                if bool(optional[int(s)])]

    if host.is_stack:
        return [(m, s) for m in range(host.n_maps)
                for s in slots(host.map_at(m))]
    return [(None, s) for s in slots(host)]


def pack_blob(states, maps, domain_rand, rng):
    """Batched EnvState -> blob f32 [nf, B]: pose rows, hash counters,
    moving NPCs' rows and, with domain_rand, the randomization rows."""
    B = states.pos.shape[0]
    dev = states.pos.device
    f32 = torch.float32
    npcs = sk.moving_npcs(maps.numpy())
    rows = torch.zeros((sk.nf_for(len(npcs), domain_rand), B), dtype=f32,
                       device=dev)
    rows[sk.F_POS_X] = states.pos[:, 0]
    rows[sk.F_POS_Y] = states.pos[:, 1]
    rows[sk.F_POS_Z] = states.pos[:, 2]
    rows[sk.F_ANGLE] = states.angle
    rows[sk.F_SPEED] = states.speed
    rows[sk.F_WVL] = states.wheel_vels[:, 0]
    rows[sk.F_WVR] = states.wheel_vels[:, 1]
    rows[sk.F_STEP] = states.step_count.to(f32)
    rows[sk.F_RNG] = (rng.to(torch.int64) % 65536).to(f32)
    rows[sk.F_ROBOT_SPEED] = states.robot_speed
    rows[sk.F_WHEEL_DIST] = states.wheel_dist
    rows[sk.F_ENVID] = torch.arange(B, dtype=f32, device=dev)
    rows[sk.F_MAPID] = states.map_idx.to(f32)
    for i, npc in enumerate(npcs):
        base = sk.F_NPC_BASE + sk.NPC_ROWS * i
        s = npc["slot"]
        vals = (states.dyn.pos[:, s, 0], states.dyn.pos[:, s, 2],
                states.dyn.angle[:, s], states.dyn.walk_dist[:, s],
                states.dyn.vel[:, s])
        if npc["map"] is not None:
            on = states.map_idx == npc["map"]
            v0 = (C.DUCKIE_WALK_SPEED if npc["kind"] == "duckie"
                  else C.DUCKIEBOT_VEL)
            park = (npc["x0"], npc["z0"], npc["a0"], 0.0, float(v0))
            vals = [torch.where(on, v, d) for v, d in zip(vals, park)]
        rows[base:base + sk.NPC_ROWS] = torch.stack(list(vals))
    if domain_rand:
        drb = sk.dr_base(len(npcs))
        vis = torch.zeros((B,), dtype=f32, device=dev)
        for k, (_, s) in enumerate(_opt_bits(maps)):
            vis = vis + torch.where(states.obj_visible[:, s],
                                    float(1 << k), 0.0)
        rows[drb:drb + sk.DR_ROWS] = torch.stack([
            states.cam_fov_y, states.cam_height, states.cam_angle,
            states.cam_fwd_dist, states.light_dir[:, 0],
            states.light_dir[:, 1], states.light_dir[:, 2],
            states.light_ambient, states.ground_color[:, 0],
            states.ground_color[:, 1], states.ground_color[:, 2],
            states.horizon_color[:, 0], states.horizon_color[:, 1],
            states.horizon_color[:, 2], states.tex_seed.to(f32), vis])
    return rows


def init_blob(ref: Reference, generator: torch.Generator):
    """The reset blob drawn from ``generator``: env.reset's draws, then the
    per-env hash counters, in the order the fused rollout's contract
    states."""
    states = env.reset(ref.cfg, ref.maps, generator, ref.num_envs)
    rng = torch.randint(0, 65536, (ref.num_envs,), generator=generator,
                        device=ref.maps.obj_pos.device)
    return pack_blob(states, ref.maps, ref.cfg.domain_rand, rng)


def step(ref: Reference, blob, actions):
    """One state step: blob f32 [nf, B], actions f32 [B, 2]."""
    return sk.state_step_reference(blob, actions[:, 0].contiguous(),
                                   actions[:, 1].contiguous(), ref.st)


def render(ref: Reference, blob):
    """Frames uint8 [B, C, S, 128] of the blob, in slices of envs."""
    B, P = blob.shape[1], ref.pk["H"] * ref.pk["W"]
    n = max(8, RENDER_PIXELS // P // 8 * 8)
    return torch.cat([br.render_frames_reference(
        blob[:, i:i + n].contiguous(), ref.pk) for i in range(0, B, n)])


MAP_FIELDS = ("drivable", "curves", "curve_mask", "obj_pos", "obj_y_rot",
              "obj_mask", "obj_optional", "obj_is_dynamic", "tile_size")


def map_arrays(host, kind_ids, bf16=False):
    """(the fields town.map_gap reads, the objects' kind names) of a
    compiled map's numpy arrays ``host``; ``kind_ids`` is its vocabulary
    {name: id}. ``bf16`` rounds its floats through bfloat16 (the
    control)."""
    names = {v: k for k, v in kind_ids.items()}
    m = {f: np.asarray(getattr(host, f)) for f in MAP_FIELDS}
    if bf16:
        m = {f: (_bf16(torch.from_numpy(v)).numpy()
                 if v.dtype == np.float32 else v) for f, v in m.items()}
    return m, [names[int(k)] for k in np.asarray(host.obj_kind)]


def town_readings(config, host, kind_ids, blobs, accept_deg, bf16=False):
    """The start's numbers against the town (town.py): ``map_gap`` of the
    compiled map, and ``spawn_off_road``, the invalid spawns among the
    bank's accepted entries, the reset's poses (blobs[0]) and the poses
    that each later blob in ``blobs`` reset."""
    town = town_lib.Town(config["map"])
    m, kinds = map_arrays(host, kind_ids, bf16)
    deg = np.asarray(host.spawn_lane_deg)
    ok = np.asarray(host.spawn_mask) & (np.abs(deg) < accept_deg)
    pos, ang = np.asarray(host.spawn_pos)[ok], np.asarray(host.spawn_angle)[ok]
    if bf16:
        pos, ang = (_bf16(torch.from_numpy(v)).numpy() for v in (pos, ang))
    off = town_lib.off_road(town, pos[:, 0], pos[:, 2], ang)
    for k, b in enumerate(blobs):
        b = b.detach().cpu()
        new = torch.ones_like(b[0], dtype=torch.bool) if k == 0 else \
            b[sk.F_DONE] > 0.5
        off += town_lib.off_road(town, *(b[f][new].double().numpy() for f in
                                         (sk.F_POS_X, sk.F_POS_Z,
                                          sk.F_ANGLE)))
    return dict(map_gap=town_lib.map_gap(town, kinds, m),
                spawn_off_road=off)


def control_town_readings(ref, config, blobs):
    """The control's start numbers: the reference's own map and spawn bank
    in bfloat16 in the program's place, and its bfloat16 blobs."""
    return town_readings(config, ref.host, T.OBJ_KIND_IDS, blobs,
                         ref.cfg.accept_start_angle_deg, bf16=True)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def control_step(ref: Reference, blob, actions):
    """The control's state step: the state read from and written to a
    bfloat16 blob."""
    return _bf16(step(ref, _bf16(blob), actions))


def control_render(ref: Reference, blob):
    """The control's frames: rendered from the bfloat16 blob."""
    return render(ref, _bf16(blob))


def max_abs(a, b):
    """max |a - b| over all elements; a NaN on one side only reads inf."""
    a, b = a.double(), b.double()
    d = (a - b).abs()
    na, nb = torch.isnan(a), torch.isnan(b)
    d = torch.where(na & nb, 0.0, torch.where(na | nb, float("inf"), d))
    return float(d.max()) if d.numel() else 0.0
