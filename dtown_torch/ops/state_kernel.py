"""The fused state step: blob layout, kernel tables, plain version, wrapper.

Counterpart of dtown/ops/state_kernel.py. One step advances every env
through the whole non-render step: wheel model -> differential-drive
integration -> drivability -> SAT collision and safety-circle penalty ->
lane geometry (chord-dot curve select + fixed-depth bezier bisection) ->
reward/done -> post-reset observation lane rows -> auto-reset from the
spawn bank, drawn with an integer hash of the blob's counters.

The env state is a float32 blob ``[NF, B]`` (fields x envs). On a CUDA
tensor ``state_step`` launches the hand-written kernel
(csrc/state_kernel.cu); on a CPU tensor it runs ``state_step_reference``,
the plain torch version with the same float32 operation order.

Moving NPCs (walking duckies, pure-pursuit duckiebots) step inside the
kernel from their blob rows, and collide with their live footprints;
under domain randomization the optional objects follow the env's
visibility bits and every randomization row is redrawn at auto-reset.
On a stack of maps (map_loader.stack_maps) the tables are the members'
tables concatenated and every lookup is offset by the env's map index
(the F_MAPID row): tile words, curve table, spawn bank, and a map gate on
each object column. With the Nav task (``build_goal_table``) the blob
carries a goal tile per env: entering it scores +NAV_GOAL_REWARD and ends
the episode, and the reset draws a fresh goal on the env's own map.
"""
from __future__ import annotations

import numpy as np
import torch

from dtown_torch import _build
from dtown_torch import constants as C
from dtown_torch import types as T
from dtown_torch.geometry import div, fma32, sincos

# ---- blob field indices (f32 [F, B]) ---------------------------------
F_POS_X, F_POS_Y, F_POS_Z, F_ANGLE, F_SPEED = 0, 1, 2, 3, 4
F_WVL, F_WVR, F_STEP, F_RNG, F_ROBOT_SPEED, F_WHEEL_DIST = 5, 6, 7, 8, 9, 10
F_ACT0, F_ACT1 = 11, 12
F_REWARD, F_DONE, F_LDIST, F_LDOT, F_LDEG, F_INLANE, F_COLL, F_TIME = (
    13, 14, 15, 16, 17, 18, 19, 20)
F_ENVID = 21
# observation-side lane rows: the fresh spawn's on a done step
F_OLDIST, F_OLDOT, F_OLDEG, F_OINLANE = 22, 23, 24, 25
F_MAPID = 26
F_NPC_BASE = 27
NPC_ROWS = 5
NF = 32  # no-NPC, no-DR layout

DR_ROWS = 16
(DR_FOV, DR_CAMH, DR_CAMA, DR_CAMF, DR_LX, DR_LY, DR_LZ, DR_AMB,
 DR_GR, DR_GG, DR_GB, DR_HR, DR_HG, DR_HB, DR_TEXSEED, DR_OBJVIS) = range(16)

NAV_ROWS = 2
NAV_GI, NAV_GJ = 0, 1


def dr_base(n_npc: int) -> int:
    return F_NPC_BASE + NPC_ROWS * n_npc


def nav_base(n_npc: int, domain_rand: bool = False) -> int:
    return dr_base(n_npc) + (DR_ROWS if domain_rand else 0)


def nf_for(n_npc: int, domain_rand: bool = False, nav: bool = False) -> int:
    """Blob row count for a map with n_npc moving NPCs."""
    rows = nav_base(n_npc, domain_rand) + (NAV_ROWS if nav else 0)
    return max(NF, -(-rows // 8) * 8)


def moving_npcs(maps):
    """Static descriptors of a map's moving NPCs (walking duckies and
    scripted duckiebots; traffic lights stay static), in slot order. On a
    stack of maps: every member's NPCs, map-major, each descriptor with
    its member index ``map`` (None on a single map)."""
    if maps.is_stack:
        return [dict(npc, map=m) for m in range(maps.n_maps)
                for npc in moving_npcs(maps.map_at(m))]
    mask = (
        np.asarray(maps.obj_mask)
        & np.asarray(maps.obj_is_dynamic)
        & (np.asarray(maps.obj_kind) != T.OBJ_KIND_IDS["trafficlight"])
    )
    kinds = np.asarray(maps.obj_kind)
    pos = np.asarray(maps.obj_pos)
    rot = np.asarray(maps.obj_y_rot)
    hd = np.asarray(maps.obj_halfdims)
    rad = np.asarray(maps.obj_safety_rad)
    wdist = np.asarray(maps.obj_walk_dist)
    duckie_id = T.OBJ_KIND_IDS["duckie"]
    return [
        dict(
            slot=int(s),
            kind="duckie" if int(kinds[s]) == duckie_id else "duckiebot",
            x0=float(pos[s, 0]), z0=float(pos[s, 2]), a0=float(rot[s]),
            hw=float(hd[s, 0]), hl=float(hd[s, 1]), rad=float(rad[s]),
            walk_dist=float(wdist[s]), map=None,
        )
        for s in np.nonzero(mask)[0]
    ]


# curve table rows per tile ([CT_F, T]): 12 curves x 8 packed control-point
# coordinates at c*12 + k, then chord x, chord z and valid flags
N_CURVES = 12
CT_CPS = 0
CT_CHX = 144
CT_CHZ = 156
CT_VALID = 168
CT_F = 184

# object table ([OT_F, M]): corners(8), SAT norms(4), pos x/z, safety
# radius, active, dynamic
OT_CX = list(range(0, 8))
OT_NX = list(range(8, 12))
OT_PX, OT_PZ, OT_RAD, OT_ACT, OT_DYN = 12, 13, 14, 15, 16
OT_F = 24

# spawn bank ([8, BANK_K]): pose + precomputed lane features of the pose
BK_X, BK_Y, BK_Z, BK_ANG = 0, 1, 2, 3
BK_LDIST, BK_LDOT, BK_LDEG, BK_INLANE = 4, 5, 6, 7
BANK_K = 512

# hash-stream salts of the auto-reset spawn pick and the Nav goal redraw
SALT_SPAWN, SALT_GOAL = 0x20000000, 0x40000000


def _acos(x):
    """Polynomial arccos (Abramowitz-Stegun 4.4.45, ~7e-5 rad)."""
    ax = torch.abs(x)
    p = -0.0187293 * ax + 0.0742610
    p = p * ax + -0.2121144
    p = p * ax + 1.5707288
    r = p * torch.sqrt(torch.clamp(1.0 - ax, min=0.0))
    return torch.where(x < 0.0, np.pi - r, r)


def _hash_u32(a, b, salt=0):
    """Multiply-free Jenkins-style hash of two int32 tensors -> int32 in
    [0, 2^31). int32 wraparound and arithmetic >> are part of the
    definition (torch's >> on int32 is arithmetic, like jnp's)."""
    h = (a ^ (b << 13)) + b + salt
    h = h + (h << 10)
    h = h ^ (h >> 6)
    h = h + (h << 3)
    h = h ^ (h >> 11)
    h = h + (h << 15)
    h = h ^ (h >> 7)
    return h & 0x7FFFFFFF


def build_tables(cfg, maps):
    """Static numpy kernel tables of a compiled map or a stack of maps
    (dict). A stack's tables carry a ``multi`` descriptor as well."""
    if maps.is_stack:
        return _build_tables_multi(cfg, maps)
    return _build_tables_single(cfg, maps)


def _build_tables_multi(cfg, maps):
    """The members' tables concatenated: curve tables, exact ``npw``-word
    segments of tile words, object columns (each recording its member in
    ``col_maps``; NPC and optional-bit indices made global, map-major) and
    spawn banks, with each member's accepted-bank count."""
    n_maps = maps.n_maps
    tabs = [_build_tables_single(cfg, maps.map_at(m)) for m in range(n_maps)]
    if len({t["ts_inv"].item() for t in tabs}) != 1:
        raise ValueError("stacked maps must share tile_size")
    t0 = tabs[0]
    Hg, Wg = t0["Hg"], t0["Wg"]
    t_pad = Hg * Wg
    npw = -(-t_pad // 4)

    ct = np.concatenate([t["ct"] for t in tabs], axis=1)
    words = np.concatenate([t["words"][0, :npw] for t in tabs])
    wtot = len(words)
    words_padded = np.zeros((1, max(-(-wtot // 128) * 128, 128)), np.int32)
    words_padded[0, :wtot] = words

    ots, col_maps, opt_cols, npcs_all, moving_cols = [], [], [], [], []
    col0 = 0
    for m, t in enumerate(tabs):
        npc_off = len(npcs_all)
        npcs_all.extend(dict(npc, map=m) for npc in t["npcs"])
        if t["M"]:
            ots.append(t["ot"][:, :t["M"]])
            col_maps.extend([m] * t["M"])
            opt_cols.extend(c + col0 for c in t["opt_cols"])
            moving_cols.extend((c + col0, i + npc_off)
                               for c, i in t["moving_cols"])
            col0 += t["M"]
    M = col0
    if len(opt_cols) > 23:
        # the visibility bitfield is one f32 blob row, exact to 2^24
        raise NotImplementedError(
            f"stack has {len(opt_cols)} optional objects; the fused "
            "domain-rand visibility bitfield supports at most 23")
    ot = (np.concatenate(ots, axis=1) if M
          else np.zeros((OT_F, 1), dtype=np.float32))
    bank = np.concatenate([t["bank"] for t in tabs], axis=1)
    n_ok_list = tuple(t["n_ok"] for t in tabs)
    return dict(
        ct=ct, words=words_padded, ot=ot, bank=bank,
        n_ok=max(n_ok_list), n_words=wtot, M=M, Hg=Hg, Wg=Wg,
        ts_inv=t0["ts_inv"], npcs=tuple(npcs_all),
        moving_cols=tuple(moving_cols), opt_cols=tuple(opt_cols),
        multi=dict(n_maps=n_maps, t_pad=t_pad, npw=npw,
                   n_ok_list=n_ok_list, col_maps=tuple(col_maps)),
    )


def build_goal_table(maps):
    """Drivable-tile table of the Nav task: dict(goal=f32 [8, n_maps *
    goal_k] whose rows 0 and 1 are the (i, j) of each member's drivable
    tiles in row-major order (the rest zero), goal_k (the segment width, a
    multiple of 128), n_driv_list (each member's drivable-tile count)).
    The reset draws a uniform index into the env's member segment."""
    grids = ([np.asarray(maps.drivable[m]) for m in range(maps.n_maps)]
             if maps.is_stack else [np.asarray(maps.drivable)])
    coords = []
    for g in grids:
        j, i = np.nonzero(g)
        coords.append(np.stack([i, j], axis=0).astype(np.float32))
    n_driv_list = tuple(int(c.shape[1]) for c in coords)
    goal_k = max(-(-max(n_driv_list) // 128) * 128, 128)
    table = np.zeros((8, len(coords) * goal_k), dtype=np.float32)
    for m, c in enumerate(coords):
        table[:2, m * goal_k:m * goal_k + c.shape[1]] = c
    return dict(goal=table, goal_k=goal_k, n_driv_list=n_driv_list)


def _build_tables_single(cfg, maps):
    Hg, Wg = maps.grid_shape
    n_tiles = Hg * Wg

    curves = np.asarray(maps.curves, dtype=np.float32).reshape(
        n_tiles, -1, 4, 3)
    cmask = np.asarray(maps.curve_mask).reshape(n_tiles, -1)
    nC = curves.shape[1]
    ct = np.zeros((CT_F, n_tiles), dtype=np.float32)
    for t in range(n_tiles):
        for c in range(min(nC, N_CURVES)):
            cps = curves[t, c]
            for k in range(4):
                ct[CT_CPS + c * 12 + 2 * k, t] = cps[k, 0]
                ct[CT_CPS + c * 12 + 2 * k + 1, t] = cps[k, 2]
            if cmask[t, c]:
                # strict f32 op sequence (mul, mul, add, sqrt, max, div)
                ch = (cps[3] - cps[0]).astype(np.float32)
                n2 = ch[0] * ch[0] + ch[2] * ch[2]
                n = np.maximum(np.sqrt(n2), np.float32(1e-12))
                ct[CT_CHX + c, t] = ch[0] / n
                ct[CT_CHZ + c, t] = ch[2] / n
                ct[CT_VALID + c, t] = 1.0

    # packed tile words: byte = kind | angle << 4, 4 tiles per word
    kind = np.asarray(maps.tile_kind).reshape(-1).astype(np.int64)
    ang = np.asarray(maps.tile_angle).reshape(-1).astype(np.int64)
    byte = (kind & 0xF) | ((ang & 0x3) << 4)
    n_words = -(-n_tiles // 4)
    b = np.zeros(n_words * 4, dtype=np.int64)
    b[:n_tiles] = byte
    b4 = b.reshape(n_words, 4)
    words = (
        b4[:, 0] | (b4[:, 1] << 8) | (b4[:, 2] << 16) | (b4[:, 3] << 24)
    ).astype(np.int32)
    wpad = max(-(-n_words // 128) * 128, 128)
    words_padded = np.zeros((1, wpad), dtype=np.int32)
    words_padded[0, :n_words] = words

    # object table (static poses)
    M = int(np.asarray(maps.obj_mask).sum())
    ot = np.zeros((OT_F, max(M, 1)), dtype=np.float32)
    if M:
        mask = np.asarray(maps.obj_mask)
        oc = np.asarray(maps.obj_corners)[mask]
        on = np.asarray(maps.obj_norms)[mask]
        op = np.asarray(maps.obj_pos)[mask]
        orad = np.asarray(maps.obj_safety_rad)[mask]
        odyn = np.asarray(maps.obj_is_dynamic)[mask]
        for m in range(M):
            for i in range(4):
                ot[OT_CX[2 * i], m] = oc[m, i, 0]
                ot[OT_CX[2 * i + 1], m] = oc[m, i, 1]
            for i in range(2):
                ot[OT_NX[2 * i], m] = on[m, i, 0]
                ot[OT_NX[2 * i + 1], m] = on[m, i, 1]
            ot[OT_PX, m] = op[m, 0]
            ot[OT_PZ, m] = op[m, 2]
            ot[OT_RAD, m] = orad[m]
            ot[OT_ACT, m] = 1.0
            ot[OT_DYN, m] = float(odyn[m])

    # spawn bank, transposed, first BANK_K entries (sorted by |lane deg|)
    sp = np.asarray(maps.spawn_pos)[:BANK_K]
    sa = np.asarray(maps.spawn_angle)[:BANK_K]
    sd = np.asarray(maps.spawn_lane_deg)[:BANK_K]
    bank = np.zeros((8, BANK_K), dtype=np.float32)
    bank[BK_X] = sp[:, 0]
    bank[BK_Y] = sp[:, 1]
    bank[BK_Z] = sp[:, 2]
    bank[BK_ANG] = sa
    # a start-pose override pins every (re)spawn to the configured pose: a
    # bank of BANK_K copies of it (the kernel itself is unchanged)
    if cfg.start_pose is not None:
        x0, z0, a0 = cfg.start_pose
        sp = np.tile([[x0, 0.0, z0]], (BANK_K, 1))
        sa = np.full((BANK_K,), float(a0))
        bank[BK_X], bank[BK_Y], bank[BK_Z] = x0, 0.0, z0
        bank[BK_ANG] = float(a0)
    elif cfg.user_tile_start is not None:
        from dtown_torch.spawn_bank import _bezier_closest, _bezier_tangents

        i0, j0 = cfg.user_tile_start
        ts = float(maps.tile_size)
        cx, cz = (i0 + 0.5) * ts, (j0 + 0.5) * ts
        cps0 = np.asarray(maps.curves, np.float64)[j0, i0, 0][None]
        t0 = _bezier_closest(cps0, np.array([[cx, 0.0, cz]]))
        tan0 = _bezier_tangents(cps0, t0)[0]
        a0 = float(np.arctan2(-tan0[2], tan0[0]))
        sp = np.tile([[cx, 0.0, cz]], (BANK_K, 1))
        sa = np.full((BANK_K,), a0)
        bank[BK_X], bank[BK_Y], bank[BK_Z] = cx, 0.0, cz
        bank[BK_ANG] = a0

    from dtown_torch.spawn_bank import lane_features_np

    ldist, ldot, ldeg, inlane = lane_features_np(
        float(maps.tile_size), np.asarray(maps.drivable),
        np.asarray(maps.curves, dtype=np.float64),
        np.asarray(maps.curve_mask),
        sp.astype(np.float64), sa.astype(np.float64),
    )
    bank[BK_LDIST] = ldist
    bank[BK_LDOT] = ldot
    bank[BK_LDEG] = ldeg
    bank[BK_INLANE] = inlane.astype(np.float32)
    n_ok = int((np.abs(sd) < cfg.accept_start_angle_deg).sum())
    n_ok = max(n_ok, 1)

    npcs = tuple(moving_npcs(maps))
    slot_to_npc = {npc["slot"]: i for i, npc in enumerate(npcs)}
    cols = np.nonzero(np.asarray(maps.obj_mask))[0]
    moving_cols = tuple(
        (int(c), slot_to_npc[int(s)])
        for c, s in enumerate(cols) if int(s) in slot_to_npc
    )
    optional = np.asarray(maps.obj_optional)
    opt_cols = tuple(
        int(c) for c, s in enumerate(cols) if bool(optional[int(s)])
    )

    return dict(
        ct=ct, words=words_padded, ot=ot, bank=bank, n_ok=n_ok,
        n_words=n_words, M=M, Hg=Hg, Wg=Wg,
        ts_inv=np.float32(1.0 / float(maps.tile_size)),
        npcs=npcs, moving_cols=moving_cols, opt_cols=opt_cols,
    )


# ---- kernel scalar parameters ------------------------------------------
# Python-double constant folds of the reference, rounded once to float32
# (what jnp does with a Python float next to an f32 array). The CUDA
# kernel reads them in this order (csrc/state_kernel.cu, P_* indices).
_PARAM_NAMES = (
    "dt", "inv_dt", "k_r_inv", "k_l_inv", "radius", "limit", "max_steps",
    "cam_back", "hw", "hl", "ts_inv", "agent_rad", "nav_coef",
)

# NPC table rows ([NPC_F, n_npc], float32): the static descriptor of each
# moving NPC, in moving_npcs order
NPC_F = 8
(NPC_KIND, NPC_X0, NPC_Z0, NPC_A0, NPC_HW, NPC_HL, NPC_RAD,
 NPC_WALK) = range(NPC_F)
NPC_DUCKIE, NPC_BOT = 0, 1

# The CUDA kernel's launch shape (csrc/state_kernel.cu G, THREADS and the
# shared words): a group of K1_GROUP lanes steps one env and a block holds
# up to K1_THREADS // K1_GROUP envs. Its shared memory holds the scalar
# parameters and the DR ranges (K1_TABLE_WORDS); where they fit, the tile
# words, the object table rows and column map of each object column
# (K1_COLUMN_WORDS) and the NPC table (NPC_F a NPC); and per env its blob
# column (the NPC state included), K1_ENV_WORDS words of scratch and a
# score and a flag per object column.
K1_GROUP = 8
K1_THREADS = 128
K1_ENV_WORDS = 126
K1_TABLE_WORDS = 42
K1_COLUMN_WORDS = 20
K1_SMEM_MAX = 232448     # shared bytes a block can have on sm_90


def launch_shape(nf: int, M: int, n_npc: int, n_words: int):
    """(lanes per env, envs per block, shared bytes a block) of the CUDA
    state kernel on a blob of nf rows, M object columns, n_npc NPCs and
    n_words tile words: the most envs a block holds beside the staged
    tables, or beside the scalar tables alone where the others do not fit
    with one env. Raises where one env does not fit even so (past ~8,000
    NPCs that are each an object column)."""
    per_env = nf + K1_ENV_WORDS + 2 * M
    staged = (K1_TABLE_WORDS + n_words + K1_COLUMN_WORDS * M
              + NPC_F * n_npc)
    for tables in (staged, K1_TABLE_WORDS):
        E = min(K1_THREADS // K1_GROUP,
                (K1_SMEM_MAX // 4 - tables) // per_env)
        if E >= 1:
            return K1_GROUP, E, 4 * (tables + E * per_env)
    raise ValueError(f"the state kernel cannot hold one env of {nf} blob "
                     f"rows and {M} object columns in shared memory "
                     f"({4 * (tables + per_env)} > {K1_SMEM_MAX} bytes)")


# hash-stream salts of the in-kernel draws: _u01(tag) of the DR redraw and
# the four Irwin-Hall uniforms of a duckie's fresh walk speed
SALT_U01, TAG_STEP = 0x10000000, 0x3779B9
SALT_DUCKIE, NPC_STEP = 0x30000000, 0x611C9

# _u01 tags of the DR redraw's uniform rows, in the order of the kernel's
# (lo, span) parameter pairs (csrc/state_kernel.cu D_*): robot speed,
# wheel base, fov, camera height, pitch, forward offset, ambient, ground
# rgb, horizon rgb
DR_TAGS = (1, 2, 3, 4, 5, 6, 9, 10, 11, 12, 13, 14, 15)


def _dr_ranges(cfg):
    """(lo, hi) of each DR_TAGS draw (dtown/randomization.py ranges)."""
    rs0 = float(cfg.robot_speed)
    g0 = [float(x) for x in C.NOMINAL_GROUND_COLOR]
    h0 = [float(x) for x in C.NOMINAL_HORIZON_COLOR]
    return (
        (0.9 * rs0, 1.1 * rs0),
        (0.95 * C.WHEEL_DIST, 1.05 * C.WHEEL_DIST),
        (C.CAMERA_FOV_Y - 5.0, C.CAMERA_FOV_Y + 5.0),
        (0.92 * C.CAMERA_FLOOR_DIST, 1.08 * C.CAMERA_FLOOR_DIST),
        (C.CAMERA_ANGLE - 3.0, C.CAMERA_ANGLE + 3.0),
        (0.9 * C.CAMERA_FORWARD_DIST, 1.1 * C.CAMERA_FORWARD_DIST),
        (0.35, 0.7),
    ) + tuple((g - 0.08, g + 0.08) for g in g0) \
        + tuple((h - 0.2, h + 0.2) for h in h0)


def kernel_params(cfg, tables):
    """float32 [len(_PARAM_NAMES)] scalar parameters of one map/config."""
    dt = float(cfg.delta_time)
    vals = dict(
        dt=dt,
        inv_dt=1.0 / dt,
        k_r_inv=(float(cfg.gain) + float(cfg.trim)) / float(cfg.k),
        k_l_inv=(float(cfg.gain) - float(cfg.trim)) / float(cfg.k),
        radius=float(cfg.wheel_radius),
        limit=float(cfg.limit),
        max_steps=float(cfg.max_steps),
        cam_back=C.CAMERA_FORWARD_DIST - 0.5 * C.ROBOT_LENGTH,
        hw=0.5 * C.ROBOT_WIDTH,
        hl=0.5 * C.ROBOT_LENGTH,
        ts_inv=float(tables["ts_inv"]),
        agent_rad=C.AGENT_SAFETY_RAD,
        nav_coef=float(cfg.nav_shaping_coef),
    )
    return np.array([vals[k] for k in _PARAM_NAMES], dtype=np.float32)


def device_tables(cfg, tables, device, nav=None):
    """The kernel's inputs that do not change per step, on ``device``.

    Besides the reference's tables: ``npc`` [NPC_F, n_npc] (the moving
    NPCs' descriptors), ``colmap`` int32 [3, M] (per object column its NPC
    index and, under domain randomization, its optional-object bit, -1 for
    none, and its member map, 0 on a single map), ``drp`` float32 [2 * 13]
    (the DR redraw's lo and span per _u01 tag, Python-double folds rounded
    once), ``n_ok_v`` and ``n_driv`` int32 [n_maps] (each member's
    accepted-bank and drivable-tile counts), ``ct_t`` (the curve table
    transposed, [n_tiles, CT_F], the CUDA kernel's layout) and, with the Nav
    task (``nav`` = build_goal_table(maps)), ``goal`` [8, n_maps * goal_k]."""
    dev = torch.device(device)
    npcs = tuple(tables["npcs"])
    dr = bool(cfg.domain_rand)
    M = int(tables["M"])
    multi = tables.get("multi")
    n_maps = multi["n_maps"] if multi else 1
    npc = np.zeros((NPC_F, max(len(npcs), 1)), np.float32)
    for i, d in enumerate(npcs):
        npc[:, i] = (NPC_DUCKIE if d["kind"] == "duckie" else NPC_BOT,
                     d["x0"], d["z0"], d["a0"], d["hw"], d["hl"], d["rad"],
                     d["walk_dist"])
    colmap = np.full((3, max(M, 1)), -1, np.int32)
    for c, i in tables["moving_cols"]:
        colmap[0, c] = i
    if dr:
        for k, c in enumerate(tables["opt_cols"]):
            colmap[1, c] = k
    colmap[2] = 0
    if multi:
        colmap[2, :M] = multi["col_maps"]
    drp = np.array([v for lo, hi in _dr_ranges(cfg) for v in (lo, hi - lo)],
                   np.float32)
    n_ok_v = multi["n_ok_list"] if multi else (tables["n_ok"],)
    n_driv = nav["n_driv_list"] if nav else (0,) * n_maps
    i32 = lambda v: torch.as_tensor(np.asarray(v, np.int32), device=dev)
    return dict(
        words=torch.as_tensor(tables["words"][0], device=dev),
        ct=torch.as_tensor(tables["ct"], device=dev),
        ct_t=torch.as_tensor(np.ascontiguousarray(tables["ct"].T),
                             device=dev),
        ot=torch.as_tensor(tables["ot"], device=dev),
        bank=torch.as_tensor(tables["bank"], device=dev),
        prm=torch.as_tensor(kernel_params(cfg, tables), device=dev),
        npc=torch.as_tensor(npc, device=dev),
        colmap=torch.as_tensor(colmap, device=dev),
        drp=torch.as_tensor(drp, device=dev),
        n_tiles=int(tables["ct"].shape[1]),   # the curve table's width
        Hg=int(tables["Hg"]), Wg=int(tables["Wg"]), M=M,
        frame_skip=int(cfg.frame_skip),
        use_wm=bool(cfg.use_wheel_model),
        auto_reset=bool(cfg.auto_reset),
        npcs=npcs, n_npc=len(npcs),
        domain_rand=dr,
        n_opt=len(tables["opt_cols"]) if dr else 0,
        n_maps=n_maps,
        t_pad=int(multi["t_pad"] if multi else tables["Hg"] * tables["Wg"]),
        npw=int(multi["npw"] if multi else 0),
        # the tile words the kernel reads (its shared copy)
        n_words=int(tables["n_words"]),
        n_ok_v=i32(n_ok_v), n_driv=i32(n_driv),
        nav=nav is not None,
        goal=(torch.as_tensor(nav["goal"], device=dev) if nav
              else torch.zeros((8, 1), device=dev)),
        goal_k=int(nav["goal_k"]) if nav else 0,
        nf=nf_for(len(npcs), dr, nav is not None),
    )


def _u01(rng_i, env_i, tag):
    """Per-(env, episode, tag) uniform in [0, 1) from the integer hash."""
    hv = _hash_u32(rng_i, env_i, salt=SALT_U01 + tag * TAG_STEP)
    return div((hv & 0xFFFF).to(torch.float32), 65536.0)


_F32 = lambda v: float(np.float32(v))
# the Irwin-Hall speed draw's scale, sqrt(3) * 0.005 folded in float32
IH_SCALE = _F32(np.float32(1.7320508) * np.float32(0.005))


def _drive(x, z, a, s_a, c_a, vl, vr, wheel_dist, dt):
    """One differential-drive substep (simulator.py::_update_pos): pose and
    wheel speeds -> new (x, z, angle). wheel_dist is a tensor."""
    where = torch.where
    dir_x, dir_z = c_a, -s_a
    straight = vl == vr
    npx_s = x + dt * vl * dir_x
    npz_s = z + dt * vl * dir_z
    denom = where(straight, 1.0, vl - vr)
    w = (vr - vl) / wheel_dist
    r_icc = wheel_dist * (vl + vr) / (2.0 * denom)
    rot = w * dt
    cx_ = x + r_icc * s_a
    cz_ = z + r_icc * c_a
    s_r, c_r = sincos(rot)
    dx_ = x - cx_
    dz_ = z - cz_
    npx_a = cx_ + dx_ * c_r + dz_ * s_r
    npz_a = cz_ + dz_ * c_r - dx_ * s_r
    return (where(straight, npx_s, npx_a), where(straight, npz_s, npz_a),
            a + where(straight, 0.0, rot))


def state_step_reference(blob, act0, act1, dev):
    """Plain torch version of the state kernel. blob f32 [NF, B]; act0/act1
    f32 [B]; dev = device_tables(...). Returns the new blob."""
    prm = [float(v) for v in dev["prm"].cpu()]
    (dt, inv_dt, k_r_inv, k_l_inv, radius, limit, max_steps, cam_back,
     hw, hl, ts_inv, agent_rad, nav_coef) = prm
    Hg, Wg = dev["Hg"], dev["Wg"]
    words = dev["words"]
    ct = dev["ct"]
    ot = dev["ot"]
    bank = dev["bank"]
    npcs = dev["npcs"]
    dr = dev["domain_rand"]
    drb = dr_base(len(npcs))
    multi, nav = dev["n_maps"] > 1, dev["nav"]
    navb = nav_base(len(npcs), dr)
    i32 = torch.int32
    where = torch.where

    pos_x, pos_y, pos_z = blob[F_POS_X], blob[F_POS_Y], blob[F_POS_Z]
    angle = blob[F_ANGLE]
    robot_speed = blob[F_ROBOT_SPEED]
    wheel_dist = blob[F_WHEEL_DIST]
    step_cnt = blob[F_STEP]
    rng_ctr = blob[F_RNG]
    env_id = blob[F_ENVID]
    map_row = blob[F_MAPID]
    rng_i, env_i = rng_ctr.to(i32), env_id.to(i32)
    mi = map_row.to(i32)
    if nav:
        goal_i, goal_j = blob[navb + NAV_GI], blob[navb + NAV_GJ]
        pos_x_pre, pos_z_pre = pos_x, pos_z
    if dr:
        dr_rows = [blob[drb + k] for k in range(DR_ROWS)]
        objvis = dr_rows[DR_OBJVIS].to(i32)

    # ---- wheel model -------------------------------------------------
    if dev["use_wm"]:
        # divide by a full tensor, not a Python scalar: torch's CUDA divide
        # by a scalar multiplies by its reciprocal, which rounds differently
        radius_t = torch.full_like(act0, radius)
        omega_r = (act0 + 0.5 * act1 * wheel_dist) / radius_t
        omega_l = (act0 - 0.5 * act1 * wheel_dist) / radius_t
        u_r = torch.clamp(omega_r * k_r_inv, -limit, limit)
        u_l = torch.clamp(omega_l * k_l_inv, -limit, limit)
    else:
        u_l, u_r = act0, act1
    u_l = torch.clamp(u_l, -1.0, 1.0)
    u_r = torch.clamp(u_r, -1.0, 1.0)
    vl = u_l * robot_speed
    vr = u_r * robot_speed

    # ---- differential-drive integration ------------------------------
    speed = torch.zeros_like(angle)
    for _ in range(dev["frame_skip"]):
        s_a, c_a = sincos(angle)
        new_x, new_z, new_angle = _drive(pos_x, pos_z, angle, s_a, c_a, vl,
                                         vr, wheel_dist, dt)
        ddx = new_x - pos_x
        ddz = new_z - pos_z
        speed = torch.sqrt(ddx * ddx + ddz * ddz) * inv_dt
        pos_x, pos_z, angle = new_x, new_z, new_angle

    step_cnt = step_cnt + float(dev["frame_skip"])

    s_a, c_a = sincos(angle)
    dir_x, dir_z = c_a, -s_a
    right_x, right_z = s_a, c_a

    # ---- drivability -------------------------------------------------
    acx = pos_x + cam_back * dir_x
    acz = pos_z + cam_back * dir_z

    def drivable_at(px, pz):
        fi = torch.floor(px * ts_inv)
        fj = torch.floor(pz * ts_inv)
        ing = (fi >= 0) & (fi < Wg) & (fj >= 0) & (fj < Hg)
        ii = torch.clamp(fi.to(i32), 0, Wg - 1)
        jj = torch.clamp(fj.to(i32), 0, Hg - 1)
        tid = jj * Wg + ii
        # the env's word segment of a stack (mi = 0 on one map)
        word = words[(mi * dev["npw"] + (tid >> 2)).long()]
        kind = (word >> ((tid & 3) * 8)) & 0xF
        driv = (kind >= T.TILE_STRAIGHT) & (kind <= T.TILE_4WAY)
        return ing & driv, tid

    d_c, _ = drivable_at(pos_x, pos_z)
    d_c2, _ = drivable_at(acx, acz)
    d_l, _ = drivable_at(acx - hw * right_x, acz - hw * right_z)
    d_r, _ = drivable_at(acx + hw * right_x, acz + hw * right_z)
    d_f, _ = drivable_at(acx + hl * dir_x, acz + hl * dir_z)
    all_driv = d_c2 & d_l & d_r & d_f

    # ---- lane query (the agent's lane position and the duckiebots') --
    def lane_query(qx, qz, qdx, qdz):
        q_driv, tid_q = drivable_at(qx, qz)
        pkg = ct[:, (mi * dev["t_pad"] + tid_q).long()]    # [CT_F, B]
        best_dot = torch.full_like(qx, -1e30)
        cps = [torch.zeros_like(qx) for _ in range(8)]
        for c in range(N_CURVES):
            dot = pkg[CT_CHX + c] * qdx + pkg[CT_CHZ + c] * qdz
            dot = where(pkg[CT_VALID + c] > 0.5, dot, -1e30)
            better = dot > best_dot
            best_dot = where(better, dot, best_dot)
            for k in range(8):
                cps[k] = where(better, pkg[CT_CPS + c * 12 + k], cps[k])
        x0, z0, x1, z1, x2, z2, x3, z3 = cps

        def bz_point(t):
            u = 1.0 - t
            w0 = u * u * u
            w1 = 3.0 * t * u * u
            w2 = 3.0 * t * t * u
            w3 = t * t * t
            return (w0 * x0 + w1 * x1 + w2 * x2 + w3 * x3,
                    w0 * z0 + w1 * z1 + w2 * z2 + w3 * z3)

        t_bot = torch.zeros_like(qx)
        t_top = torch.ones_like(qx)
        for _ in range(C.BEZIER_CLOSEST_ITERS):
            mid = 0.5 * (t_bot + t_top)
            bx, bz_ = bz_point(t_bot)
            tx, tz = bz_point(t_top)
            ebx, ebz = bx - qx, bz_ - qz
            etx, etz = tx - qx, tz - qz
            keep_bot = (ebx * ebx + ebz * ebz) < (etx * etx + etz * etz)
            t_bot, t_top = (where(keep_bot, t_bot, mid),
                            where(keep_bot, mid, t_top))
        t_star = 0.5 * (t_bot + t_top)
        px_c, pz_c = bz_point(t_star)
        u = 1.0 - t_star
        tanx = (3.0 * u * u * (x1 - x0) + 6.0 * u * t_star * (x2 - x1)
                + 3.0 * t_star * t_star * (x3 - x2))
        tanz = (3.0 * u * u * (z1 - z0) + 6.0 * u * t_star * (z2 - z1)
                + 3.0 * t_star * t_star * (z3 - z2))
        tinv = 1.0 / torch.sqrt(
            torch.clamp(tanx * tanx + tanz * tanz, min=1e-24))
        return px_c, pz_c, tanx * tinv, tanz * tinv, best_dot, q_driv

    # ---- moving-NPC state machines (objects.py semantics) -------------
    nrow = lambda i, k: blob[F_NPC_BASE + NPC_ROWS * i + k]
    npc_x = [nrow(i, 0) for i in range(len(npcs))]
    npc_z = [nrow(i, 1) for i in range(len(npcs))]
    npc_a = [nrow(i, 2) for i in range(len(npcs))]
    npc_w = [nrow(i, 3) for i in range(len(npcs))]
    npc_v = [nrow(i, 4) for i in range(len(npcs))]
    bot_wd = torch.full_like(pos_x, C.WHEEL_DIST)
    for _ in range(dev["frame_skip"] if npcs else 0):
        for i, npc in enumerate(npcs):
            nx, nz, na, nw, nv = npc_x[i], npc_z[i], npc_a[i], npc_w[i], \
                npc_v[i]
            s_n, c_n = sincos(na)
            if npc["kind"] == "duckie":
                # walk along the heading, reverse after walk_dist
                step_len = nv * dt
                nx = nx + step_len * c_n
                nz = nz - step_len * s_n
                nw = nw + step_len
                rev = nw > npc["walk_dist"]
                na = where(rev, na + np.pi, na)
                nw = where(rev, 0.0, nw)
            else:
                # scripted duckiebot: pure pursuit on two chained lane
                # queries, then differential drive about WHEEL_DIST
                bdx, bdz = c_n, -s_n
                cpx, cpz, ctx, ctz, bd1, drv1 = lane_query(nx, nz, bdx, bdz)
                fpx = cpx + C.DUCKIEBOT_FOLLOW_DIST * ctx
                fpz = cpz + C.DUCKIEBOT_FOLLOW_DIST * ctz
                gpx, gpz, _, _, bd2, drv2 = lane_query(fpx, fpz, bdx, bdz)
                pvx = gpx - nx
                pvz = gpz - nz
                pinv = 1.0 / torch.sqrt(
                    torch.clamp(pvx * pvx + pvz * pvz, min=1e-18))
                dotr = (s_n * pvx + c_n * pvz) * pinv
                steering = C.DUCKIEBOT_GAIN * (-dotr)
                ok = drv1 & (bd1 > 0.0) & drv2 & (bd2 > 0.0)
                steering = where(ok, steering, 0.0)
                nx, nz, na = _drive(nx, nz, na, s_n, c_n, nv - steering,
                                    nv + steering, bot_wd, dt)
            npc_x[i], npc_z[i], npc_a[i], npc_w[i] = nx, nz, na, nw

    # ---- SAT collision + proximity ------------------------------------
    collided = torch.zeros_like(all_driv)
    prox_static = torch.full_like(pos_x, 1e30)
    prox_dyn = torch.zeros_like(pos_x)
    M = dev["M"]
    if M > 0:
        agc = []
        for sf, sr in ((-hl, hw), (hl, hw), (hl, -hw), (-hl, -hw)):
            agc.append((acx + sf * dir_x + sr * right_x,
                        acz + sf * dir_z + sr * right_z))
        flags = ot[[OT_ACT, OT_DYN]].cpu().numpy() > 0.5
        colmap = dev["colmap"].cpu().numpy()
        for m in range(M):
            i, kbit = int(colmap[0, m]), int(colmap[1, m])
            # a stack's object exists on its own member map only; the
            # NPC rows of an env on another map are junk by design
            on_map = (mi == int(colmap[2, m])) if multi else True
            if i >= 0:
                # live NPC footprint (objects.py::dynamic_corners)
                npc = npcs[i]
                nx, nz = npc_x[i], npc_z[i]
                s_n, c_n = sincos(npc_a[i])
                fx_n, fz_n, rx_n, rz_n = c_n, -s_n, s_n, c_n
                hw_n, hl_n = npc["hw"], npc["hl"]
                ocx = [nx - hl_n * fx_n - hw_n * rx_n,
                       nx + hl_n * fx_n - hw_n * rx_n,
                       nx + hl_n * fx_n + hw_n * rx_n,
                       nx - hl_n * fx_n + hw_n * rx_n]
                ocz = [nz - hl_n * fz_n - hw_n * rz_n,
                       nz + hl_n * fz_n - hw_n * rz_n,
                       nz + hl_n * fz_n + hw_n * rz_n,
                       nz - hl_n * fz_n + hw_n * rz_n]
                obj_axes = [(rx_n, rz_n), (fx_n, fz_n)]
                o_px, o_pz, o_rad = nx, nz, npc["rad"]
                o_act, o_dyn = on_map, True
            else:
                # 0-d float32 tensors: table values enter the math unrounded
                ocx = [ot[OT_CX[2 * k], m] for k in range(4)]
                ocz = [ot[OT_CX[2 * k + 1], m] for k in range(4)]
                obj_axes = [(ot[OT_NX[0], m], ot[OT_NX[1], m]),
                            (ot[OT_NX[2], m], ot[OT_NX[3], m])]
                o_px, o_pz, o_rad = ot[OT_PX, m], ot[OT_PZ, m], \
                    ot[OT_RAD, m]
                o_act, o_dyn = bool(flags[0, m]), bool(flags[1, m])
                if o_act:
                    o_act = on_map
                if kbit >= 0 and o_act is not False:
                    # optional-object visibility bit of this env
                    bit = ((objvis >> kbit) & 1) > 0
                    o_act = bit if o_act is True else o_act & bit
            separated = torch.zeros_like(all_driv)
            for ax, az in [(dir_x, dir_z), (right_x, right_z)] + obj_axes:
                amin = amax = None
                for gx, gz in agc:
                    pa = gx * ax + gz * az
                    amin = pa if amin is None else torch.minimum(amin, pa)
                    amax = pa if amax is None else torch.maximum(amax, pa)
                bmin = bmax = None
                for k in range(4):
                    pb = ocx[k] * ax + ocz[k] * az
                    bmin = pb if bmin is None else torch.minimum(bmin, pb)
                    bmax = pb if bmax is None else torch.maximum(bmax, pb)
                separated = separated | (amax < bmin) | (bmax < amin)
            dxo = o_px - acx
            dzo = o_pz - acz
            dist_o = torch.sqrt(dxo * dxo + dzo * dzo)
            score = dist_o - agent_rad - o_rad
            if isinstance(o_act, torch.Tensor):
                # a static optional object under domain randomization
                collided = collided | (~separated & o_act)
                if o_dyn:
                    prox_dyn = prox_dyn + where(
                        o_act, torch.clamp(score, max=0.0), 0.0)
                else:
                    prox_static = where(
                        o_act, torch.minimum(prox_static, score), prox_static)
            elif o_act:
                collided = collided | ~separated
                if o_dyn:
                    prox_dyn = prox_dyn + torch.clamp(score, max=0.0)
                else:
                    prox_static = torch.minimum(prox_static, score)
    col_penalty = torch.clamp(prox_static, max=0.0) + prox_dyn

    valid = all_driv & ~collided

    # ---- lane position -----------------------------------------------
    px_c, pz_c, tanx, tanz, best_dot, _ = lane_query(
        pos_x, pos_z, dir_x, dir_z)
    dot_dir = torch.clamp(dir_x * tanx + dir_z * tanz, -1.0, 1.0)
    rox = -tanz
    roz = tanx
    signed_dist = (pos_x - px_c) * rox + (pos_z - pz_c) * roz
    ang_rad = _acos(dot_dir)
    ang_rad = where(dir_x * rox + dir_z * roz < 0.0, -ang_rad, ang_rad)
    in_lane = d_c & (best_dot > 0.0)

    # ---- reward / done -----------------------------------------------
    reward_full = (
        C.REWARD_SPEED_COEF * speed * dot_dir
        + C.REWARD_DIST_COEF * torch.abs(signed_dist)
        + C.REWARD_COLLISION_COEF * col_penalty
    )
    reward_alive = where(in_lane, reward_full,
                         C.REWARD_COLLISION_COEF * col_penalty)
    crashed = ~valid
    truncated = step_cnt >= max_steps
    done = crashed | truncated
    reward = where(crashed, C.REWARD_INVALID_POSE, reward_alive)

    if nav:
        # goal check on the post-step tile of a live episode
        # (tasks.nav_step); floor(pos / ts) and the goal rows are small
        # exact integers
        reached = ((torch.floor(pos_x * ts_inv) == goal_i)
                   & (torch.floor(pos_z * ts_inv) == goal_j) & ~done)
        reward = where(reached, reward + C.NAV_GOAL_REWARD, reward)
        if nav_coef:
            # potential-based goal-distance shaping
            ts_k = div(torch.ones_like(pos_x), ts_inv)
            gx = (goal_i + 0.5) * ts_k
            gz = (goal_j + 0.5) * ts_k
            ex, ez = gx - pos_x_pre, gz - pos_z_pre
            d_prev = torch.sqrt(ex * ex + ez * ez)
            ex, ez = gx - pos_x, gz - pos_z
            d_next = torch.sqrt(ex * ex + ez * ez)
            reward = reward + nav_coef * (d_prev - d_next)
        done = done | reached

    # ---- auto-reset from the spawn bank -------------------------------
    lane_deg = ang_rad * (180.0 / np.pi)
    in_lane_f = in_lane.to(torch.float32)
    o_ldist, o_ldot, o_ldeg, o_inlane = signed_dist, dot_dir, lane_deg, \
        in_lane_f
    if dev["auto_reset"]:
        h = _hash_u32(rng_i, env_i, salt=SALT_SPAWN)
        # within the env's member segment of the bank (mi = 0 on one map)
        n_ok_e = torch.clamp(dev["n_ok_v"][mi.long()], min=1)
        sp = bank[:, (mi * BANK_K + h % n_ok_e).long()]  # [8, B]
        pos_x = where(done, sp[BK_X], pos_x)
        pos_y = where(done, sp[BK_Y], pos_y)
        pos_z = where(done, sp[BK_Z], pos_z)
        angle = where(done, sp[BK_ANG], angle)
        speed = where(done, 0.0, speed)
        vl = where(done, 0.0, vl)
        vr = where(done, 0.0, vr)
        step_cnt = where(done, 0.0, step_cnt)
        o_ldist = where(done, sp[BK_LDIST], o_ldist)
        o_ldot = where(done, sp[BK_LDOT], o_ldot)
        o_ldeg = where(done, sp[BK_LDEG], o_ldeg)
        o_inlane = where(done, sp[BK_INLANE], o_inlane)
        if nav:
            # a fresh goal: a uniform drivable tile of the env's map
            hg = _hash_u32(rng_i, env_i, salt=SALT_GOAL)
            n_d = torch.clamp(dev["n_driv"][mi.long()], min=1)
            gidx = mi * dev["goal_k"] + hg % n_d
            gp = dev["goal"][:, gidx.long()]
            goal_i = where(done, gp[0], goal_i)
            goal_j = where(done, gp[1], goal_j)
        # NPCs re-place at their initial poses; a duckie's walk speed is
        # redrawn ~N(0.02, 0.005) (Irwin-Hall sum of 4 hashed uniforms)
        for i, npc in enumerate(npcs):
            npc_x[i] = where(done, npc["x0"], npc_x[i])
            npc_z[i] = where(done, npc["z0"], npc_z[i])
            npc_a[i] = where(done, npc["a0"], npc_a[i])
            npc_w[i] = where(done, 0.0, npc_w[i])
            if npc["kind"] == "duckie":
                usum = torch.zeros_like(pos_x)
                for j in range(4):
                    hv = _hash_u32(rng_i, env_i, salt=SALT_DUCKIE
                                   + j * TAG_STEP + i * NPC_STEP)
                    usum = usum + div((hv & 0xFFFF).to(torch.float32),
                                      65536.0)
                # 0.02 + 0.005 * ((usum - 2) * 1.7320508) with the two
                # constants folded into one, then an FMA: the reference as
                # XLA compiles it
                fresh = torch.clamp(fma32(usum - 2.0, IH_SCALE,
                                          _F32(C.DUCKIE_WALK_SPEED)),
                                    min=0.001)
                npc_v[i] = where(done, fresh, npc_v[i])
        if dr:
            # redraw every randomization row of a fresh episode
            drp = [float(v) for v in dev["drp"].cpu()]
            span = {tag: (drp[2 * k], drp[2 * k + 1])
                    for k, tag in enumerate(DR_TAGS)}

            def rdw(cur, tag):
                lo, sp_ = span[tag]
                return where(done, fma32(_u01(rng_i, env_i, tag), sp_, lo),
                             cur)

            robot_speed = rdw(robot_speed, 1)
            wheel_dist = rdw(wheel_dist, 2)
            for row_, tag in ((DR_FOV, 3), (DR_CAMH, 4), (DR_CAMA, 5),
                              (DR_CAMF, 6), (DR_AMB, 9)):
                dr_rows[row_] = rdw(dr_rows[row_], tag)
            lx_n = fma32(_u01(rng_i, env_i, 7), _F32(0.8), -1.0)
            lz_n = fma32(_u01(rng_i, env_i, 8), _F32(0.8), -1.0)
            linv = 1.0 / torch.sqrt(lx_n * lx_n + 1.0 + lz_n * lz_n)
            dr_rows[DR_LX] = where(done, lx_n * linv, dr_rows[DR_LX])
            dr_rows[DR_LY] = where(done, -linv, dr_rows[DR_LY])
            dr_rows[DR_LZ] = where(done, lz_n * linv, dr_rows[DR_LZ])
            for c, row_ in enumerate((DR_GR, DR_GG, DR_GB)):
                dr_rows[row_] = torch.clamp(rdw(dr_rows[row_], 10 + c),
                                            0.0, 1.0)
            for c, row_ in enumerate((DR_HR, DR_HG, DR_HB)):
                dr_rows[row_] = torch.clamp(rdw(dr_rows[row_], 13 + c),
                                            0.0, 1.0)
            seed = torch.floor(_u01(rng_i, env_i, 16) * float(1 << 23))
            dr_rows[DR_TEXSEED] = where(done, seed, dr_rows[DR_TEXSEED])
            vis = torch.zeros_like(pos_x)
            for kbit in range(dev["n_opt"]):
                vis = vis + where(_u01(rng_i, env_i, 17 + kbit) < 0.5,
                                  float(1 << kbit), 0.0)
            dr_rows[DR_OBJVIS] = where(done, vis, dr_rows[DR_OBJVIS])
    rng_ctr = rng_ctr + 1.0

    rows = [
        pos_x, pos_y, pos_z, angle, speed, vl, vr, step_cnt, rng_ctr,
        robot_speed, wheel_dist, act0, act1,
        reward, done.to(torch.float32), signed_dist, dot_dir,
        lane_deg, in_lane_f,
        collided.to(torch.float32), step_cnt * dt, env_id,
        o_ldist, o_ldot, o_ldeg, o_inlane, map_row,
    ]
    for i in range(len(npcs)):
        rows += [npc_x[i], npc_z[i], npc_a[i], npc_w[i], npc_v[i]]
    if dr:
        rows += dr_rows
    if nav:
        rows += [goal_i, goal_j]
    out = torch.zeros_like(blob)
    out[:len(rows)] = torch.stack(rows)
    return out


_state_step = _build.kernel("state_kernel", "dtown_state_step",
                           "P" * 14 + "i" * 20, "state_step")


def state_step(blob, actions, dev):
    """One fused state step. blob f32 [nf, B] (nf = dev["nf"]); actions
    f32 [B, 2]; dev = device_tables(...) on the blob's device. Returns the
    new blob.

    A CUDA blob goes through the hand-written kernel (csrc/state_kernel.cu)
    and a CPU blob through ``state_step_reference``."""
    nf = dev["nf"]
    if blob.dtype != torch.float32 or blob.dim() != 2 or blob.shape[0] != nf:
        raise ValueError(f"blob must be float32 [{nf}, B], got "
                         f"{tuple(blob.shape)} {blob.dtype}")
    B = blob.shape[1]
    if actions.shape != (B, 2) or actions.dtype != torch.float32:
        raise ValueError(f"actions must be float32 [{B}, 2], got "
                         f"{tuple(actions.shape)} {actions.dtype}")
    if actions.device != blob.device or dev["ct"].device != blob.device:
        raise ValueError("blob, actions and tables must share one device")
    if blob.device.type == "cpu":
        return state_step_reference(blob, actions[:, 0], actions[:, 1], dev)
    if blob.device.type != "cuda":
        raise ValueError(f"unsupported device {blob.device}")
    G, E, smem = launch_shape(nf, dev["M"], dev["n_npc"], dev["n_words"])
    blob = blob.contiguous()
    actions = actions.contiguous()
    out = torch.empty_like(blob)
    _state_step(blob.data_ptr(), actions.data_ptr(), out.data_ptr(),
                dev["words"].data_ptr(), dev["ct_t"].data_ptr(),
                dev["ot"].data_ptr(), dev["bank"].data_ptr(),
                dev["prm"].data_ptr(), dev["npc"].data_ptr(),
                dev["colmap"].data_ptr(), dev["drp"].data_ptr(),
                dev["n_ok_v"].data_ptr(), dev["n_driv"].data_ptr(),
                dev["goal"].data_ptr(),
                B, nf, dev["n_tiles"], dev["Hg"], dev["Wg"],
                dev["M"], dev["frame_skip"],
                int(dev["use_wm"]), int(dev["auto_reset"]), dev["n_npc"],
                int(dev["domain_rand"]), dev["n_opt"], dev["n_maps"],
                dev["t_pad"], dev["npw"], int(dev["nav"]), dev["goal_k"],
                G, E, smem, blob.device)
    return out
