"""Host-side spawn-pose bank (numpy, map-compile time).

Counterpart of dtown/spawn_bank.py: the reference's per-reset rejection
sampling runs once here over a large pool of proposals, and the batched
reset then picks an accepted pose. Each entry stores its lane angle, and
entries are sorted by |lane angle| so the accept_start_angle_deg filter is
a prefix of the bank.
"""
import numpy as np

from simbench.reference.frozen import constants as C

BANK_SIZE = 2048
PROPOSALS = 40000


def _bezier_points(cps, t):
    # cps [N, 4, 3], t [N] -> [N, 3]
    t = t[:, None]
    u = 1.0 - t
    return (
        u**3 * cps[:, 0] + 3 * t * u**2 * cps[:, 1]
        + 3 * t**2 * u * cps[:, 2] + t**3 * cps[:, 3]
    )


def _bezier_tangents(cps, t):
    t = t[:, None]
    u = 1.0 - t
    d = (
        3 * u**2 * (cps[:, 1] - cps[:, 0])
        + 6 * u * t * (cps[:, 2] - cps[:, 1])
        + 3 * t**2 * (cps[:, 3] - cps[:, 2])
    )
    return d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)


def _bezier_closest(cps, p, iters=C.BEZIER_CLOSEST_ITERS):
    n = len(p)
    t_bot = np.zeros(n)
    t_top = np.ones(n)
    for _ in range(iters):
        mid = 0.5 * (t_bot + t_top)
        d_bot = np.sum((_bezier_points(cps, t_bot) - p) ** 2, axis=-1)
        d_top = np.sum((_bezier_points(cps, t_top) - p) ** 2, axis=-1)
        keep_bot = d_bot < d_top
        t_top = np.where(keep_bot, mid, t_top)
        t_bot = np.where(keep_bot, t_bot, mid)
    return 0.5 * (t_bot + t_top)


def lane_features_np(tile_size, drivable, curves, curve_mask, pos, angle):
    """Vectorized numpy get_lane_pos2 for a batch of poses (curve select by
    max chord dot with the dot>0 filter, fixed-depth bezier bisection,
    signed distance). Feeds the spawn bank's precomputed lane features.

    Returns (signed_dist [N], dot_dir [N], lane_deg [N], in_lane [N]).
    """
    H, W = drivable.shape
    N = len(angle)
    px, pz = pos[:, 0], pos[:, 2]
    dir_vec = np.stack([np.cos(angle), np.zeros(N), -np.sin(angle)], -1)
    ii = np.floor(px / tile_size).astype(int)
    jj = np.floor(pz / tile_size).astype(int)
    in_grid = (ii >= 0) & (ii < W) & (jj >= 0) & (jj < H)
    ii = np.clip(ii, 0, W - 1)
    jj = np.clip(jj, 0, H - 1)
    tc = curves[jj, ii]        # [N, Cmax, 4, 3]
    tm = curve_mask[jj, ii]    # [N, Cmax]
    chord = tc[:, :, 3] - tc[:, :, 0]
    chord /= np.maximum(np.linalg.norm(chord, axis=-1, keepdims=True), 1e-12)
    dots = np.einsum("ncd,nd->nc", chord, dir_vec)
    dots = np.where(tm, dots, -np.inf)
    best = np.argmax(dots, axis=-1)
    best_dot = dots[np.arange(N), best]
    cps = tc[np.arange(N), best]
    t = _bezier_closest(cps, pos)
    point = _bezier_points(cps, t)
    tangent = _bezier_tangents(cps, t)
    dot_dir = np.clip(np.sum(dir_vec * tangent, -1), -1, 1)
    right_of = np.cross(tangent, np.array([0.0, 1.0, 0.0]))
    signed_dist = np.sum((pos - point) * right_of, axis=-1)
    ang = np.arccos(dot_dir)
    ang = np.where(np.sum(dir_vec * right_of, -1) < 0, -ang, ang)
    in_lane = in_grid & drivable[jj, ii] & (best_dot > 0.0)
    return signed_dist, dot_dir, np.degrees(ang), in_lane


def compute_spawn_bank(tile_size, drivable, curves, curve_mask,
                       obj_corners, obj_norms, obj_pos, obj_safety_rad,
                       obj_mask, seed=0):
    """Returns (pos [K,3], angle [K], lane_deg [K], mask [K])."""
    H, W = drivable.shape
    rng = np.random.default_rng(seed)
    driv_cells = np.argwhere(drivable)  # [D, 2] (j, i)
    if len(driv_cells) == 0:
        z = np.zeros((BANK_SIZE,))
        return (np.zeros((BANK_SIZE, 3)), z, z,
                np.zeros((BANK_SIZE,), dtype=bool))

    N = PROPOSALS
    cells = driv_cells[rng.integers(0, len(driv_cells), N)]
    j, i = cells[:, 0], cells[:, 1]
    uv = rng.random((N, 2))
    px = (i + uv[:, 0]) * tile_size
    pz = (j + uv[:, 1]) * tile_size
    angle = rng.random(N) * 2.0 * np.pi
    pos = np.stack([px, np.zeros(N), pz], axis=-1)

    dir_vec = np.stack([np.cos(angle), np.zeros(N), -np.sin(angle)], -1)
    right_vec = np.stack([np.sin(angle), np.zeros(N), np.cos(angle)], -1)
    center = pos + (C.CAMERA_FORWARD_DIST - 0.5 * C.ROBOT_LENGTH) * dir_vec

    def drivable_at(p):
        ii = np.floor(p[:, 0] / tile_size).astype(int)
        jj = np.floor(p[:, 2] / tile_size).astype(int)
        ok = (ii >= 0) & (ii < W) & (jj >= 0) & (jj < H)
        ii = np.clip(ii, 0, W - 1)
        jj = np.clip(jj, 0, H - 1)
        return ok & drivable[jj, ii]

    sf = 1.3  # the reference validates spawn poses with a 1.3 safety factor
    all_driv = (
        drivable_at(center)
        & drivable_at(center - sf * 0.5 * C.ROBOT_WIDTH * right_vec)
        & drivable_at(center + sf * 0.5 * C.ROBOT_WIDTH * right_vec)
        & drivable_at(center + sf * 0.5 * C.ROBOT_LENGTH * dir_vec)
    )

    # SAT vs active objects
    act = np.asarray(obj_mask)
    collided = np.zeros(N, dtype=bool)
    clear = np.ones(N, dtype=bool)
    if act.any():
        oc = obj_corners[act]          # [M, 4, 2]
        on = obj_norms[act]            # [M, 2, 2]
        op = obj_pos[act]
        orad = obj_safety_rad[act]
        hw, hl = 0.5 * C.ROBOT_WIDTH, 0.5 * C.ROBOT_LENGTH
        f2 = dir_vec[:, [0, 2]]
        r2 = right_vec[:, [0, 2]]
        p2 = center[:, [0, 2]]
        ac = np.stack([
            p2 - hl * f2 + hw * r2, p2 + hl * f2 + hw * r2,
            p2 + hl * f2 - hw * r2, p2 - hl * f2 - hw * r2,
        ], axis=1)                     # [N, 4, 2]
        e0 = ac[:, 1] - ac[:, 0]
        e1 = ac[:, 2] - ac[:, 1]
        an = np.stack([
            np.stack([-e0[:, 1], e0[:, 0]], -1),
            np.stack([-e1[:, 1], e1[:, 0]], -1),
        ], axis=1)
        an /= np.maximum(np.linalg.norm(an, axis=-1, keepdims=True), 1e-12)
        axes = np.concatenate([
            np.broadcast_to(an[:, None], (N, len(oc), 2, 2)),
            np.broadcast_to(on[None], (N, len(oc), 2, 2)),
        ], axis=2)                     # [N, M, 4, 2]
        pa = np.einsum("nmkd,ncd->nmkc", axes, ac)
        pb = np.einsum("nmkd,mcd->nmkc", axes, oc)
        sep = (pa.max(-1) < pb.min(-1)) | (pb.max(-1) < pa.min(-1))
        collided = (~sep.any(-1)).any(-1)
        d = np.linalg.norm(op[None] - center[:, None], axis=-1)
        clear = ~(d < (C.MIN_SPAWN_OBJ_DIST + orad[None])).any(-1)

    # lane angle on the tile under pos
    ii = np.clip(np.floor(px / tile_size).astype(int), 0, W - 1)
    jj = np.clip(np.floor(pz / tile_size).astype(int), 0, H - 1)
    tc = curves[jj, ii]
    tm = curve_mask[jj, ii]
    chord = tc[:, :, 3] - tc[:, :, 0]
    chord /= np.maximum(np.linalg.norm(chord, axis=-1, keepdims=True), 1e-12)
    dots = np.einsum("ncd,nd->nc", chord, dir_vec)
    dots = np.where(tm, dots, -np.inf)
    best = np.argmax(dots, axis=-1)
    cps = tc[np.arange(N), best]
    t = _bezier_closest(cps, pos)
    tangent = _bezier_tangents(cps, t)
    dot_dir = np.clip(np.sum(dir_vec * tangent, -1), -1, 1)
    right_of = np.cross(tangent, np.array([0.0, 1.0, 0.0]))
    ang = np.arccos(dot_dir)
    ang = np.where(np.sum(dir_vec * right_of, -1) < 0, -ang, ang)
    lane_deg = np.degrees(ang)

    accepted = all_driv & ~collided & clear
    idx = np.where(accepted)[0]
    if len(idx) == 0:
        idx = np.where(all_driv)[0]
    if len(idx) == 0:
        idx = np.arange(N)
    take = idx[rng.integers(0, len(idx), BANK_SIZE)] if len(idx) < BANK_SIZE \
        else idx[:BANK_SIZE]
    take = take[np.argsort(np.abs(lane_deg[take]), kind="stable")]
    return (
        pos[take].astype(np.float64),
        angle[take].astype(np.float64),
        lane_deg[take].astype(np.float64),
        np.ones(BANK_SIZE, dtype=bool),
    )
