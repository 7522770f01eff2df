"""dtown_torch blob render (plain torch version on the CPU) with moving
NPCs and with one luma plane, vs the JAX package's Pallas blob render
kernel in interpret mode: town_dyn_duckiebots (duckiebots and wiggling
duckies posed from the blob's NPC rows) and small_loop in grayscale
(static rays, the baked sky luma). The CUDA kernel is held against the
same plain version on the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax

from dtown import map_loader as jmap_loader
from dtown import types as jtypes
from dtown.ops.fused_env import make_fused_rollout as j_make_fused_rollout
from dtown.render import blob_raster as jbr

from dtown_torch import EnvConfig, load_map
from dtown_torch.ops import state_kernel as sk
from dtown_torch.render import blob_raster as br

B, S = 8, 32
MEAN_BAR, SHARE_BAR = 1.0, 0.01   # test_torch_blob_render.py's bars


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def posed_blob(jcfg, jmaps, targets, seed=0):
    """dtown's initial blob with envs 0..B/2-1 looking at the target
    points (x, z) from 0.25-0.6 m, clear of every object's footprint, and
    the env clocks at different steps (traffic-light phases, duckie
    wiggle)."""
    init_blob, _, _ = j_make_fused_rollout(jcfg, jmaps, B)
    blob, _ = init_blob(jax.random.PRNGKey(seed))
    blob = np.array(blob)
    rng = np.random.default_rng(seed)
    live = np.nonzero(np.asarray(jmaps.obj_mask))[0]
    opos = np.asarray(jmaps.obj_pos)[live][:, [0, 2]]
    clear = np.linalg.norm(np.asarray(jmaps.obj_halfdims)[live], axis=-1) \
        + 0.05
    for b in range(B // 2 if targets else 0):
        tx, tz = targets[b % len(targets)]
        for _ in range(100):
            a = rng.uniform(-np.pi, np.pi)
            d = rng.uniform(0.25, 0.6)
            p = np.array([tx - d * np.cos(a), tz + d * np.sin(a)])
            if (np.hypot(*(opos - p).T) > clear).all():
                blob[sk.F_POS_X, b], blob[sk.F_POS_Z, b] = p
                blob[sk.F_ANGLE, b] = a
                break
    blob[sk.F_STEP] = np.arange(B, dtype=np.float32) * 23.0 + 5.0
    return blob


def render_both(map_name, blob, **kw):
    jcfg = jtypes.EnvConfig(camera_width=S, camera_height=S, **kw)
    cfg = EnvConfig(camera_width=S, camera_height=S, **kw)
    jmaps = jmap_loader.load_map(map_name)
    plan = br.build_render_plan(cfg, load_map(map_name))
    assert plan == jbr.build_render_plan(jcfg, jmaps)
    ref = np.asarray(jax.jit(lambda b: jbr.render_frames_from_blob(
        jcfg, jmaps, b, jbr.build_render_plan(jcfg, jmaps),
        interpret=True))(blob)).astype(int)
    pk = br.pack_plan(cfg, plan, "cpu")
    ours = br.render_frames_from_blob(torch.from_numpy(blob), pk)
    ours = ours.numpy().astype(int)
    assert ours.shape == ref.shape
    diff = np.abs(ours - ref)
    assert diff.mean() < MEAN_BAR, diff.mean()
    assert (diff > 10).mean() < SHARE_BAR
    return ours, pk


def test_npc_render_matches_pallas_interpret():
    map_name = "town_dyn_duckiebots"
    jcfg = jtypes.EnvConfig(camera_width=S, camera_height=S)
    jmaps = jmap_loader.load_map(map_name)
    npcs = sk.moving_npcs(load_map(map_name))
    n_npc = len(npcs)
    blob = posed_blob(jcfg, jmaps, [(d["x0"], d["z0"]) for d in npcs],
                      seed=1)
    # move the NPCs off their initial poses, as after a few steps
    for i in range(n_npc):
        base = sk.F_NPC_BASE + sk.NPC_ROWS * i
        blob[base + 2] += np.float32(0.3)
    ours, pk = render_both(map_name, blob)
    assert ours.shape == (B, 3, S * S // 128, 128) and ours.std() > 5
    assert (pk["oi"][:, br.OI_NPC] >= 0).sum() == n_npc
    # the frames follow the NPC rows: parked far away they vanish
    gone = blob.copy()
    for i in range(n_npc):
        gone[sk.F_NPC_BASE + sk.NPC_ROWS * i] = -50.0
    moved = br.render_frames_from_blob(torch.from_numpy(gone), pk).numpy()
    assert (moved[:B // 2] != ours[:B // 2]).any()


def test_grayscale_render_matches_pallas_interpret():
    """small_loop in grayscale: one luma plane, BASELINE config 2."""
    jcfg = jtypes.EnvConfig(camera_width=S, camera_height=S, grayscale=True)
    blob = posed_blob(jcfg, jmap_loader.load_map("small_loop"), [])
    ours, pk = render_both("small_loop", blob, grayscale=True)
    assert ours.shape == (B, 1, S * S // 128, 128) and pk["C"] == 1
    assert ours.std() > 5


def test_render_plan_and_rays_with_npcs_match_reference():
    for map_name in ("town_dyn_duckiebots", "bigtown_pedestrians"):
        jcfg = jtypes.EnvConfig(camera_width=S, camera_height=S,
                                domain_rand=True)
        cfg = EnvConfig(camera_width=S, camera_height=S, domain_rand=True)
        ref = jbr.build_render_plan(jcfg, jmap_loader.load_map(map_name))
        ours = br.build_render_plan(cfg, load_map(map_name))
        assert ours == ref and ours["n_npc"] > 0 and ours["domain_rand"]
    plan = br.build_render_plan(EnvConfig(), load_map("small_loop"))
    np.testing.assert_array_equal(
        br._static_ray_planes(S, S, plan, grayscale=True),
        jbr._static_ray_planes(S, S, plan, False, grayscale=True))
