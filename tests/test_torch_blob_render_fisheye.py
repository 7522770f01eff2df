"""dtown_torch's blob render with fisheye (cfg.distortion) and at a frame
that dtown renders row-tiled, vs the JAX package on the CPU: the fisheye
static ray planes bit for bit; the plain K2 against dtown's interpret-mode
kernel on fisheye RGB and grayscale (loop_obstacles, static rays), on
fisheye with domain randomization (the NDC table path, small_loop) and on
a 256x192 fisheye frame of small_loop (S = 384 > 256: dtown's row-tiled
grid, as tests/test_blob_render.py::test_blob_render_row_tiled); and a
fused rollout with fisheye and domain randomization through an auto-reset
against dtown's make_fused_rollout, blob for blob. Bars as in test_torch_blob_render.py: mean |diff| < 1 and
at most 1% of values off by more than 10 (the TPU kernel's packed u8
ground against the port's float32 ground, and XLA's contracted multiply-
adds). The CUDA kernel is held against the same plain version on the card
by chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dtown import map_loader as jmap_loader
from dtown import types as jtypes
from dtown.ops.fused_env import make_fused_rollout as j_make_fused_rollout
from dtown.render import blob_raster as jbr
from dtown.render import distortion as jdist

from dtown_torch import EnvConfig, load_map, make_fused_rollout
from dtown_torch.convert import blob_from_numpy
from dtown_torch.ops import state_kernel as sk
from dtown_torch.render import blob_raster as br

from test_torch_blob_render_npc import B, posed_blob
from test_torch_state_npc import check_rows

MEAN_BAR, SHARE_BAR = 1.0, 0.01
LIGHT_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(W, H, **kw):
    kw = dict(camera_width=W, camera_height=H, distortion=True, **kw)
    return jtypes.EnvConfig(**kw), EnvConfig(**kw)


def _compare(ours, ref):
    assert ours.shape == ref.shape
    diff = np.abs(ours - ref)
    assert diff.mean() < MEAN_BAR, diff.mean()
    assert (diff > 10).mean() < SHARE_BAR, (diff > 10).mean()
    assert ours.std() > 5


def _render_both(map_name, W, H, targets=True, seed=0, **kw):
    """dtown's interpret-mode K2 and the port's plain K2 on one posed blob
    (half the envs looking at the map's objects)."""
    jcfg, cfg = _cfgs(W, H, **kw)
    jmaps = jmap_loader.load_map(map_name)
    live = np.nonzero(np.asarray(jmaps.obj_mask))[0]
    pts = [tuple(np.asarray(jmaps.obj_pos)[s, [0, 2]]) for s in live]
    blob = posed_blob(jcfg, jmaps, pts if targets else [], seed=seed)
    jplan = jbr.build_render_plan(jcfg, jmaps)
    ref = np.asarray(jax.jit(lambda b: jbr.render_frames_from_blob(
        jcfg, jmaps, b, jplan, interpret=True))(blob)).astype(int)
    plan = br.build_render_plan(cfg, load_map(map_name))
    assert plan == jplan
    pk = br.pack_plan(cfg, plan, "cpu")
    ours = br.render_frames_from_blob(torch.from_numpy(blob), pk)
    ours = ours.numpy().astype(int)
    _compare(ours, ref)
    return ours, pk


@pytest.mark.parametrize("W,H", [(32, 32), (64, 48)])
def test_fisheye_ray_planes_match_reference(W, H):
    plan = br.build_render_plan(EnvConfig(), load_map("loop_obstacles"))
    ref = jbr._static_ray_planes(H, W, plan, True)
    np.testing.assert_array_equal(
        br._static_ray_planes(H, W, plan, True).reshape(5, -1),
        ref[:5].reshape(5, -1))
    gray = br._static_ray_planes(H, W, plan, True, grayscale=True)
    ref_g = jbr._static_ray_planes(H, W, plan, True, grayscale=True)
    np.testing.assert_array_equal(gray[5].reshape(-1), ref_g[5].reshape(-1))
    flat = br._static_ray_planes(H, W, plan, False)
    assert not np.array_equal(flat, gray[:5])


@pytest.mark.parametrize("W,H", [(32, 32), (640, 480)])
def test_dr_ndc_table_matches_reference(W, H):
    """The table the domain-randomized rays read: without fisheye dtown's
    in-kernel ramps ((x + .5) * (1/W) - .5) * 2, (.5 - (y + .5) * (1/H)) * 2
    in float32, bit for bit; with fisheye dtown's undistorted_ndc."""
    p = jnp.arange(H * W, dtype=jnp.int32)
    y = p // W
    x = p - y * W
    xr = ((x.astype(jnp.float32) + 0.5) * (1.0 / W) - 0.5) * 2.0
    yr = (0.5 - (y.astype(jnp.float32) + 0.5) * (1.0 / H)) * 2.0
    table = br._ndc_table(H, W, False)
    assert table.dtype == np.float32 and table.shape == (2, H * W)
    np.testing.assert_array_equal(table[0], np.asarray(xr))
    np.testing.assert_array_equal(table[1], np.asarray(yr))
    fish = br._ndc_table(H, W, True)
    for ours, ref in zip(fish, jdist.undistorted_ndc(W, H)):
        np.testing.assert_array_equal(ours, ref.reshape(-1))


@pytest.mark.parametrize("gray", [False, True])
def test_fisheye_render_matches_pallas_interpret(gray):
    _, pk = _render_both("loop_obstacles", 32, 32, grayscale=gray)
    assert not pk["dr"] and pk["C"] == (1 if gray else 3)


def test_fisheye_domain_rand_render_matches_pallas_interpret():
    _, pk = _render_both("small_loop", 32, 32, targets=False, seed=3,
                            domain_rand=True)
    assert pk["dr"] and tuple(pk["rays"].shape) == (2, 32 * 32)


def test_row_tiled_frame_matches_pallas_interpret():
    """256x192: S = 384 sublane rows, which dtown's kernel splits over a
    second grid axis (and its ray planes with it); the port's one block
    per env and pixel block needs no tiling."""
    S = 256 * 192 // 128
    assert S > 256
    ours, _ = _render_both("small_loop", 256, 192, targets=False, seed=4)
    assert ours.shape == (B, 3, S, 128)


def test_fused_rollout_fisheye_domain_rand_matches_reference():
    """tests/test_fused_matrix.py's distortion_dr case: small_loop, fisheye
    and domain randomization, 3 steps through an auto-reset (max_steps=2)
    that redraws the randomization rows."""
    jcfg, cfg = _cfgs(32, 32, domain_rand=True, max_steps=2)
    map_name = "small_loop"
    jmaps = jmap_loader.load_map(map_name)
    j_init, j_step, _ = j_make_fused_rollout(jcfg, jmaps, B)
    blob_j, states = j_init(jax.random.PRNGKey(8))
    step_j = jax.jit(lambda b, a: j_step(b, states, a))
    _, t_step, _ = make_fused_rollout(cfg, load_map(map_name), B,
                                      device="cpu")
    blob_t = blob_from_numpy(np.asarray(blob_j), device="cpu")
    drb = sk.dr_base(0)
    light = [drb + k for k in (sk.DR_LX, sk.DR_LY, sk.DR_LZ)]
    other_dr = [f for f in range(drb, drb + sk.DR_ROWS) if f not in light]
    rng = np.random.default_rng(5)
    n_done = 0
    for _ in range(3):
        act = np.stack([rng.uniform(0.0, 1.0, B),
                        rng.uniform(-1.0, 1.0, B)], -1).astype(np.float32)
        blob_j, _, obs_j = step_j(blob_j, jnp.asarray(act))
        blob_t, out_t, obs_t = t_step(blob_t, torch.from_numpy(act))
        bj, bt = np.asarray(blob_j), blob_t.numpy()
        check_rows(bj, bt)
        for f in other_dr:
            np.testing.assert_array_equal(bt[f], bj[f], err_msg=str(f))
        np.testing.assert_allclose(bt[light], bj[light], rtol=0,
                                   atol=LIGHT_ATOL)
        _compare(obs_t.numpy().astype(int), np.asarray(obs_j).astype(int))
        n_done += int(bj[sk.F_DONE].sum())
    assert n_done >= B
