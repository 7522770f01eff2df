"""dtown_torch's domain randomization vs the JAX package's: the texture
variant hash and the draw's deterministic core on the same uniforms (bit
for bit), the reset's draws, and the vectorized step path under domain
randomization (``make_vec(..., domain_rand=True, renderer="pallas")``,
physics + K4's plain version) against ``dtown.env.step_batch`` from states
carried across."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dtown import env as jenv
from dtown import map_loader as jmap_loader
from dtown import randomization as jrand
from dtown import types as jtypes

import dtown_torch
from dtown_torch import EnvConfig
from dtown_torch import randomization as trand
from dtown_torch.convert import env_states_from_numpy
from dtown_torch.geometry import fma32

# tests/test_torch_env_step.py and test_torch_row_render.py bars
POSE_ATOL, REWARD_ATOL, LANE_ATOL = 1e-5, 1e-4, 1e-5
MEAN_BAR, SHARE_BAR = 0.05, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several test processes side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_variant_hash_matches_reference():
    rng = np.random.default_rng(0)
    tiles = np.arange(4096, dtype=np.int32)
    seeds = rng.integers(0, 1 << 23, 4096).astype(np.int32)
    ref = jrand.variant_hash(jnp.asarray(tiles), jnp.asarray(seeds))
    ours = trand.variant_hash(torch.from_numpy(tiles),
                              torch.from_numpy(seeds))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    grid = trand.tex_variants(torch.from_numpy(seeds[:3]), (7, 9))
    assert grid.shape == (3, 7, 9) and grid.dtype == torch.int32
    np.testing.assert_array_equal(
        grid[1].numpy(), np.asarray(jrand.variant_hash(
            jnp.arange(63, dtype=jnp.int32).reshape(7, 9), seeds[1])))


def _uniforms(key, n_objects):
    """The uniforms and texture seed dtown.randomization.draw takes from
    its key, in its order."""
    ks = jax.random.split(key, 12)
    u = {name: jax.random.uniform(ks[i], shape) for i, (name, shape) in
         enumerate([("robot_speed", ()), ("cam_fov_y", ()),
                    ("cam_height", ()), ("cam_angle", ()),
                    ("cam_fwd_dist", ()), ("wheel_dist", ()),
                    ("light", (3,)), ("light_ambient", ()),
                    ("ground_color", (3,)), ("horizon_color", (3,))])}
    u["obj_visible"] = jax.random.uniform(ks[11], (n_objects,))
    seed = jax.random.randint(ks[10], (), 0, 1 << 23, dtype=jnp.int32)
    return u, seed


def test_draw_core_matches_reference():
    B, M, grid = 32, 7, (7, 9)
    jcfg = jtypes.EnvConfig(domain_rand=True, robot_speed=0.9)
    cfg = EnvConfig(domain_rand=True, robot_speed=0.9)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    ref = jax.jit(jax.vmap(lambda k: jrand.draw(jcfg, k, grid, M)))(keys)
    u, seed = jax.jit(jax.vmap(lambda k: _uniforms(k, M)))(keys)
    assert set(u) == set(trand.UNIFORM_SHAPES)
    ours = trand.draw_from_uniforms(
        cfg, {k: torch.tensor(np.asarray(v)) for k, v in u.items()},
        torch.tensor(np.asarray(seed)), grid)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)


def test_fma32_rounds_once():
    a = torch.tensor([1.0 + 2.0 ** -12], dtype=torch.float32)
    c = torch.tensor([-1.0], dtype=torch.float32)
    # a*a = 1 + 2^-11 + 2^-24: the product alone rounds the last term away
    assert float(a * a + c) == 2.0 ** -11
    assert float(fma32(a, a, c)) == 2.0 ** -11 + 2.0 ** -24


def test_reset_draws_domain_randomization():
    """make_vec's resets under domain randomization: seeded, inside the
    reference's ranges, texture variants hashed from the seeds, and the
    optional objects' visibility drawn per env."""
    _, maps, v_reset, _ = dtown_torch.make_vec(
        "udem1", 64, device="cpu", renderer="pallas", domain_rand=True)
    s = v_reset(torch.Generator().manual_seed(5))
    again = v_reset(torch.Generator().manual_seed(5))
    assert torch.equal(s.cam_fov_y, again.cam_fov_y)
    assert torch.equal(s.pos, again.pos)
    assert (s.cam_fov_y >= 37.0).all() and (s.cam_fov_y <= 47.0).all()
    assert float(s.cam_fov_y.std()) > 1.0
    assert ((s.robot_speed >= 1.08) & (s.robot_speed <= 1.32)).all()
    np.testing.assert_allclose(s.light_dir.norm(dim=-1).numpy(), 1.0,
                               atol=1e-6)
    assert torch.equal(s.tex_variant,
                       trand.tex_variants(s.tex_seed, maps.grid_shape))
    opt = np.nonzero(np.asarray(maps.numpy().obj_optional))[0]
    vis = s.obj_visible[:, opt]
    assert 0 < int(vis.sum()) < vis.numel()


def test_step_path_under_domain_randomization():
    """make_vec(udem1, domain_rand=True, renderer="pallas") vs the JAX
    package's step_batch, 3 steps from the same randomized states without
    auto-reset: the physics reads each env's robot speed and wheel base,
    K4's plain version its camera, light, colours, texture variants and
    optional objects."""
    B, S = 8, 32
    kw = dict(camera_width=S, camera_height=S, renderer="pallas",
              domain_rand=True, auto_reset=False)
    jcfg = jtypes.EnvConfig(**kw)
    jmaps = jmap_loader.load_map("udem1")
    keys = jax.random.split(jax.random.PRNGKey(9), B)
    sj = jax.jit(jax.vmap(lambda k: jenv.reset(jcfg, jmaps, k)))(keys)
    step_j = jax.jit(lambda s, a: jenv.step_batch(jcfg, jmaps, s, a))
    _, _, _, v_step = dtown_torch.make_vec("udem1", B, device="cpu", **kw)
    st = env_states_from_numpy(sj, device="cpu")
    assert float(st.cam_fov_y.std()) > 0.5
    rng = np.random.default_rng(2)
    for _ in range(3):
        act = np.stack([rng.uniform(0.2, 1.0, B), rng.uniform(-1, 1, B)],
                       -1).astype(np.float32)
        sj, oj = step_j(sj, jnp.asarray(act))
        st, ot = v_step(st, torch.from_numpy(act))
        for name in ("done", "collision", "in_lane"):
            np.testing.assert_array_equal(getattr(ot, name).numpy(),
                                          np.asarray(getattr(oj, name)))
        np.testing.assert_allclose(st.pos.numpy(), np.asarray(sj.pos),
                                   rtol=0, atol=POSE_ATOL)
        np.testing.assert_allclose(ot.reward.numpy(), np.asarray(oj.reward),
                                   rtol=0, atol=REWARD_ATOL)
        np.testing.assert_allclose(ot.lane_dist.numpy(),
                                   np.asarray(oj.lane_dist), rtol=0,
                                   atol=LANE_ATOL)
        diff = np.abs(ot.obs.numpy().astype(int)
                      - np.asarray(oj.obs).astype(int))
        assert ot.obs.shape == (B, S, S, 3)
        assert diff.mean() <= MEAN_BAR, diff.mean()
        assert (diff > 2).mean() <= SHARE_BAR
    assert float(ot.obs.float().std()) > 5.0
