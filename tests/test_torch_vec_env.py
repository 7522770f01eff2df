"""dtown_torch's vectorized API (``make_vec`` / ``step_batch``) on the
CPU: the entry point's device rule, frames and state vectors of the
right shape, seeded determinism, fisheye frames, and NotImplementedError
for the options not ported yet. The numbers are held against the JAX package in
test_torch_env_step.py and test_torch_row_render.py."""
import numpy as np
import pytest
import torch

import dtown_torch
from dtown_torch import EnvConfig, load_map
from dtown_torch import env as tenv


def _vec(map_name="loop_obstacles", B=8, **kw):
    kw.setdefault("renderer", "pallas")
    return dtown_torch.make_vec(map_name, B, device="cpu", **kw)


def test_make_vec_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dtown_torch.make_vec("small_loop", 8, renderer="pallas")
    cfg, maps, v_reset, v_step = _vec("small_loop")
    assert maps.tile_kind.device.type == "cpu"
    assert v_reset(torch.Generator()).pos.device.type == "cpu"


def test_step_batch_rgb_on_cpu():
    """Mirrors tests/test_pallas_render.py::test_step_batch_pallas_path."""
    cfg, maps, v_reset, v_step = _vec(camera_width=64, camera_height=64)
    states = v_reset(torch.Generator().manual_seed(0))
    actions = torch.tensor([[0.3, 0.0]]).repeat(8, 1)
    states, out = v_step(states, actions)
    assert out.obs.shape == (8, 64, 64, 3)
    assert out.obs.dtype == torch.uint8
    assert float(out.obs.float().std()) > 5.0
    assert out.reward.shape == (8,) and torch.isfinite(out.reward).all()
    assert out.done.dtype == torch.bool


def test_step_batch_grayscale_is_luma_of_rgb():
    kw = dict(camera_width=32, camera_height=32)
    _, _, reset_c, step_c = _vec(**kw)
    _, _, reset_g, step_g = _vec(grayscale=True, **kw)
    a = torch.tensor([[0.4, 0.3]]).repeat(8, 1)
    _, oc = step_c(reset_c(torch.Generator().manual_seed(2)), a)
    _, og = step_g(reset_g(torch.Generator().manual_seed(2)), a)
    assert og.obs.shape == (8, 32, 32, 1) and og.obs.dtype == torch.uint8
    f = oc.obs.to(torch.float32)
    luma = (0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2])
    assert torch.equal(og.obs[..., 0], luma.to(torch.uint8))


def test_state_obs_vec_env():
    _, _, v_reset, v_step = _vec(obs_type="state")
    states, out = v_step(v_reset(torch.Generator().manual_seed(1)),
                         torch.full((8, 2), 0.5))
    assert out.obs.shape == (8, 11) and out.obs.dtype == torch.float32


def test_make_vec_decides_once_what_v_step_uses():
    """make_vec returns the map copy and render pack that v_step uses, and
    the static branches come from the host map, once."""
    cfg, maps, _, v_step = _vec(camera_width=32, camera_height=32)
    assert maps is v_step.maps and v_step.pack["static"]
    facts = tenv.host_facts(cfg, maps)
    assert facts.has_obj and not facts.has_dyn
    assert facts.n_ok == tenv.bank_accept_count(cfg, maps)
    cfg, maps, _, v_step = _vec("loop_pedestrians", obs_type="state")
    assert v_step.pack is None and tenv.host_facts(cfg, maps).has_dyn
    empty = tenv.host_facts(cfg, load_map("small_loop"))
    assert not (empty.has_obj or empty.has_dyn)


def test_same_seed_same_states():
    """Resets and auto-resets draw only from the batch's generator."""
    _, maps, v_reset, v_step = _vec(obs_type="state", max_steps=2)

    def run(seed):
        s = v_reset(torch.Generator().manual_seed(seed))
        first = s
        for _ in range(3):
            s, out = v_step(s, torch.full((8, 2), 0.4))
        return first, s, out

    a0, a1, oa = run(4)
    b0, b1, ob = run(4)
    c0, _, _ = run(5)
    for x, y in ((a0, b0), (a1, b1)):
        assert torch.equal(x.pos, y.pos) and torch.equal(x.angle, y.angle)
        assert torch.equal(x.dyn.vel, y.dyn.vel)
    assert torch.equal(oa.obs, ob.obs)
    assert not torch.equal(a0.pos, c0.pos)
    # every env timed out at step 2 and was drawn afresh
    assert (a1.step_count <= 1).all() and not torch.equal(a1.pos, c0.pos)


@pytest.mark.parametrize("kw,label", [
    (dict(renderer="xla"), "renderer='pallas'"),
    (dict(spawn_mode="rejection"), "rejection"),
    (dict(start_pose=(1.0, 1.0, 0.0)), "start_pose"),
    (dict(user_tile_start=(1, 1)), "user_tile_start"),
])
def test_unported_options_raise(kw, label):
    """The options that the step path refused until the XLA ray-caster,
    rejection spawning and the start overrides were ported now build and
    step: renderer="xla" renders through the ray-caster (no row-render
    pack), the spawns are valid, the overrides pin the start pose."""
    kw = dict(kw, camera_width=32, camera_height=32)
    _, maps, v_reset, v_step = _vec(**kw)
    states = v_reset(torch.Generator().manual_seed(2))
    _, out = v_step(states, torch.tensor([[0.3, 0.0]]).repeat(8, 1))
    assert out.obs.shape == (8, 32, 32, 3) and out.obs.dtype == torch.uint8
    if label == "renderer='pallas'":
        assert v_step.pack is None
    if label == "start_pose":
        np.testing.assert_allclose(states.pos[:, [0, 2]].numpy(), 1.0)
    if label == "user_tile_start":
        ts = float(maps.numpy().tile_size)
        assert (states.pos[:, 0] // ts == 1).all() and \
            (states.pos[:, 2] // ts == 1).all()
    if label == "rejection":
        assert (states.pos != states.pos[:1]).any()


@pytest.mark.parametrize("map_name,static", [("loop_obstacles", True),
                                             ("bigtown", False)])
def test_fisheye_step_path(map_name, static):
    """distortion=True on the step path: K3 (loop_obstacles) and K4
    (bigtown) render with the fisheye NDC table, frames of the same shape
    that differ from the rectilinear ones; the physics is the same."""
    kw = dict(camera_width=32, camera_height=32)
    outs = []
    for fish in (False, True):
        _, _, v_reset, v_step = _vec(map_name, distortion=fish, **kw)
        assert v_step.pack["static"] == static
        states, out = v_step(v_reset(torch.Generator().manual_seed(5)),
                             torch.tensor([[0.3, 0.1]]).repeat(8, 1))
        assert out.obs.shape == (8, 32, 32, 3) and out.obs.dtype == \
            torch.uint8
        assert float(out.obs.float().std()) > 5.0
        outs.append((states, out))
    (s0, o0), (s1, o1) = outs
    assert torch.equal(s0.pos, s1.pos) and torch.equal(o0.reward, o1.reward)
    assert (o0.obs != o1.obs).float().mean() > 0.1


def test_triangle_fidelity_step_path_uses_boxes():
    """mesh_fidelity is the fused rollout's option: the step path renders
    as with the default (the reference's row-fed path never reads it)."""
    kw = dict(camera_width=32, camera_height=32)
    obs = []
    for fid in ("prims", "triangles"):
        _, _, v_reset, v_step = _vec(mesh_fidelity=fid, **kw)
        _, out = v_step(v_reset(torch.Generator().manual_seed(6)),
                        torch.full((8, 2), 0.3))
        obs.append(out.obs)
    assert torch.equal(obs[0], obs[1])


def test_unported_multimap_raises():
    """A stack on the step path, refused until the ray-caster was ported,
    steps and renders (through the ray-caster, whatever the renderer), and
    render_obs renders RGB frames."""
    _, maps, v_reset, v_step = dtown_torch.make_vec(
        ["small_loop", "udem1"], 8, device="cpu", renderer="pallas",
        camera_width=32, camera_height=32)
    assert maps.is_stack and v_step.pack is None
    states, out = v_step(v_reset(torch.Generator().manual_seed(0)),
                         torch.zeros((8, 2)))
    assert out.obs.shape == (8, 32, 32, 3)
    cfg = EnvConfig(renderer="pallas", camera_width=32, camera_height=32)
    frames = tenv.render_obs(cfg, maps, states)
    assert torch.equal(frames, out.obs)
