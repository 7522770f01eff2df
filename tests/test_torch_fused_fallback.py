"""The fused rollout past the blob render's budget (no render plan) vs
the JAX package's planless render (``render_rgb_from_blob`` with no plan):
one map of 56 objects (chip_smoke.dense_map_data: loop_obstacles plus 50
static cones and duckies, compiled from YAML written to a temp dir),
whose frames come from K4 (the plain row-fed render) on the EnvState that
update_states_from_blob writes into the template, and the stack
udem1 x 4, whose frames come from the XLA ray-caster. The port's rollout
(the plain state kernel, held against dtown's elsewhere) steps through
auto-resets (max_steps=3); after each step dtown renders the same blob
from its own template. Frames at tests/test_torch_row_render.py's bars
(K4) and tests/test_torch_raster.py's (ray-caster); measured max |diff|
1 in both."""
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from dtown import env as jenv
from dtown import map_loader as jmap_loader
from dtown import types as jtypes
from dtown.ops import fused_env as jfe
from dtown.render import blob_raster as jbr

from dtown_torch import EnvConfig, map_loader, stack_maps
from dtown_torch import make_fused_rollout
from dtown_torch.ops import fused_env as tfe
from dtown_torch.render import blob_raster as br

import chip_smoke
from test_torch_raster import check_frames

B, S, N_STEPS = 8, 32, 4
K4_MEAN, K4_SHARE = 0.05, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(jmaps, maps, **kw):
    """(dtown's frames, the port's) of the first observation and of
    N_STEPS fused steps, each pair from the same blob."""
    kw = dict(camera_width=S, camera_height=S, max_steps=3, **kw)
    jcfg, cfg = jtypes.EnvConfig(**kw), EnvConfig(**kw)
    assert jbr.build_render_plan(jcfg, jmaps) is None
    assert br.build_render_plan(cfg, maps) is None
    tmpl = jfe.template_states(jcfg, jmaps, B)
    if maps.is_stack:
        # dtown cannot trace update_states_from_blob on a stack
        # (state_kernel.moving_npcs reads the members as numpy): it runs
        # op by op, the render under jit
        render = jax.jit(jax.vmap(lambda s: jenv.render_obs(jcfg, jmaps, s)))
        j_render = lambda b: render(jfe.update_states_from_blob(
            tmpl, b, jmaps, jcfg.domain_rand))
    else:
        j_render = jax.jit(lambda b: jfe.render_rgb_from_blob(
            jcfg, jmaps, b, tmpl, None))
    init_blob, step, _ = make_fused_rollout(cfg, maps, B, device="cpu")
    assert step.pack["planless"]
    blob = init_blob(torch.Generator().manual_seed(4))
    out = [(j_render(jnp.asarray(blob.numpy())),
            tfe.obs_from_blob(cfg, maps.to("cpu"), blob, step.pack))]
    rng = np.random.default_rng(3)
    done = 0
    for _ in range(N_STEPS):
        act = np.stack([rng.uniform(0.3, 1.0, B), rng.uniform(-1, 1, B)],
                       -1).astype(np.float32)
        blob, o, obs = step(blob, torch.from_numpy(act))
        done += int(o.done.sum())
        out.append((j_render(jnp.asarray(blob.numpy())), obs))
    assert done > 0
    return out


def test_dense_single_map_renders_through_k4(tmp_path):
    path = tmp_path / "dense.yaml"
    path.write_text(yaml.safe_dump(chip_smoke.dense_map_data()))
    data = yaml.safe_load(path.read_text())
    jmaps = jmap_loader.compile_map(data)
    maps = map_loader.compile_map(data)
    assert int(np.asarray(maps.obj_mask).sum()) == 56
    for obs_j, obs_t in _run(jmaps, maps):
        assert obs_t.shape == (B, 3, S * S // 128, 128)
        assert obs_t.dtype == torch.uint8
        d = np.abs(obs_t.numpy().astype(int) - np.asarray(obs_j).astype(int))
        assert d.reshape(B, -1).mean(1).max() <= K4_MEAN
        assert (d > 1).reshape(B, -1).mean(1).max() <= K4_SHARE
        assert d.max() <= 1


def test_stack_past_the_plan_renders_through_the_raster():
    names = ["udem1"] * 4
    jmaps = jmap_loader.stack_maps(names)
    maps = stack_maps(names)
    for obs_j, obs_t in _run(jmaps, maps):
        assert obs_t.shape == (B, S, S, 3) and obs_t.dtype == torch.uint8
        # measured on the CPU: max |diff| 1
        assert check_frames(obs_t.numpy(), obs_j) <= 1
