"""Stacks of maps on dtown_torch's step path (make_vec with a list of
names) vs the JAX package's ``make_vec_env`` on the same stack,
["small_loop", "loop_empty"] (tests/test_shard.py's), from states carried
across: the physics of every env on its own member (state observations
and RGB frames from the XLA ray-caster) to tests/test_torch_env_step.py's
bars, and auto-resets that keep each env on its member."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from dtown import env as jenv
from dtown import map_loader as jmap_loader
from dtown import types as jtypes

import dtown_torch
from dtown_torch import EnvConfig, stack_maps
from dtown_torch import env as tenv
from dtown_torch.convert import env_states_from_numpy

from test_torch_env_step import SPEED_ATOL, _actions, _check_step
from test_torch_raster import check_frames

STACK = ["small_loop", "loop_empty"]
B, S = 8, 32


def _pair(**kw):
    jcfg, cfg = jtypes.EnvConfig(**kw), EnvConfig(**kw)
    jmaps = jmap_loader.stack_maps(STACK)
    j_reset, j_step = jenv.make_vec_env(jcfg, jmaps, B)
    _, _, _, v_step = dtown_torch.make_vec(STACK, B, device="cpu", **kw)
    return jcfg, cfg, jmaps, j_reset, j_step, v_step


def test_stack_state_step_matches_reference():
    jcfg, cfg, jmaps, j_reset, j_step, v_step = _pair(obs_type="state",
                                                      auto_reset=False)
    sj = j_reset(jax.random.PRNGKey(3))
    st = env_states_from_numpy(sj, device="cpu")
    np.testing.assert_array_equal(st.map_idx.numpy(), np.arange(B) % 2)
    rng = np.random.default_rng(1)
    for _ in range(8):
        act = _actions(rng, B)
        sj, oj = j_step(sj, jnp.asarray(act))
        st, ot = v_step(st, torch.from_numpy(act))
        _check_step(st, ot, sj, oj)
        cols = [c for c in range(11) if c != 4]
        np.testing.assert_allclose(ot.obs.numpy()[:, cols],
                                   np.asarray(oj.obs)[:, cols], atol=1e-5)
        np.testing.assert_allclose(ot.obs.numpy()[:, 4],
                                   np.asarray(oj.obs)[:, 4], atol=SPEED_ATOL)


def test_stack_rgb_step_matches_reference():
    """RGB frames of a stack come from the ray-caster (renderer "xla", and
    "pallas" too, as in the reference)."""
    kw = dict(camera_width=S, camera_height=S, auto_reset=False)
    jcfg, cfg, jmaps, j_reset, j_step, _ = _pair(**kw)
    sj0 = j_reset(jax.random.PRNGKey(5))
    rng = np.random.default_rng(2)
    acts = [_actions(rng, B) for _ in range(3)]
    sj = sj0
    for act in acts:
        sj, oj = j_step(sj, jnp.asarray(act))
    for renderer in ("xla", "pallas"):
        _, _, _, v_step = dtown_torch.make_vec(STACK, B, device="cpu",
                                               renderer=renderer, **kw)
        st = env_states_from_numpy(sj0, device="cpu")
        for act in acts:
            st, ot = v_step(st, torch.from_numpy(act))
        _check_step(st, ot, sj, oj)
        assert ot.obs.shape == (B, S, S, 3)
        # measured on the CPU: max |diff| 2 (a ray one ulp apart)
        assert check_frames(ot.obs.numpy(), oj.obs) <= 2


def test_stack_auto_reset_keeps_each_env_on_its_member():
    cfg = dict(obs_type="state", max_steps=3)
    _, _, v_reset, v_step = dtown_torch.make_vec(STACK, B, device="cpu",
                                                 **cfg)
    st = v_reset(torch.Generator().manual_seed(0))
    for _ in range(3):
        st, out = v_step(st, torch.full((B, 2), 0.2))
    assert out.done.all() and (st.step_count == 0).all()
    np.testing.assert_array_equal(st.map_idx.numpy(), np.arange(B) % 2)
    stack = stack_maps(STACK)
    for b in range(B):
        member = stack.map_at(b % 2)
        n_ok = tenv.bank_accept_count(EnvConfig(**cfg), member)
        bank = np.asarray(member.spawn_pos)[:n_ok]
        assert (np.abs(bank - st.pos.numpy()[b]).max(-1) == 0).any()
