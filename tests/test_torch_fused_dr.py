"""The slice as a whole: dtown_torch's fused rollout on the CPU (the plain
versions of the state step and the blob render) against the JAX package's
``make_fused_rollout`` on town_dyn_duckiebots with domain randomization,
from one initial blob, through auto-resets (max_steps=2) that re-place
the NPCs and redraw the randomization rows: the blob after every step and
the frames."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from dtown import map_loader as jmap_loader
from dtown import types as jtypes
from dtown.ops.fused_env import make_fused_rollout as j_make_fused_rollout

from dtown_torch import EnvConfig, load_map, make_fused_rollout
from dtown_torch.convert import blob_from_numpy
from dtown_torch.ops import state_kernel as sk

from test_torch_state_npc import NPC_ATOL, check_rows

B, S, N_STEPS = 8, 32, 4
LIGHT_ATOL = 1e-6
MEAN_BAR, SHARE_BAR = 1.0, 0.01   # test_torch_blob_render.py's bars


def test_fused_rollout_npc_domain_rand_matches_reference():
    kw = dict(camera_width=S, camera_height=S, domain_rand=True,
              max_steps=2)
    jcfg, cfg = jtypes.EnvConfig(**kw), EnvConfig(**kw)
    map_name = "town_dyn_duckiebots"
    jmaps = jmap_loader.load_map(map_name)
    j_init, j_step, _ = j_make_fused_rollout(jcfg, jmaps, B)
    blob_j, states = j_init(jax.random.PRNGKey(6))
    step_j = jax.jit(lambda b, a: j_step(b, states, a))
    _, t_step, _ = make_fused_rollout(cfg, load_map(map_name), B,
                                      device="cpu")
    blob_t = blob_from_numpy(np.asarray(blob_j), device="cpu")
    n_npc = len(sk.moving_npcs(load_map(map_name)))
    drb = sk.dr_base(n_npc)
    light = [drb + k for k in (sk.DR_LX, sk.DR_LY, sk.DR_LZ)]
    other_dr = [f for f in range(drb, drb + sk.DR_ROWS) if f not in light]
    rng = np.random.default_rng(3)
    n_done = 0
    for _ in range(N_STEPS):
        act = np.stack([rng.uniform(0.0, 1.0, B),
                        rng.uniform(-1.0, 1.0, B)], -1).astype(np.float32)
        blob_j, _, obs_j = step_j(blob_j, jnp.asarray(act))
        blob_t, out_t, obs_t = t_step(blob_t, torch.from_numpy(act))
        bj, bt = np.asarray(blob_j), blob_t.numpy()
        check_rows(bj, bt)
        np.testing.assert_allclose(bt[sk.F_NPC_BASE:drb],
                                   bj[sk.F_NPC_BASE:drb], rtol=0,
                                   atol=NPC_ATOL)
        for f in other_dr:
            np.testing.assert_array_equal(bt[f], bj[f], err_msg=str(f))
        np.testing.assert_allclose(bt[light], bj[light], rtol=0,
                                   atol=LIGHT_ATOL)
        ours, ref = obs_t.numpy().astype(int), np.asarray(obs_j).astype(int)
        assert ours.shape == ref.shape == (B, 3, S * S // 128, 128)
        diff = np.abs(ours - ref)
        assert diff.mean() < MEAN_BAR, diff.mean()
        assert (diff > 10).mean() < SHARE_BAR
        assert ours.std() > 5
        np.testing.assert_array_equal(out_t.done.numpy(),
                                      bj[sk.F_DONE] > 0.5)
        n_done += int(bj[sk.F_DONE].sum())
    assert n_done >= B
