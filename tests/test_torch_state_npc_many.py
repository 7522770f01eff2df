"""dtown_torch state step with more than 8 moving NPCs: the fused
state-obs rollout (make_fused_rollout on the CPU, the plain torch version
of the state kernel) on a stack whose members hold 2 + 3 + 4 = 9 NPCs of
both kinds, vs the JAX package's Pallas state kernel in interpret mode,
from the same initial blob with the same actions through a forced
auto-reset (max_steps=3). The CUDA kernel keeps any number of NPCs' state
in its shared-memory copy of the blob rows (tests/test_torch_state_launch.py
checks that the launch fits); chip_smoke.py holds it against the same
plain version on the card."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dtown import map_loader as jmap_loader
from dtown import types as jtypes
from dtown.ops import state_kernel as jsk
from dtown.ops.fused_env import make_fused_rollout as j_make_fused_rollout

from dtown_torch import EnvConfig, make_fused_rollout, stack_maps
from dtown_torch.convert import blob_from_numpy
from dtown_torch.ops import fused_env as fe
from dtown_torch.ops import state_kernel as sk

from test_torch_state_npc import NPC_ATOL, check_rows

B, N_STEPS = 8, 4
NAMES = ["loop_duckies", "loop_pedestrians", "town_dyn_duckiebots"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run():
    """N_STEPS of B envs on both sides from dtown's initial blob of the
    stack: dtown's interpret-mode state kernel, and the port's fused state
    rollout step. Returns the blobs after each step (numpy), the port's
    state observations and its device tables."""
    jcfg = jtypes.EnvConfig(obs_type="state", max_steps=3)
    jmaps = jmap_loader.stack_maps(NAMES)
    jtables = jsk.build_tables(jcfg, jmaps)
    init_blob, _, _ = j_make_fused_rollout(jcfg, jmaps, B)
    blob_j, _ = init_blob(jax.random.PRNGKey(0))
    step_j = jax.jit(lambda b, a: jsk.state_step_pallas(
        jcfg, jmaps, b, a, jtables, interpret=True))
    _, fused_step, _ = make_fused_rollout(
        EnvConfig(obs_type="state", max_steps=3), stack_maps(NAMES), B,
        device="cpu")
    blob_t = blob_from_numpy(np.asarray(blob_j), device="cpu")
    rng = np.random.default_rng(1)
    out_j, out_t, obs_t = [], [], []
    for _ in range(N_STEPS):
        act = np.stack([rng.uniform(-0.2, 1.0, B),
                        rng.uniform(-1.0, 1.0, B)], -1).astype(np.float32)
        blob_j = step_j(blob_j, jnp.asarray(act))
        blob_t, _, obs = fused_step(blob_t, torch.from_numpy(act))
        out_j.append(np.asarray(blob_j))
        out_t.append(blob_t.numpy().copy())
        obs_t.append(obs)
    return out_j, out_t, obs_t, fused_step.tables


def test_nine_npcs_match_pallas_interpret(run):
    out_j, out_t, obs_t, dev = run
    assert dev["n_npc"] == 9
    assert {d["kind"] for d in dev["npcs"]} == {"duckie", "duckiebot"}
    assert [d["map"] for d in dev["npcs"]] == [0] * 2 + [1] * 3 + [2] * 4
    drb = sk.dr_base(dev["n_npc"])
    n_done = 0
    for bj, bt, obs in zip(out_j, out_t, obs_t):
        check_rows(bj, bt)
        # every NPC row, the other members' envs included
        np.testing.assert_allclose(bt[sk.F_NPC_BASE:drb],
                                   bj[sk.F_NPC_BASE:drb], rtol=0,
                                   atol=NPC_ATOL)
        assert tuple(obs.shape) == (B, 11) and bool(torch.isfinite(obs).all())
        torch.testing.assert_close(obs, fe.state_obs_from_blob(
            torch.from_numpy(bt)), rtol=0, atol=0)
        n_done += int(bj[sk.F_DONE].sum())
    assert n_done >= B      # the forced auto-reset at max_steps


def test_npcs_replaced_at_the_reset(run):
    """At the forced reset every NPC of an env is back at its initial
    pose (its member's own NPCs and the parked rows of the others)."""
    _, out_t, _, dev = run
    done = out_t[2][sk.F_DONE] > 0.5
    assert done.all()
    for i, npc in enumerate(dev["npcs"]):
        base = sk.F_NPC_BASE + sk.NPC_ROWS * i
        np.testing.assert_array_equal(out_t[2][base],
                                      np.float32(npc["x0"]))
        np.testing.assert_array_equal(out_t[2][base + 3], 0.0)

