"""dtown_torch blob render on stacked multimaps (plain torch version on the
CPU) vs the JAX package's Pallas blob render kernel in interpret mode: the
merged plan against dtown's build_render_plan, and frames on a stack of
short objects, on a stack whose udem1 member has tall buildings and trees
(the reference's regression for other maps' objects bleeding into the
sky), on a stack with moving NPCs and on a stack under domain
randomization. Each env reads its own member's tile words and skips the
other members' objects. The CUDA kernel is held against the same plain
version on the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax

from dtown import map_loader as jmap_loader
from dtown import types as jtypes
from dtown.ops.fused_env import make_fused_rollout as j_make_fused_rollout
from dtown.render import blob_raster as jbr

from dtown_torch import EnvConfig, stack_maps
from dtown_torch.ops import state_kernel as sk
from dtown_torch.render import blob_raster as br

B, S = 8, 32
MEAN_BAR, SHARE_BAR = 1.0, 0.01   # test_torch_blob_render.py's bars
STACKS = {
    "short_objs": (["zigzag_dists", "4way", "small_loop"], {}),
    "tall_objs": (["zigzag_dists", "4way", "udem1"], {}),
    "npc": (["loop_pedestrians", "small_loop"], {}),
    "dr": (["4way", "small_loop"], dict(domain_rand=True)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(STACKS))
def rendered(request):
    """Both renders of dtown's initial blob of the stack (32x32), and the
    port's render of the same blob with every env's map row moved to the
    next member."""
    names, kw = STACKS[request.param]
    jcfg = jtypes.EnvConfig(camera_width=S, camera_height=S, **kw)
    cfg = EnvConfig(camera_width=S, camera_height=S, **kw)
    jmaps = jmap_loader.stack_maps(names)
    init_blob, _, _ = j_make_fused_rollout(jcfg, jmaps, B)
    blob, _ = init_blob(jax.random.PRNGKey(2))
    blob = np.array(blob)
    blob[sk.F_STEP] = np.arange(B, dtype=np.float32) * 23.0 + 5.0
    jplan = jbr.build_render_plan(jcfg, jmaps)
    ref = np.asarray(jax.jit(lambda b: jbr.render_frames_from_blob(
        jcfg, jmaps, b, jplan, interpret=True))(blob)).astype(int)
    plan = br.build_render_plan(cfg, stack_maps(names))
    pk = br.pack_plan(cfg, plan, "cpu")
    ours = br.render_frames_from_blob(torch.from_numpy(blob), pk)
    moved = blob.copy()
    moved[sk.F_MAPID] = (blob[sk.F_MAPID] + 1) % len(names)
    moved = br.render_frames_from_blob(torch.from_numpy(moved), pk)
    return (request.param, plan, jplan, pk, ours.numpy().astype(int), ref,
            moved.numpy().astype(int))


def test_stack_plan_matches_reference(rendered):
    tag, plan, jplan, pk = rendered[:4]
    assert plan == jplan and plan["multi"]["n_maps"] == pk["n_maps"]
    maps_of = pk["oi"][:pk["n_objs"], br.OI_MAP].tolist()
    assert maps_of == [ob["map"] for ob in plan["objs"]]
    assert maps_of == sorted(maps_of)     # objects are map-major
    assert pk["words"].shape[0] == pk["n_maps"] * pk["npw"]


def test_stack_render_matches_pallas_interpret(rendered):
    tag, _, _, pk, ours, ref, _ = rendered
    assert ours.shape == ref.shape == (B, pk["C"], S * S // 128, 128)
    diff = np.abs(ours - ref)
    assert diff.mean() < MEAN_BAR, diff.mean()
    assert (diff > 10).mean() < SHARE_BAR
    assert ours.std() > 5


def test_envs_on_different_maps_see_different_worlds(rendered):
    """Envs on different members see different worlds (as in dtown's own
    stack test), and the map row decides it: at the same poses on the next
    member most frames change."""
    tag, _, _, _, ours, ref, moved = rendered
    assert np.abs(ref[0] - ref[1]).mean() > 2.0, tag
    assert np.abs(ours[0] - ours[1]).mean() > 2.0, tag
    changed = np.abs(moved - ours).reshape(B, -1).mean(-1) > 2.0
    assert changed.sum() >= B // 2, (tag, changed)


def test_stack_past_the_budget_has_no_plan():
    """udem1 four times: 60 real objects, past the 48 of the plan; nine
    maps: past the 8 of a stack."""
    cfg = EnvConfig()
    assert br.build_render_plan(cfg, stack_maps(["udem1"] * 4)) is None
    assert jbr.build_render_plan(
        jtypes.EnvConfig(), jmap_loader.stack_maps(["udem1"] * 4)) is None
    assert br.build_render_plan(cfg, stack_maps(["small_loop"] * 9)) is None
