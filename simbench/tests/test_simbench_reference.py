"""The reference against the port's plain versions at a small size on
the CPU (16 envs, 32x32): the reset, the state step through auto-resets
and the blob render agree exactly, fused PPO's first iterations to
rounding, and the map compiled from the YAML alone equals the port's."""
import pytest
import torch

import dtown_torch
from dtown_torch.ops import state_kernel as psk
from dtown_torch.render import blob_raster as pbr
from simbench import cells
from simbench.conftest import SMALL, small_cell
from dtown_torch import types as ptypes
from simbench.reference import fused, ppo as rppo, town

B = 16


def _config(name):
    return small_cell(name + ".rollout").config


@pytest.mark.parametrize("name", ["loop_obstacles_rgb64", "udem1_dr_rgb96"])
def test_fused_reference_equals_plain_versions(name):
    config = dict(_config(name), env=dict(_config(name)["env"],
                                          max_steps=6))
    ref = fused.build(config, "cpu")
    cfg = dtown_torch.EnvConfig(**config["env"])
    init_blob, fused_step, _ = dtown_torch.make_fused_rollout(
        cfg, dtown_torch.load_map(config["map"]), B, device="cpu")
    blob = init_blob(torch.Generator().manual_seed(3))
    assert torch.equal(blob, fused.init_blob(
        ref, torch.Generator().manual_seed(3)))
    gen = torch.Generator().manual_seed(4)
    dones = 0
    for _ in range(8):
        a = torch.rand((B, 2), generator=gen) * 2 - 1
        want = psk.state_step_reference(blob, a[:, 0], a[:, 1],
                                        fused_step.tables)
        got = fused.step(ref, blob, a)
        assert torch.equal(got, want)
        assert torch.equal(fused.render(ref, got), pbr.render_frames_reference(
            want, fused_step.pack))
        dones += int((got[psk.F_DONE] > 0.5).sum())
        blob = got
    assert dones > 0   # auto-resets ran


def test_ppo_reference_follows_the_port():
    """The learner written from the equations against the port's first
    optimizer step: the same initial parameters bit for bit, the same
    first loss, gradient and parameters after the step to rounding."""
    cell = small_cell("loop_obstacles_rgb64.ppo")
    c = cell.loop.Cell(cell.config, cell.traffic, 8, "cpu")
    _, theta0, loss1, first, after1 = rppo.first_step(
        cell.config, cell.traffic["ppo"], c.init_seed, "cpu")
    assert set(theta0) == set(c.theta0) == set(first) == set(c.first)
    for k, v in theta0.items():
        assert torch.equal(v, c.theta0[k]), k
    assert c.loss1 == pytest.approx(loss1, rel=1e-6)
    assert rppo.leaf_gaps(c.first, first) < 1e-6
    assert rppo.leaf_gaps({k: v - theta0[k] for k, v in c.after1.items()},
                          {k: v - theta0[k] for k, v in after1.items()}
                          ) < 1e-6


def _program_map(name):
    return fused.map_arrays(dtown_torch.load_map(name).numpy(),
                            ptypes.OBJ_KIND_IDS)


@pytest.mark.parametrize("name", ["loop_obstacles", "udem1"])
def test_town_equals_the_port_map(name):
    """The map worked out from the YAML's rules alone agrees with the
    port's compiled map to float32 rounding, and the port's accepted spawn
    bank holds valid spawns only."""
    t = town.Town(name)
    m, kinds = _program_map(name)
    assert town.map_gap(t, kinds, m) < 1e-6
    host = dtown_torch.load_map(name).numpy()
    ok = abs(host.spawn_lane_deg) < 60.0
    assert town.off_road(t, host.spawn_pos[ok, 0], host.spawn_pos[ok, 2],
                         host.spawn_angle[ok]) == 0


@pytest.mark.parametrize("fault", ["turned_tile", "lane_left", "moved_object",
                                   "lost_lane", "dropped_object"])
def test_town_finds_a_wrong_map(fault):
    t = town.Town("udem1")
    m, kinds = _program_map("udem1")
    m = {k: v.copy() for k, v in m.items()}
    j, i = 1, 4                                 # the 3-way tile
    if fault == "turned_tile":
        c = m["curves"][j, i].copy()
        m["curves"][j, i, ..., 0] = c[..., 2] - (j - i) * t.ts
        m["curves"][j, i, ..., 2] = -c[..., 0] + (i + j + 1) * t.ts
    elif fault == "lane_left":                  # traffic on the left
        m["curves"][1, 2, ..., 2] = 2 * 1.5 * t.ts - m["curves"][1, 2, ..., 2]
    elif fault == "moved_object":
        m["obj_pos"][3, 0] += 0.01
    elif fault == "lost_lane":
        m["curve_mask"][j, i, 0] = False
    else:
        m["obj_mask"][2] = False
    assert town.map_gap(t, kinds, m) > 1e-3


def test_off_road_counts_invalid_spawns():
    t = town.Town("loop_obstacles")
    ts = t.ts
    # on the top straight, heading along it; then in the middle of the grass
    x = [2.5 * ts, 2.5 * ts]
    z = [0.5 * ts + 0.1, 2.5 * ts]
    assert town.off_road(t, x, z, [0.0, 0.0]) == 1
