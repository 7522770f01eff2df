"""The frozen counts equal the port's own on the same inputs, as they
stood when the benchmark was defined: K2's instructions
(dtown_torch/roofline.py ``k2_ops``), K1's and K2's bytes and the
NatureCNN's FLOPs (chip_smoke.py ``k1_bytes``, ``k2_bytes``,
``policy_flops``)."""
import pytest
import torch

import chip_smoke
import dtown_torch
from dtown_torch import roofline
from dtown_torch.learn import networks
from simbench.conftest import small_cell
from simbench.counts import k1 as k1c
from simbench.counts import k2 as k2c
from simbench.counts import policy
from simbench.reference import fused

B = 16


@pytest.mark.parametrize("name", ["loop_obstacles_rgb64", "udem1_dr_rgb96"])
def test_k1_k2_counts_equal_the_ports(name):
    config = small_cell(name + ".rollout").config
    ref = fused.build(config, "cpu")
    cfg = dtown_torch.EnvConfig(**config["env"])
    init_blob, fused_step, _ = dtown_torch.make_fused_rollout(
        cfg, dtown_torch.load_map(config["map"]), B, device="cpu")
    blob = init_blob(torch.Generator().manual_seed(1))
    a = torch.rand((B, 2), generator=torch.Generator().manual_seed(2))
    for _ in range(3):
        blob, _, _ = fused_step(blob, a * 2 - 1)
    pk, P = fused_step.pack, pk_pixels(fused_step.pack)
    assert k2c.k2_ops(blob, ref.pk) == roofline.k2_ops(blob, pk, P)
    assert k2c.k2_bytes(ref.pk, B) == chip_smoke.k2_bytes(pk, B, P)
    assert k1c.k1_bytes(ref.st, blob.shape[0], B) == chip_smoke.k1_bytes(
        fused_step.tables, blob.shape[0], B)


def pk_pixels(pk):
    return pk["H"] * pk["W"]


@pytest.mark.parametrize("size", [(64, 64), (96, 96), (32, 32)])
def test_policy_flops_equal_the_ports(size):
    H, W = size
    net = networks.ActorCritic((H, W, 3), device="cpu",
                               generator=torch.Generator().manual_seed(0))
    obs = torch.zeros((1, H, W, 3), dtype=torch.uint8)
    assert policy.nature_forward_flops(H, W, 3) == \
        chip_smoke.policy_flops(net, obs)
