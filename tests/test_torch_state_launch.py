"""The CUDA state kernel's launch shape, computed in Python
(ops/state_kernel.py::launch_shape): a group of K1_GROUP lanes per env
inside one warp, as many envs a block as fit the shared memory that holds
their blob columns (the NPC state included), on every shipped map and on
chip_smoke.py's stacks, with domain randomization and the Nav rows (the
tallest blob), and on synthetic NPC counts; the constants agree with
csrc/state_kernel.cu. Also: the state carried across from the JAX package
lands on the card unless the caller asks for the CPU."""
import os
import re

import numpy as np
import pytest
import torch

import dtown_torch
from dtown_torch import convert
from dtown_torch import env as tenv
from dtown_torch import map_loader
from dtown_torch.ops import state_kernel as sk

import chip_smoke

MAPS = sorted(f[:-5] for f in os.listdir(map_loader.MAPS_DIR)
              if f.endswith(".yaml"))
STACKS = {"stack3": chip_smoke.STACK3, "stack6": chip_smoke.STACK6,
          "stack_npc_dr": ["town_dyn_duckiebots", "udem1"],
          "npc10": chip_smoke.NPC10}
WARP = 32


def check_shape(nf, M, n_npc, n_words):
    """The launch shape's invariants; returns (G, E, staged)."""
    G, E, smem = sk.launch_shape(nf, M, n_npc, n_words)
    per_env = nf + sk.K1_ENV_WORDS + 2 * M
    staged = (sk.K1_TABLE_WORDS + n_words + sk.K1_COLUMN_WORDS * M
              + sk.NPC_F * n_npc)
    words = sk.K1_SMEM_MAX // 4
    tables = smem // 4 - E * per_env
    assert WARP % G == 0            # a group never spans two warps
    assert 1 <= E and E * G <= sk.K1_THREADS
    assert smem % 4 == 0 and smem <= sk.K1_SMEM_MAX
    # the tile words, object and NPC tables are staged unless one env
    # leaves no room
    assert tables == staged or (tables == sk.K1_TABLE_WORDS
                                and staged + per_env > words)
    # as many envs as fit
    assert E == sk.K1_THREADS // G or tables + (E + 1) * per_env > words
    return G, E, tables == staged


def tables_of(maps):
    cfg = dtown_torch.EnvConfig(domain_rand=True)
    return sk.device_tables(cfg, sk.build_tables(cfg, maps), "cpu",
                            nav=sk.build_goal_table(maps))


@pytest.mark.parametrize("name", MAPS)
def test_launch_shape_single_map(name):
    dev = tables_of(dtown_torch.load_map(name))
    G, E, staged = check_shape(dev["nf"], dev["M"], dev["n_npc"],
                               dev["n_words"])
    # a shipped map never lowers E and stages its tables
    assert E == sk.K1_THREADS // G and staged


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_launch_shape_stack(stack):
    dev = tables_of(dtown_torch.stack_maps(STACKS[stack]))
    G, E, staged = check_shape(dev["nf"], dev["M"], dev["n_npc"],
                               dev["n_words"])
    assert E == sk.K1_THREADS // G and staged
    if stack == "npc10":
        assert dev["n_npc"] == 10


@pytest.mark.parametrize("n_npc, envs, staged", [(64, 16, True),
                                                  (2000, 4, False)])
def test_launch_shape_many_npcs(n_npc, envs, staged):
    """n_npc NPCs, each an object column, with DR and Nav rows: the launch
    lowers E until the block fits, and leaves the tables in global memory
    where they would not fit beside one env (metro's 100 tile words)."""
    nf = sk.nf_for(n_npc, domain_rand=True, nav=True)
    assert check_shape(nf, n_npc, n_npc, 100)[1:] == (envs, staged)


def test_launch_shape_refuses_one_env_too_big():
    """Past ~8,000 NPCs (each an object column) one env's blob column and
    SAT scratch outgrow a block's shared memory: the wrapper raises."""
    check_shape(sk.nf_for(8200, domain_rand=True, nav=True), 8200, 8200, 100)
    with pytest.raises(ValueError, match="shared memory"):
        sk.launch_shape(sk.nf_for(8400, domain_rand=True, nav=True), 8400,
                        8400, 100)


def test_launch_constants_match_the_kernel():
    src = open(os.path.join(os.path.dirname(sk.__file__), "..", "csrc",
                            "state_kernel.cu")).read()
    c = {k: int(v) for k, v in re.findall(r"\b([A-Z][A-Z0-9_]*) = (\d+)\b",
                                          src)}
    assert (c["G"], c["THREADS"]) == (sk.K1_GROUP, sk.K1_THREADS)
    # the per-env scratch: actions, the agent record, the chord dots, the
    # curves' control points, the probes, the done flag
    assert "ENV_WORDS = 2 + AG_N + N_CURVES + N_CPS * N_CURVES + N_PROBES" \
        in src
    assert 2 + c["AG_N"] + (1 + c["N_CPS"]) * sk.N_CURVES + c["N_PROBES"] \
        + 1 == sk.K1_ENV_WORDS
    assert c["PRM_WORDS"] + c["DRP_WORDS"] == sk.K1_TABLE_WORDS
    assert c["PRM_WORDS"] >= len(sk._PARAM_NAMES)
    assert c["DRP_WORDS"] == 2 * len(sk.DR_TAGS)
    # a column's table rows OT_CX..OT_DYN and its three column-map entries
    assert "COLUMN_WORDS = OT_ROWS + 3" in src
    assert c["OT_DYN"] + 1 + 3 == sk.K1_COLUMN_WORDS
    assert c["NPC_F"] == sk.NPC_F


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_blob_from_numpy_defaults_to_the_card(no_cuda):
    a = np.zeros((sk.NF, 8), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.blob_from_numpy(a)
    assert convert.blob_from_numpy(a, device="cpu").device.type == "cpu"


def test_env_states_from_numpy_defaults_to_the_card(no_cuda):
    maps = dtown_torch.load_map("small_loop")
    states = tenv.reset(dtown_torch.EnvConfig(), maps.to("cpu"),
                        torch.Generator().manual_seed(0), 4)
    host = states.to("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.env_states_from_numpy(host)
    st = convert.env_states_from_numpy(host, device="cpu")
    assert st.pos.device.type == "cpu"
    torch.testing.assert_close(st.pos, states.pos, rtol=0, atol=0)


def test_initial_map_indices_takes_a_device():
    stack = dtown_torch.stack_maps(chip_smoke.STACK3)
    with pytest.raises(TypeError):
        tenv.initial_map_indices(stack, 6)
    idx = tenv.initial_map_indices(stack, 6, "cpu")
    assert idx.tolist() == [0, 1, 2, 0, 1, 2]
