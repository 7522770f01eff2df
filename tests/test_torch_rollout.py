"""dtown_torch fused RGB rollout vs the JAX package's fused rollout, plus
the port's entry-point rules: bank spawns, no silent CPU fallback, and no
import of JAX or of the JAX package."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dtown import map_loader as jmap_loader
from dtown import types as jtypes
from dtown.ops.fused_env import make_fused_rollout as j_make_fused_rollout

from dtown_torch import EnvConfig, load_map, make_fused_rollout
from dtown_torch.convert import blob_from_numpy
from dtown_torch.ops import state_kernel as sk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DISCRETE = (sk.F_DONE, sk.F_STEP, sk.F_RNG, sk.F_COLL, sk.F_INLANE,
            sk.F_OINLANE, sk.F_ENVID)


def test_rollout_matches_reference():
    B, n = 16, 4
    jcfg = jtypes.EnvConfig(camera_width=32, camera_height=32)
    cfg = EnvConfig(camera_width=32, camera_height=32)
    jmaps = jmap_loader.load_map("loop_obstacles")
    j_init, _, j_rollout = j_make_fused_rollout(jcfg, jmaps, B)
    blob_j, states = j_init(jax.random.PRNGKey(0))
    blob_t = blob_from_numpy(np.asarray(blob_j), device="cpu")
    act = np.tile(np.array([[0.4, 0.1]], np.float32), (B, 1))

    _, _, rollout = make_fused_rollout(cfg, load_map("loop_obstacles"), B,
                                       device="cpu")
    blob_t, rsum_t, osum_t = rollout(blob_t, torch.from_numpy(act), n)
    blob_j, rsum_j, osum_j = j_rollout(blob_j, states, jnp.asarray(act), n)

    bj, bt = np.asarray(blob_j), blob_t.numpy()
    for f in DISCRETE:
        np.testing.assert_array_equal(bt[f], bj[f], err_msg=str(f))
    np.testing.assert_allclose(bt[:4], bj[:4], rtol=0, atol=1e-5)
    np.testing.assert_allclose(bt[sk.F_REWARD], bj[sk.F_REWARD], rtol=0,
                               atol=1e-4)
    assert abs(float(rsum_t) - float(rsum_j)) < B * 1e-4
    # checksum of the last frame's first plane row: float vs packed-u8
    # ground quantization may move a pixel by a count
    assert abs(int(osum_t) - int(osum_j)) < B * 128


def test_init_blob_draws_bank_spawns():
    cfg = EnvConfig()
    maps = load_map("loop_obstacles")
    init_blob, _, _ = make_fused_rollout(cfg, maps, 64, device="cpu")
    blob = init_blob(torch.Generator().manual_seed(3)).numpy()
    ok = np.abs(np.asarray(maps.spawn_lane_deg)) < cfg.accept_start_angle_deg
    n_ok = int(ok.sum())
    bank = np.concatenate([np.asarray(maps.spawn_pos)[:n_ok],
                           np.asarray(maps.spawn_angle)[:n_ok, None]], -1)
    got = np.stack([blob[sk.F_POS_X], blob[sk.F_POS_Y], blob[sk.F_POS_Z],
                    blob[sk.F_ANGLE]], -1)
    match = (got[:, None, :] == bank[None]).all(-1)
    assert match.any(-1).all()
    assert len({tuple(r) for r in got}) > 32
    np.testing.assert_array_equal(blob[sk.F_ENVID], np.arange(64))
    assert ((blob[sk.F_RNG] >= 0) & (blob[sk.F_RNG] < 65536)).all()
    assert (blob[sk.F_STEP] == 0).all()
    again = init_blob(torch.Generator().manual_seed(3)).numpy()
    np.testing.assert_array_equal(blob, again)


def test_cuda_entry_point_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_fused_rollout(EnvConfig(), load_map("small_loop"), 8)


def test_port_imports_no_jax():
    """Every module of the port (the ray-caster, the gym and gymnasium
    surfaces, the wrappers, the Nav task, the native map compiler's
    binding, the texture atlas and the measurement tools among them) and
    chip_smoke.py
    import nothing of JAX or dtown; gymnasium, an optional extra that the
    card machine lacks, is imported by gymnasium_compat alone."""
    code = (
        "import importlib, pkgutil, sys\n"
        "before = set(sys.modules)\n"
        "import dtown_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    dtown_torch.__path__, 'dtown_torch.')]\n"
        "for n in names:\n"
        "    if n != 'dtown_torch.gymnasium_compat':\n"
        "        importlib.import_module(n)\n"
        "import chip_smoke\n"
        "gym = sorted(m for m in set(sys.modules) - before\n"
        "             if m.split('.')[0] == 'gymnasium')\n"
        "importlib.import_module('dtown_torch.gymnasium_compat')\n"
        "bad = sorted(m for m in set(sys.modules) - before\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',\n"
        "                                    'chex', 'dtown'))\n"
        "print(bad, gym, sorted(n.split('.')[-1] for n in names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("[] [] "), out.stdout
    for m in ("raster", "gym_compat", "gymnasium_compat", "wrappers",
              "tasks", "shading", "native", "textures", "bench", "roofline"):
        assert f"'{m}'" in out.stdout, m
