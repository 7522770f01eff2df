"""dtown_torch blob render under domain randomization (plain torch version
on the CPU) vs the JAX package's Pallas blob render kernel in interpret
mode, on udem1 in RGB and in grayscale: per-env rays (camera basis,
normalization and ground divide per pixel), per-texel variant hashes, the
per-env light rotated into each object's model space, and the optional
objects' visibility bits. The CUDA kernel is held against the same plain
version on the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

from dtown import map_loader as jmap_loader
from dtown import types as jtypes

from dtown_torch import EnvConfig, load_map
from dtown_torch.ops import state_kernel as sk
from dtown_torch.render import blob_raster as br

from test_torch_blob_render_npc import B, S, posed_blob, render_both


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dr_blob():
    """udem1 with domain randomization; half the envs look at its two
    optional objects, one of them with the visibility bits flipped so
    both states of each bit are drawn."""
    jcfg = jtypes.EnvConfig(camera_width=S, camera_height=S,
                            domain_rand=True)
    jmaps = jmap_loader.load_map("udem1")
    opt = np.nonzero(np.asarray(jmaps.obj_optional)
                     & np.asarray(jmaps.obj_mask))[0]
    targets = [tuple(np.asarray(jmaps.obj_pos)[s, [0, 2]]) for s in opt]
    blob = posed_blob(jcfg, jmaps, targets, seed=2)
    drb = sk.dr_base(0)
    blob[drb + sk.DR_OBJVIS, :4] = np.array([3, 0, 1, 2], np.float32)
    return blob


@pytest.mark.parametrize("gray", [False, True])
def test_domain_rand_render_matches_pallas_interpret(dr_blob, gray):
    ours, pk = render_both("udem1", dr_blob, domain_rand=True,
                           grayscale=gray)
    assert pk["dr"] and pk["C"] == (1 if gray else 3)
    assert ours.shape == (B, pk["C"], S * S // 128, 128)
    assert ours.std() > 5
    assert (pk["oi"][:, br.OI_OPT] >= 0).sum() > 0


def test_domain_rand_rows_drive_the_render(dr_blob):
    """The frames follow the DR rows: another camera height, ground colour
    or texture seed changes them, and so does a visibility bit for an env
    looking at an optional object."""
    cfg = EnvConfig(camera_width=S, camera_height=S, domain_rand=True)
    pk = br.pack_plan(cfg, br.build_render_plan(cfg, load_map("udem1")),
                      "cpu")
    base = br.render_frames_from_blob(torch.from_numpy(dr_blob), pk)
    drb = sk.dr_base(0)
    for row, value in ((sk.DR_CAMH, 0.09), (sk.DR_GR, 0.4),
                       (sk.DR_TEXSEED, 12345.0), (sk.DR_OBJVIS, 0.0)):
        b = dr_blob.copy()
        b[drb + row, 0] = value
        img = br.render_frames_from_blob(torch.from_numpy(b), pk)
        assert not torch.equal(img[0], base[0]), row
        assert torch.equal(img[1:], base[1:])
