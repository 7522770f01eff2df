"""The blob render's (K2's) bytes and instructions on a given blob,
counted by hand from the render's source as it stood when this benchmark
was defined (dtown_torch/roofline.py at commit ddda995, frozen here), and
through the reference's copy of the render's culls, so that the count reads
the same work whatever implements the render."""
from __future__ import annotations

import torch

from simbench.reference.frozen.ops import state_kernel as sk
from simbench.reference.frozen.render import blob_raster as br

OPS_PIXEL = 150        # camera, ground hit, tile shading, sky, output
OPS_DR_PIXEL = 50      # DR: NDC table, ray basis, 1/sqrt, ground divide,
                       # variant hash
OPS_BOUND = 10         # a kept object's bounding-sphere test
OPS_BOX_PIXEL = 20     # a box or triangle object's ray in model space,
                       # where its bounding sphere is met
OPS_BOX = 40           # one box primitive
OPS_SPHERE = 26        # one sphere primitive
OPS_TRI = 62           # one triangle
# once per env
OPS_OBJECT = 8         # distance, optional-bit and half-plane culls
OPS_BOX_ENV = 12       # a kept box object's eye in model space
OPS_PRIM_ENV = 12      # a kept primitive's per-env record, LOD cull
OPS_NPC_OBJECT = 60    # an NPC's pose, wiggle, sincos, light rotation
OPS_MAP = 2            # a stack's map test of one object

# pixels a slice of the sphere pass holds at once, so it fits the card
SLICE_PIXELS = 1 << 24


def k2_bytes(pk, B):
    """Frames written, blob rows and tables read once; the ray input is the
    static planes or, under DR, the NDC table. pk: the reference's pack."""
    P = pk["H"] * pk["W"]
    tab = sum(pk[k].numel() * pk[k].element_size()
              for k in ("words", "scene", "of", "oi", "pf", "pi"))
    rows = (5 + pk["n_npc"] * 3 + (16 if pk["dr"] else 0)
            + (1 if pk["n_maps"] > 1 else 0))
    return B * pk["C"] * P + rows * B * 4 + tab + pk["rays"].numel() * 4


def k2_ops(blob, pk):
    """Instructions the render needs on this blob: per pixel the ground
    pass (and under DR the per-pixel ray and variant hash), the bounding
    sphere test of each object its env keeps, and the ray tests of a kept
    object's kept primitives on the pixels whose rays meet its bounding
    sphere (the reference's ``kept`` and ``sphere_pass``); once per env each
    object's culls, a kept box's eye in model space, a kept primitive's
    record and a moving NPC's pose."""
    P = pk["H"] * pk["W"]
    oi, pi = pk["oi"].cpu(), pk["pi"].cpu()
    b = blob.cpu()
    keep_o, keep_p = (m.double() for m in br.kept(b, pk))
    B, n_o = b.shape[1], pk["n_objs"]
    hits = torch.zeros((B, n_o), dtype=torch.float64)
    n = max(1, SLICE_PIXELS // (P * max(n_o, 1)))
    for i in range(0, B, n):
        hits[i:i + n] = br.sphere_pass(
            blob[:, i:i + n].contiguous(), pk).sum(2).double().cpu()
    per_env = torch.full((B,), float(
        OPS_PIXEL + (OPS_DR_PIXEL if pk["dr"] else 0)) * P,
        dtype=torch.float64)
    stack = pk["n_maps"] > 1
    mid = b[sk.F_MAPID].to(torch.int64)
    cost_of = {br.SPHERE_T: OPS_SPHERE, br.BOX_T: OPS_BOX,
               br.TRI_T: OPS_TRI}
    for o in range(n_o):
        own = (mid == int(oi[o, br.OI_MAP])).double() if stack else 1.0
        if stack:
            per_env += OPS_MAP
        if int(oi[o, br.OI_NPC]) >= 0:
            per_env += own * OPS_NPC_OBJECT
        per_env += own * OPS_OBJECT + keep_o[:, o] * OPS_BOUND * P
        if oi[o, br.OI_MODEL]:
            per_env += keep_o[:, o] * OPS_BOX_ENV
            per_env += hits[:, o] * OPS_BOX_PIXEL
        p0, n_p = int(oi[o, br.OI_P0]), int(oi[o, br.OI_NP])
        for j in range(p0, p0 + n_p):
            per_env += keep_p[:, j] * (OPS_PRIM_ENV + hits[:, o]
                                       * cost_of[int(pi[j, br.PI_TYPE])])
    return float(per_env.sum())
