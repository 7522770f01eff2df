"""The kernels' roofline on the H100: the card's published peaks, the
least time for a count of bytes and instructions (``bound``), and the
instructions the blob render (K2) needs on a given blob (``k2_ops``),
counted by the kernel's own culls. ``chip_smoke.py`` prints every
kernel's bound through these, and ``python -m
dtown_torch.roofline_objpass`` the object pass's gap to the instruction
bound.
"""
from __future__ import annotations

# H100 SXM published peaks (NVIDIA H100 datasheet): HBM bytes/s and
# float32 FLOP/s outside the tensor cores, which counts an FMA as two.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# The kernels build with -fmad=false, so every add or mul is an
# instruction of its own: the float32 lanes execute PEAK_F32 / 2 of them
# a second. Integer, compare and select instructions run on lanes no
# wider, so counted instructions over this rate is still the least time.
PEAK_INSTR = PEAK_F32 / 2
# dense bf16 tensor-core FLOP/s (the same datasheet): the learner's share
PEAK_BF16 = 989e12

# Instruction counts per unit of work of csrc/blob_render.cu, counted by
# hand from the source (arithmetic, compare and select instructions; a
# sqrt, divide or table load counts as one). Estimates: they set the
# operation bound.
K2_OPS_PIXEL = 150        # camera, ground hit, tile shading, sky, output
K2_OPS_DR_PIXEL = 50      # DR: NDC table, ray basis, 1/sqrt, ground divide,
                          # variant hash
K2_OPS_BOUND = 10         # a kept object's bounding-sphere test (record
                          # load, b = oc . d, compares)
K2_OPS_BOX_PIXEL = 20     # a box or triangle object's ray in model space,
                          # inverses, where its bounding sphere is met
K2_OPS_BOX = 40           # one box primitive (2 record loads, slabs from
                          # the per-env offsets, shading, fold)
K2_OPS_SPHERE = 26        # one sphere primitive (2 loads, b, disc, root,
                          # light term, fold)
K2_OPS_TRI = 62           # one triangle: 5 loads, Moeller-Trumbore's per-ray
                          # half (pvec, det, 1/det, u, v, t), tests, flat
                          # two-sided shading, fold
# once per env (the kernel's per-block prologue; the bound counts it once
# per env, not once per block)
K2_OPS_OBJECT = 8         # distance, optional-bit and half-plane culls
K2_OPS_BOX_ENV = 12       # a kept box object's eye in model space
K2_OPS_PRIM_ENV = 12      # a kept primitive's per-env record (slab offsets,
                          # sphere terms, tvec/qvec), LOD cull
K2_OPS_NPC_OBJECT = 60    # an NPC's pose, wiggle, sincos, light rotation
K2_OPS_MAP = 2            # a stack's map test of one object


def bound(nbytes, nops):
    """The least time (ms) for nbytes of traffic and nops instructions,
    and which of the two sets it."""
    tb, to = nbytes / PEAK_BYTES * 1e3, nops / PEAK_INSTR * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def k2_ops(blob, pk, P):
    """Operations the render needs on this blob: per pixel the ground pass
    (and, under domain randomization, the per-pixel ray and variant hash),
    the bounding-sphere test of each object its env keeps, and the ray
    tests of a kept object's kept primitives on the pixels whose rays meet
    its bounding sphere; by the kernel's own culls (blob_raster.kept: the
    map, distance, optional-bit, NPC half-plane and, when pk["view"], view
    culls, then the LOD culls; blob_raster.sphere_pass, counted on the
    card in slices of envs). Once per env each object's culls, a kept box's
    eye in model space, a kept primitive's per-env record, and a moving
    NPC's pose and light rotation (culled or not). On a stack an env pays
    one map test per object and the rest only for its own map's
    objects."""
    import torch
    from dtown_torch.ops import state_kernel as sk
    from dtown_torch.render import blob_raster as br

    oi, pi = pk["oi"].cpu(), pk["pi"].cpu()
    b = blob.cpu()
    keep_o, keep_p = (m.double() for m in br.kept(b, pk))
    B, n_o = b.shape[1], pk["n_objs"]
    hits = torch.zeros((B, n_o), dtype=torch.float64)
    n = max(1, (1 << 24) // (P * max(n_o, 1)))
    for i in range(0, B, n):
        hits[i:i + n] = br.sphere_pass(
            blob[:, i:i + n].contiguous(), pk).sum(2).double().cpu()
    per_env = torch.full((B,), float(
        K2_OPS_PIXEL + (K2_OPS_DR_PIXEL if pk["dr"] else 0)) * P,
        dtype=torch.float64)
    stack = pk["n_maps"] > 1
    mid = b[sk.F_MAPID].to(torch.int64)
    cost_of = {br.SPHERE_T: K2_OPS_SPHERE, br.BOX_T: K2_OPS_BOX,
               br.TRI_T: K2_OPS_TRI}
    for o in range(n_o):
        own = (mid == int(oi[o, br.OI_MAP])).double() if stack else 1.0
        if stack:
            per_env += K2_OPS_MAP
        if int(oi[o, br.OI_NPC]) >= 0:
            per_env += own * K2_OPS_NPC_OBJECT
        per_env += own * K2_OPS_OBJECT + keep_o[:, o] * K2_OPS_BOUND * P
        if oi[o, br.OI_MODEL]:
            per_env += keep_o[:, o] * K2_OPS_BOX_ENV
            per_env += hits[:, o] * K2_OPS_BOX_PIXEL
        p0, n_p = int(oi[o, br.OI_P0]), int(oi[o, br.OI_NP])
        for j in range(p0, p0 + n_p):
            per_env += keep_p[:, j] * (K2_OPS_PRIM_ENV + hits[:, o]
                                       * cost_of[int(pi[j, br.PI_TYPE])])
    return float(per_env.sum())
