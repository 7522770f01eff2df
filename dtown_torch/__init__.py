"""dtown_torch: the Duckietown environment engine on PyTorch and CUDA.

The port of the JAX package ``dtown`` to an NVIDIA H100: the fused
rollout (state step + blob render; one map or a stack of maps from
``stack_maps``, moving NPCs, domain randomization, RGB, grayscale or state
observations, and the Nav task with ``make_fused_nav_rollout``) and the
vectorized step API (``make_vec``: batched physics + the row-fed render,
single maps) run through hand-written CUDA kernels (csrc/), each with a
plain torch version that the CPU runs. Both take fisheye frames
(``distortion=True``) and any frame size with H*W % 128 == 0; object kinds
registered from OBJ files (``register_custom_object``) render as
triangles on the fused rollout under ``mesh_fidelity="triangles"``.
"""
from dtown_torch.map_loader import load_map, stack_maps
from dtown_torch.ops.fused_env import make_fused_nav_rollout, \
    make_fused_rollout
from dtown_torch.render.objmesh import register_custom_object
from dtown_torch.types import EnvConfig, EnvState, StepOutput

__all__ = ["EnvConfig", "EnvState", "StepOutput", "load_map",
           "make_fused_nav_rollout", "make_fused_rollout", "make_vec",
           "register_custom_object", "stack_maps"]


def make_vec(map_name, num_envs: int, device="cuda", **kwargs):
    """Vectorized env on ``device`` (the card unless ``device="cpu"``):
    returns (cfg, maps, v_reset, v_step) like ``dtown.make_vec``; ``maps``
    is the compiled map as tensors on ``device`` that v_step uses, the
    other keyword arguments are EnvConfig fields."""
    from dtown_torch.env import make_vec_env

    cfg = EnvConfig(**kwargs)
    if isinstance(map_name, (list, tuple)):
        # a multimap, which make_vec_env refuses
        maps = [load_map(n) for n in map_name]
    else:
        maps = load_map(map_name)
    v_reset, v_step = make_vec_env(cfg, maps, num_envs, device=device)
    return cfg, v_step.maps, v_reset, v_step
