"""dtown_torch: the Duckietown environment engine on PyTorch and CUDA.

The port of the JAX package ``dtown`` to an NVIDIA H100. ``make`` gives
the reference's gym-style single env (640x480 camera frames by default),
``make_vec`` the vectorized functional env (batched physics with in-graph
auto-reset; frames from the XLA ray-caster as batched torch, the default
``renderer="xla"``, or from the row-fed CUDA render kernels with
``renderer="pallas"``), ``make_fused_rollout`` the fused rollout (state
step + blob render in two CUDA kernels; the row-fed kernel or the
ray-caster past the blob render's budget). Each takes one map or a stack
of maps (a list of names; ``stack_maps``), moving NPCs, domain
randomization, RGB, grayscale or state observations, fisheye frames
(``distortion=True``) and the Nav task (``make_fused_nav_rollout``,
``tasks.make_nav_vec``); object kinds registered from OBJ files
(``register_custom_object``) render as triangles under
``mesh_fidelity="triangles"``. Every entry point runs on the card unless
the caller passes ``device="cpu"``, where the kernels' plain torch
versions run.
"""
from dtown_torch import constants
from dtown_torch.map_loader import list_maps, load_map, stack_maps
from dtown_torch.ops.fused_env import make_fused_nav_rollout, \
    make_fused_rollout
from dtown_torch.render.objmesh import register_custom_object
from dtown_torch.types import EnvConfig, EnvState, MapArrays, StepOutput

__all__ = ["EnvConfig", "EnvState", "MapArrays", "StepOutput", "load_map",
           "make", "make_fused_nav_rollout", "make_fused_rollout",
           "make_vec", "register_custom_object", "register_gymnasium",
           "registered_ids", "stack_maps"]


def registered_ids():
    """Env ids mirroring the reference's ``Duckietown-<map>-v0`` registry,
    plus ``MultiMap-v0``."""
    return [f"Duckietown-{m}-v0" for m in list_maps()] + ["MultiMap-v0"]


def register_gymnasium():
    """Register ``dtown_torch/Duckietown-<map>-v0`` for every map with
    gymnasium (imported here: it is optional); returns the ids."""
    from dtown_torch.gymnasium_compat import register_gymnasium as _reg

    return _reg()


def make(id_or_map: str = None, **kwargs):
    """A single-env, gym-style environment (gym_compat.DuckietownEnv) from
    a registered id ("Duckietown-udem1-v0"), a bare map name ("udem1") or
    "MultiMap-v0"; keyword arguments are EnvConfig fields, ``seed`` and
    ``device`` (the card unless ``device="cpu"``)."""
    from dtown_torch.gym_compat import DuckietownEnv, MultiMapEnv

    name = id_or_map or constants.DEFAULT_MAP_NAME
    if name == "MultiMap-v0":
        return MultiMapEnv(**kwargs)
    if name.startswith("Duckietown-") and name.endswith("-v0"):
        name = name[len("Duckietown-"):-len("-v0")]
    return DuckietownEnv(map_name=name, **kwargs)


def make_vec(map_name, num_envs: int, device="cuda", **kwargs):
    """Vectorized env on ``device`` (the card unless ``device="cpu"``):
    returns (cfg, maps, v_reset, v_step) like ``dtown.make_vec``. A list
    of names is a stack of maps (env b on member b % n_maps); ``maps`` is
    the compiled map as tensors on ``device`` that v_step uses, the other
    keyword arguments are EnvConfig fields."""
    from dtown_torch.env import make_vec_env

    cfg = EnvConfig(**kwargs)
    if isinstance(map_name, (list, tuple)):
        maps = stack_maps(list(map_name))
    else:
        maps = load_map(map_name)
    v_reset, v_step = make_vec_env(cfg, maps, num_envs, device=device)
    return cfg, v_step.maps, v_reset, v_step
