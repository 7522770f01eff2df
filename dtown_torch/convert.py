"""Carry a map and env states across from the JAX package.

This system has no weights: what crosses between the two implementations
is the compiled map and the env state (as the fused rollout's blob or as
the vectorized API's EnvState). Every function takes plain numpy
(``np.asarray`` of the JAX arrays), so nothing here imports JAX. States
land on the card unless the caller asks for the CPU (``device="cpu"``).
"""
import dataclasses

import numpy as np
import torch

from dtown_torch.device import resolve_device
from dtown_torch.types import MAP_FIELDS, DynObjState, EnvState, MapArrays


def maps_from_numpy(fields: dict) -> MapArrays:
    """MapArrays from a dict of numpy arrays, one per MapArrays field of
    the JAX package's compiled map."""
    missing = [f for f in MAP_FIELDS if f not in fields]
    if missing:
        raise ValueError(f"missing map fields: {missing}")
    return MapArrays(**{f: np.asarray(fields[f]) for f in MAP_FIELDS})


def env_states_from_numpy(fields, device="cuda") -> EnvState:
    """The port's batched EnvState from the JAX package's vmapped EnvState:
    ``fields`` has the EnvState field names as attributes (and ``dyn`` the
    DynObjState ones), each a [B, ...] array that np.asarray takes. The
    PRNG key ``rng`` has no counterpart and is dropped. Raises without
    CUDA unless ``device="cpu"``."""
    dev = resolve_device(device)
    t = lambda a: torch.tensor(np.asarray(a), device=dev)
    dyn = DynObjState(**{f.name: t(getattr(fields.dyn, f.name))
                         for f in dataclasses.fields(DynObjState)})
    return EnvState(dyn=dyn, **{
        f.name: t(getattr(fields, f.name))
        for f in dataclasses.fields(EnvState) if f.name != "dyn"})


def blob_from_numpy(a, device="cuda") -> torch.Tensor:
    """The JAX package's state blob f32 [NF, B] as a tensor on device.
    Raises without CUDA unless ``device="cpu"``."""
    dev = resolve_device(device)
    a = np.asarray(a)
    if a.ndim != 2 or a.dtype != np.float32:
        raise ValueError(f"blob must be float32 [NF, B], got {a.shape} "
                         f"{a.dtype}")
    return torch.tensor(a, device=dev)
