"""Carry a map and a state blob across from the JAX package.

This system has no weights: what crosses between the two implementations
is the compiled map and the env state. Both functions take plain numpy
(``np.asarray`` of the JAX arrays), so nothing here imports JAX.
"""
import numpy as np
import torch

from dtown_torch.types import MAP_FIELDS, MapArrays


def maps_from_numpy(fields: dict) -> MapArrays:
    """MapArrays from a dict of numpy arrays, one per MapArrays field of
    the JAX package's compiled map."""
    missing = [f for f in MAP_FIELDS if f not in fields]
    if missing:
        raise ValueError(f"missing map fields: {missing}")
    return MapArrays(**{f: np.asarray(fields[f]) for f in MAP_FIELDS})


def blob_from_numpy(a, device="cpu") -> torch.Tensor:
    """The JAX package's state blob f32 [NF, B] as a tensor on device."""
    a = np.asarray(a)
    if a.ndim != 2 or a.dtype != np.float32:
        raise ValueError(f"blob must be float32 [NF, B], got {a.shape} "
                         f"{a.dtype}")
    return torch.tensor(a, device=device)
