"""Carry a map, env states and policy weights across from the JAX package.

What crosses between the two implementations is the compiled map, the env
state (as the fused rollout's blob or as the vectorized API's EnvState)
and the learner's network parameters (a flax params tree). Every function
takes plain numpy (``np.asarray`` of the JAX arrays), so nothing here
imports JAX. States land on the card unless the caller asks for the CPU
(``device="cpu"``); parameters land on the module's device.
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


_LSTM_GATES = "ifgo"


def params_from_flax(tree, module):
    """Load a flax params tree (nested dicts of numpy arrays, with or
    without the top-level "params" key) into ``module``, a network of
    dtown_torch.learn whose submodules carry flax's names, and return it.

    Dense kernels [in, out] become weights [out, in], conv kernels HWIO
    become OIHW, ``log_std`` and biases carry over as they are; an
    OptimizedLSTMCell's gate kernels ii, if, ig, io and hi, hf, hg, ho
    stack into weight_ih / weight_hh and its hidden biases into bias_hh
    (flax's input kernels have no bias). Raises ValueError on a leaf
    missing from either side or of another shape."""
    tree = tree.get("params", tree)
    flat = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat[path + (k,)] = np.asarray(v, np.float32)

    walk(tree, ())
    out, cells = {}, {}
    for path, a in flat.items():
        *mods, leaf = path
        if len(mods) >= 2 and mods[-2].startswith("OptimizedLSTMCell"):
            cells.setdefault(tuple(mods[:-1]), {})[(mods[-1], leaf)] = a
            continue
        name = ".".join(mods + ["weight" if leaf == "kernel" else leaf])
        if leaf == "kernel":
            a = a.T if a.ndim == 2 else a.transpose(3, 2, 0, 1)
        out[name] = a
    for cell, leaves in cells.items():
        try:
            gates = lambda side, leaf: np.concatenate(
                [leaves.pop((side + g, leaf)).T if leaf == "kernel"
                 else leaves.pop((side + g, leaf)) for g in _LSTM_GATES],
                axis=0)
            pre = ".".join(cell) + "."
            out[pre + "weight_ih"] = gates("i", "kernel")
            out[pre + "weight_hh"] = gates("h", "kernel")
            out[pre + "bias_hh"] = gates("h", "bias")
        except KeyError as e:
            raise ValueError(f"{'/'.join(cell)}: missing LSTM leaf {e}")
        if leaves:
            raise ValueError(f"{'/'.join(cell)}: extra LSTM leaves "
                             f"{sorted(leaves)}")
    want = module.state_dict()
    missing = sorted(set(want) - set(out))
    extra = sorted(set(out) - set(want))
    if missing or extra:
        raise ValueError(f"flax tree and module differ: missing {missing}, "
                         f"extra {extra}")
    for k, a in out.items():
        if tuple(a.shape) != tuple(want[k].shape):
            raise ValueError(f"{k}: flax shape {a.shape}, module "
                             f"{tuple(want[k].shape)}")
    module.load_state_dict({k: torch.tensor(a) for k, a in out.items()})
    return module
