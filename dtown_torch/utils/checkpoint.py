"""Checkpoint / resume of a whole training state, crash-safe.

Counterpart of dtown/utils/checkpoint.py with torch serialization in
place of orbax. A snapshot is one ``torch.save`` file of plain containers
(dicts, lists, tuples, numbers, strings) and tensors, so that
``torch.load(weights_only=True)`` reads it: networks and optimizers are
stored as their state dicts, generators as their states, dataclass and
NamedTuple states (EnvState, TrainState) as dicts of their fields, every
tensor on the CPU.

``save_atomic`` keeps the reference's directory scheme: rotating
``s%06d`` slots, each a directory holding one file, and a ``LATEST``
pointer flipped by ``os.replace`` only after the slot is complete, so a
kill at any instant leaves ``LATEST`` naming one intact snapshot.
"""
from __future__ import annotations

import dataclasses
import os
import re
import shutil

import torch

FILE = "state.pt"


def to_saved(tree):
    """``tree`` as the containers and CPU tensors a snapshot holds:
    nn.Module / Optimizer -> state_dict, Generator -> get_state(),
    dataclass -> dict of its fields, NamedTuple -> dict (``_asdict``),
    tensors detached to the CPU; dicts, lists and tuples recursively."""
    if isinstance(tree, (torch.nn.Module, torch.optim.Optimizer)):
        return to_saved(tree.state_dict())
    if isinstance(tree, torch.Generator):
        return tree.get_state()
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: to_saved(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_asdict"):
        return {k: to_saved(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: to_saved(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_saved(v) for v in tree)
    return tree


def load_into(template, saved):
    """``saved`` (to_saved's form) loaded into ``template``, which has the
    live objects: load_state_dict for networks and optimizers, set_state
    for generators, copy_ for tensors (the template keeps its device and
    dtype), field by field for dataclasses and NamedTuples. Returns the
    filled template (a new container where the template's is immutable);
    a number or string in the template takes the saved value."""
    if isinstance(template, (torch.nn.Module, torch.optim.Optimizer)):
        template.load_state_dict(saved)
        return template
    if isinstance(template, torch.Generator):
        # a copy at offset 0: set_state reads a view into a larger
        # storage (a state saved beside others) from the storage's start
        template.set_state(saved.clone())
        return template
    if isinstance(template, torch.Tensor):
        if tuple(template.shape) != tuple(saved.shape):
            raise ValueError(f"checkpoint tensor of shape "
                             f"{tuple(saved.shape)} does not fit the "
                             f"template's {tuple(template.shape)}")
        with torch.no_grad():
            template.copy_(saved)
        return template
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return type(template)(**{
            f.name: load_into(getattr(template, f.name), saved[f.name])
            for f in dataclasses.fields(template)})
    if isinstance(template, tuple) and hasattr(template, "_asdict"):
        return type(template)(**{k: load_into(v, saved[k])
                                 for k, v in template._asdict().items()})
    if isinstance(template, dict):
        return {k: load_into(v, saved[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if len(template) != len(saved):
            raise ValueError(f"checkpoint sequence of {len(saved)} does not "
                             f"fit the template's {len(template)}")
        return type(template)(load_into(t, s)
                              for t, s in zip(template, saved))
    return saved


def save(path: str, tree):
    """Write ``tree`` (to_saved's form) as the snapshot directory ``path``:
    the file goes to a temporary name first and is renamed into place."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"{FILE}.{os.getpid()}.tmp")
    torch.save(to_saved(tree), tmp)
    os.replace(tmp, os.path.join(path, FILE))


def save_atomic(path: str, tree, keep: int = 2):
    """Crash-safe periodic save into the directory ``path``: a new
    rotating slot ``s%06d``, then ``LATEST`` flipped to it by an atomic
    ``os.replace``, then the oldest slots pruned so that ``keep`` remain
    (>= 1; never the new pointee). The slot numbering continues past the
    highest surviving slot even when ``LATEST`` was lost, so rotation and
    pruning keep their order. Legacy two-slot directories (``A``/``B``)
    keep working and rotate into the sequence."""
    base = os.path.abspath(path)
    os.makedirs(base, exist_ok=True)
    cur = _read_pointer(base)
    seq = 0
    if cur is not None:
        m = re.match(r"s(\d+)$", cur)
        seq = int(m.group(1)) + 1 if m else 1
    existing = [int(os.path.basename(d)[1:]) for d in slots(base)
                if re.match(r"s(\d+)$", os.path.basename(d))]
    if existing:
        seq = max(seq, max(existing) + 1)
    nxt = "s%06d" % seq
    save(os.path.join(base, nxt), tree)
    tmp = os.path.join(base, "LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(nxt)
    os.replace(tmp, os.path.join(base, "LATEST"))
    for d in slots(base)[:-max(1, int(keep))]:
        if os.path.basename(d) != nxt:
            shutil.rmtree(d, ignore_errors=True)


def slots(path: str):
    """Retained save_atomic snapshot directories, oldest first (legacy
    A/B slots by mtime, before the numbered sequence)."""
    base = os.path.abspath(path)
    if not os.path.isdir(base):
        return []
    legacy, seq = [], []
    for name in os.listdir(base):
        full = os.path.join(base, name)
        if not os.path.isdir(full):
            continue
        if re.match(r"s(\d+)$", name):
            seq.append(full)
        elif name in ("A", "B"):
            legacy.append(full)
    legacy.sort(key=os.path.getmtime)
    seq.sort(key=lambda d: int(os.path.basename(d)[1:]))
    return legacy + seq


def _read_pointer(base: str):
    p = os.path.join(base, "LATEST")
    if os.path.exists(p):
        with open(p) as f:
            return f.read().strip()
    return None


def resolve(path: str) -> str:
    """The snapshot directory behind ``path``: the slot a save_atomic
    ``LATEST`` names, or ``path`` itself (a slot, or a plain ``save``)."""
    base = os.path.abspath(path)
    cur = _read_pointer(base)
    return os.path.join(base, cur) if cur else base


def _load(path: str, map_location):
    f = os.path.join(resolve(path), FILE)
    if not os.path.exists(f):
        raise FileNotFoundError(f"no checkpoint at {path} ({f})")
    return torch.load(f, weights_only=True, map_location=map_location)


def restore(path: str, template, map_location=None):
    """The snapshot at ``path`` loaded into ``template`` (load_into)."""
    return load_into(template, _load(path, map_location or "cpu"))


def restore_any(path: str):
    """The snapshot at ``path`` as saved (to_saved's form), on the CPU:
    for offline tools that have no template (eval_policy)."""
    return _load(path, "cpu")
