"""Faults planted under a loop's timed path, for the tests that show a
run with one reads ``correct`` false and for the calibration of a
training cell's upper readings (``python -m simbench.calibrate --fault``).
Never used by a benchmark run.

Each fault is a context manager that replaces one function of the program
and restores it on exit:

- ``unchanged``: the step returns the state it was given;
- ``half_batch``: the step leaves out the second half of the batch (those
  envs keep their state; in PPO the loss is the mean over the first half
  of each minibatch);
- ``altered``: one answer is altered where it is produced (one byte of the
  frames).
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _replaced(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def _bump(frames):
    out = frames.clone()
    flat = out.view(-1)
    flat[flat.numel() // 2] += 1
    return out


def rollout_fault(name):
    from dtown_torch.ops import state_kernel as sk
    from dtown_torch.render import blob_raster as br

    if name == "unchanged":
        return _replaced(sk, "state_step",
                         lambda f: lambda blob, a, dev: blob.clone())
    if name == "half_batch":
        def make(f):
            def step(blob, a, dev):
                out = f(blob, a, dev).clone()
                h = blob.shape[1] // 2
                out[:, h:] = blob[:, h:]
                return out
            return step
        return _replaced(sk, "state_step", make)
    if name == "altered":
        return _replaced(br, "render_frames_from_blob",
                         lambda f: lambda blob, pk: _bump(f(blob, pk)))
    raise KeyError(name)


def ppo_fault(name):
    import torch
    from dtown_torch.learn import ppo as P

    if name == "unchanged":
        return _replaced(torch.optim.Adam, "step",
                         lambda f: lambda self, *a, **k: None)
    if name == "half_batch":
        def make(f):
            def loss(net, batch, ppo):
                h = batch["logp"].shape[0] // 2
                return f(net, {k: (v[:h] if not isinstance(v, tuple)
                                   else tuple(x[:h] for x in v))
                               for k, v in batch.items()}, ppo)
            return loss
        return _replaced(P, "ppo_loss", make)
    raise KeyError(name)


# the faults each loop's cells can have (a training step has no single
# answer to alter; no cell spans chips, so none leaves out an exchange)
FAULTS = {"fused_rollout": (rollout_fault, ("unchanged", "half_batch",
                                            "altered")),
          "ppo": (ppo_fault, ("unchanged", "half_batch"))}


def plant(loop, name):
    """The context manager of fault ``name`` under ``loop``'s path."""
    make, names = FAULTS[loop]
    if name not in names:
        raise KeyError(f"{loop} has no fault {name!r}")
    return make(name)
