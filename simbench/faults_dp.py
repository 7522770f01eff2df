"""Faults of the data-parallel loop (loops/ppo_dp.py), planted in every
rank. Like faults.py's, they serve the tests that show a run with one
reads ``correct`` false and the calibration of the cell's limits
(``python -m simbench.calibrate --workload <cell> --fault <name>``); a
benchmark run never plants one.

- ``unchanged`` and ``half_batch``: faults.py's PPO faults;
- ``no_exchange``: ``pmean_grads_`` does nothing, so each rank steps on
  its own gradient.

Importing this module adds the loop's entry to ``faults.FAULTS``. The
fault planted in the harness's process (rank 0) is named in the
environment variable ``SIMBENCH_DP_FAULT`` while it is planted, so the
ranks that the loop starts inherit it and plant it too
(``plant_from_environment``).
"""
from __future__ import annotations

import contextlib
import os

from simbench import faults

ENV = "SIMBENCH_DP_FAULT"
NAMES = ("unchanged", "half_batch", "no_exchange")


def _local(name):
    """The context manager of fault ``name`` in this process."""
    from dtown_torch.learn import ppo as P

    if name == "no_exchange":
        return faults._replaced(P, "pmean_grads_",
                                lambda f: lambda params, group: None)
    return faults.ppo_fault(name)


@contextlib.contextmanager
def dp_fault(name):
    """Fault ``name`` planted here and named to the ranks started while it
    is."""
    with _local(name):
        os.environ[ENV] = name
        try:
            yield
        finally:
            os.environ.pop(ENV, None)


def plant_from_environment(stack: contextlib.ExitStack):
    """In a rank the loop started: plant the fault the environment names,
    if any, for as long as ``stack`` is open."""
    name = os.environ.get(ENV)
    if name:
        if name not in NAMES:
            raise KeyError(f"ppo_dp has no fault {name!r}")
        stack.enter_context(_local(name))


faults.FAULTS["ppo_dp"] = (dp_fault, NAMES)
