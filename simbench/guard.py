"""The check that the harness runs without JAX or the JAX package."""
from __future__ import annotations

import sys

# top-level module names that may not be loaded in a benchmark process;
# compared whole, so the port ``dtown_torch`` is not ``dtown``
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chex", "orbax", "dtown")


def forbidden_modules(names=None):
    """Sorted top-level names among ``names`` (default: sys.modules) that
    are FORBIDDEN, each compared whole (the part before the first dot)."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))
