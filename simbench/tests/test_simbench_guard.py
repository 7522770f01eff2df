"""The no-JAX check: whole top-level names, and a process that loads the
harness, its loops, the reference and the port holds none of them."""
import subprocess
import sys

from simbench import cells, guard


def test_whole_top_level_names():
    assert guard.forbidden_modules(["dtown_torch", "dtown_torch.env",
                                    "jaxtyping", "flaxen", "torch"]) == []
    assert guard.forbidden_modules(["dtown.env", "jax.numpy", "optax",
                                    "orbax.checkpoint", "chex", "jaxlib",
                                    "flax.linen"]) == sorted(
        ["dtown", "jax", "optax", "orbax", "chex", "jaxlib", "flax"])


def test_harness_loads_no_jax():
    code = (
        "import sys, importlib, pkgutil, simbench, simbench.loops\n"
        "import simbench.run, simbench.calibrate, simbench.faults\n"
        "for m in pkgutil.iter_modules(simbench.loops.__path__):\n"
        "    importlib.import_module('simbench.loops.' + m.name)\n"
        "import simbench.reference.fused, simbench.reference.learner\n"
        "import simbench.reference.town\n"
        "import simbench.reference.ppo, simbench.counts.k2\n"
        "import dtown_torch, dtown_torch.learn.ppo\n"
        "from simbench import cells, guard\n"
        "b = cells.load_benchmark()\n"
        "[cells.find(b, w['name']) for w in b['workloads']]\n"
        "print(guard.forbidden_modules())\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, simbench.reference.fused,"
            " simbench.reference.learner, simbench.reference.town,"
            " simbench.reference.ppo, simbench.counts.k2,"
            " simbench.counts.policy\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'dtown_torch', 'dtown', 'jax'}))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"
