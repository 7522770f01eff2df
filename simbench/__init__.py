"""simbench: the benchmark of dtown_torch, the PyTorch and CUDA port.

``python -m simbench.run --workload <config>.<traffic> --seed N --seconds S
--trace 0|1`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line. Everything that belongs to one configuration, one
traffic mix or one per-layer metric sits in a file of its own, found by
name: ``configs/<config>.json``, ``traffic/<traffic>.json`` (whose
``loop`` names ``loops/<loop>.py``), ``metrics/<metric>.py``. The
yardstick (counts, peaks, the plain reference) lives here too, so the
program under test cannot move it.
"""
