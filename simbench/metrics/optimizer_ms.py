"""The device ms an iteration of the update's optimizer steps
(learn/ppo.py ``update``: the gradients' all-reduce when a group is
given, ``clip_by_global_norm_`` and Adam's ``step``): the CUDA events of
the program's ``ppo.optimizer`` spans, summed over the traced
iterations."""
from simbench.metrics.program_spans import device_ms_an_iteration


def read(record):
    return device_ms_an_iteration(record, "ppo.optimizer")
