"""The device ms an iteration of the update's backward passes
(learn/ppo.py ``update``: ``zero_grad`` and ``loss.backward()``): the CUDA
events of the program's ``ppo.backward`` spans, summed over the traced
iterations."""
from simbench.metrics.program_spans import device_ms_an_iteration


def read(record):
    return device_ms_an_iteration(record, "ppo.backward")
