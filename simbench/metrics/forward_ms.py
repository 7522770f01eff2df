"""The device ms an iteration of the update's minibatch forwards
(learn/ppo.py ``update``: the gather, ``obs_from`` and ``ppo_loss``): the
CUDA events of the program's ``ppo.forward`` spans, summed over the
traced iterations."""
from simbench.metrics.program_spans import device_ms_an_iteration


def read(record):
    return device_ms_an_iteration(record, "ppo.forward")
