"""The device ms an iteration of the rollout's policy forwards
(learn/ppo.py ``collect``: each ``net(obs_from(obs))``, the last value's
too): the CUDA events of the program's ``ppo.policy`` spans, summed over
the traced iterations."""
from simbench.metrics.program_spans import device_ms_an_iteration


def read(record):
    return device_ms_an_iteration(record, "ppo.policy")
