"""The device ms an iteration of the gradients' exchange across the ranks
(learn/ppo.py ``pmean_grads_``: the all-reduce and the division by the
world size, the wait for the slowest rank included): the CUDA events of
the program's ``ppo.allreduce`` spans on the harness's rank, summed over
the traced iterations."""
from simbench.metrics.program_spans import device_ms_an_iteration


def read(record):
    return device_ms_an_iteration(record, "ppo.allreduce")
