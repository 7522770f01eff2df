"""The state step's (K1, csrc/state_kernel.cu) share of its roofline: its
bytes read and written once (counts/k1.py) over the published HBM rate,
against its device ms a launch in the trace."""
from simbench.metrics import roofline


def read(record):
    return roofline(record, "state_step_kernel")
