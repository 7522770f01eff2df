"""The blob render's (K2, csrc/blob_render.cu) share of its roofline: its
frozen bound (counts/k2.py: bytes and instructions over the published
peaks) over its device ms a launch in the trace."""
from simbench.metrics import roofline


def read(record):
    return roofline(record, "blob_render_kernel")
