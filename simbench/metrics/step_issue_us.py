"""The host's time to issue one fused step (ops/fused_env.py
``fused_step``, its span ``fused_step``): the median us of the traced
window's steps. It includes the span's own cost under the profiler."""
from simbench.metrics.program_spans import host_us_median


def read(record):
    return host_us_median("fused_step")
