"""What the readers of the program's own spans share. The program
(dtown_torch.utils.profiling) records its spans while a torch profiler
records, so the store read after a ``--trace 1`` run holds the traced
window's. A program without the store, or a store without the span,
gives None: the harness then leaves the metric out of the line."""
import statistics


def _spans():
    from dtown_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return read() if read is not None else []


def host_us_median(name):
    """The median host us of the spans named ``name``, or None."""
    us = [(s.end_ns - s.start_ns) / 1e3 for s in _spans() if s.name == name]
    return statistics.median(us) if us else None


def device_ms_an_iteration(record, name):
    """The device ms of the spans named ``name`` (their CUDA events)
    summed over the traced window, over its iterations; or None."""
    ms = [s.device_ms for s in _spans() if s.name == name]
    if not ms or None in ms or not record.get("iterations"):
        return None
    return sum(ms) / record["iterations"]
