"""Per-layer metrics, one reader a module, found by the metric's name in
BENCHMARK.json: ``<name>.py``, or, where there is none, the module of the
name's part before its first dot (``idle_share.train`` is read by
``idle_share.py``). BENCHMARK.json states the end-to-end metric each
moves. A reader has ``read(record)``, which takes the traced record of a
``--trace 1`` run (``trace.profile``'s dict plus the loop's fields) and
returns the metric's value, or None when the record has nothing to read:
the harness then leaves the metric out of the line."""


def kernel(record, name):
    """(device ms a launch, launches) of the traced kernels whose name
    holds ``name``, or None when none ran."""
    ms = n = 0
    for key, (t, count) in record.get("kernels", {}).items():
        if name in key:
            ms, n = ms + t, n + count
    return (ms / n, n) if n else None


def roofline(record, name):
    """A kernel's share (%) of its roofline: its frozen bound a launch over
    its device ms a launch; None without the kernel or its bound."""
    got = kernel(record, name)
    bound = record.get("bounds", {}).get(name)
    if got is None or bound is None or got[0] <= 0:
        return None
    return 100.0 * bound / got[0]


def idle(record):
    """The device's idle share (%) of the traced window: 1 - busy /
    window, busy being the kernels' summed self device time (the rule of
    chip_smoke.py's profile_window); None without a trace."""
    w = record.get("window_ms", 0.0)
    if w <= 0 or not record.get("kernels"):
        return None
    return 100.0 * (1.0 - record["busy_ms"] / w)
