"""The whole fused step's share of the chip: the frozen bound of one step
(the sum of the bounds of the kernels a step needs today, K1 and K2, each
once a step) times the steps the traced window ran, over the window's
length. It reads the steps the loop counted and not the kernels that
launched, so it still bounds a claim after a later change fuses, renames
or removes a kernel."""


def read(record):
    bounds = record.get("bounds", {})
    if not bounds or not record.get("steps") or \
            record.get("window_ms", 0) <= 0:
        return None
    return 100.0 * sum(bounds.values()) * record["steps"] / \
        record["window_ms"]
