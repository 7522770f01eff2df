"""The PPO iteration's share of the card's dense bf16 peak: the
NatureCNN's FLOPs from the configuration's shapes (counts/policy.py: the
rollout's forward, the update's 3 x forward over each epoch) over the
traced iterations, over the traced window, over 989e12 FLOP/s (in %)."""
from simbench.counts.peaks import PEAK_BF16


def read(record):
    if "flops" not in record or record.get("window_ms", 0) <= 0:
        return None
    return 100.0 * record["flops"] / (record["window_ms"] / 1e3) / PEAK_BF16
