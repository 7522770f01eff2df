"""The device's idle share of a cell's traced window (metrics.idle). It
serves every metric named ``idle_share`` or ``idle_share.<suffix>``: the
suffix only tells apart the end-to-end metric each moves, which
BENCHMARK.json states."""
from simbench.metrics import idle

read = idle
