"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit) and the least time for a count of work."""

PEAK_BYTES = 3.35e12       # HBM3 bytes/s
PEAK_F32 = 67e12           # float32 FLOP/s outside the tensor cores (FMA = 2)
# The port's kernels build with -fmad=false, so every add or multiply is an
# instruction of its own: the float32 lanes issue PEAK_F32 / 2 of them a
# second, and integer, compare and select instructions run on lanes no wider.
PEAK_INSTR = PEAK_F32 / 2
PEAK_BF16 = 989e12         # dense bf16 tensor-core FLOP/s


def bound_ms(nbytes, ninstr):
    """The least time (ms) for nbytes of traffic and ninstr instructions."""
    return max(nbytes / PEAK_BYTES, ninstr / PEAK_INSTR) * 1e3
