"""Frozen counts of the work the program's kernels must do, computed from
the cell's inputs through the reference (never through the program), and
the card's published peaks."""
