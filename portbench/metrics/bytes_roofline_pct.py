"""Operators and kernels layer: the least time the window's requests
could take on HBM, over the time kernels were running (%).

The least time is the bytes every request must move (each column it
names read once, its result written once: traffic/<mix>.json's "reads"
and "result_row_bytes", rows of the generated tables) over the card's
peak bandwidth (peaks.json).  The kernel time is the union of the kernel
intervals in the traced window.  Moves queries_per_s."""

from portbench.trace import Trace, covered_us


def read(t: Trace):
    kernel_us = covered_us(t.inside(t.kernels))
    if not kernel_us or not t.min_bytes or not t.peak_bytes_per_s:
        return None
    return 100.0 * (t.min_bytes / t.peak_bytes_per_s) / (kernel_us / 1e6)
