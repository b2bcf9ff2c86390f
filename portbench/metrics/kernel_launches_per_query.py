"""Executor layer: CUDA kernels launched in the traced window over the
requests it completed (launches/query).  Moves queries_per_s: eager torch
pays a launch and a host round of dispatch for every pass over memory."""

from portbench.trace import Trace


def read(t: Trace):
    kernels = t.inside(t.kernels)
    if not kernels or not t.queries:
        return None
    return len(kernels) / t.queries
