"""Device layer: the share of the traced window in which no kernel, copy
or memset ran on the card (%).  Moves queries_per_s: what the host holds
back."""

from portbench.trace import Trace, device_busy_us


def read(t: Trace):
    if not t.kernels:
        return None
    return 100.0 * (1.0 - device_busy_us(t) / (t.window[1] - t.window[0]))
