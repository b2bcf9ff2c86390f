"""Storage layer: the share of the traced window (%) in which nothing
runs on the card and the innermost open span is the program's
ddb.storage.* (a table batch built and uploaded, a result materialised
as a host table).  Moves queries_per_s."""

from portbench.spans import idle_pct


def read(t):
    return idle_pct(t, "storage")
