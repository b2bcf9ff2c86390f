"""Executor layer: the share of the traced window (%) in which nothing
runs on the card and the innermost open span is the program's ddb.exec.*
(one span an operator: its Python dispatch and the host waits inside
it).  Moves queries_per_s."""

from portbench.spans import idle_pct


def read(t):
    return idle_pct(t, "exec")
