"""Client API layer: the share of the traced window (%) in which nothing
runs on the card and the innermost open span is the program's ddb.api.*
(Connection.execute outside its parse, plan and operators; a result's
copy to the host and its decode).  Moves queries_per_s."""

from portbench.spans import idle_pct


def read(t):
    return idle_pct(t, "api")
