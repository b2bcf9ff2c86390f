"""Front end layer: the share (%) of the traced window's plans that the
program's plan cache gave back: ddb.frontend.plan spans that hold no
ddb.frontend.bind, over all of them.  Moves queries_per_s: a miss binds
and optimises on the host while the card waits."""

from portbench.spans import plan_cache_hit_pct


def read(t):
    return plan_cache_hit_pct(t)
