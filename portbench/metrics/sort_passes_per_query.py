"""Executor layer: the program's ddb.exec.sort spans in the traced
window over the requests it completed (passes/query).  Each span is one
torch.sort over a batch-length operand: an ORDER BY, a sort-based GROUP
BY, a holistic aggregate, a window or a join build takes one a word of
its packed key.  None where the program records no such span.  Moves
queries_per_s: each pass is a radix sort of the whole batch and a
gather after it."""

from portbench.trace import Trace

SORT = "ddb.exec.sort"


def read(t: Trace):
    passes = sum(1 for *_, name in t.inside(t.spans) if name == SORT)
    if not passes or not t.queries:
        return None
    return passes / t.queries
