"""Named spans of the program's host work, on the profiler's clock.

`span(name)` is `torch.profiler.record_function(name)` while a torch
profiler records, and one shared no-op context otherwise.  The check
costs well under a microsecond; `record_function` costs about ten even
with nothing recording, so it is entered only when something records.
No setting turns spans on: a running profiler does.

A span is a `with` block on the calling thread.  It nests inside its
caller and never straddles a `yield`, so the spans of one thread form a
tree whose siblings do not overlap.

Names are `ddb.<layer>.<what>`, the layer one of `api` (the client
API), `frontend` (parse, plan, bind, optimise), `exec` (one span an
operator, named by its logical node) and `storage` (uploads of table
batches, results materialised as tables).  A traced run splits the
device's idle time by the layer of the innermost span open at each
moment, so the second part of the name is a contract.
"""

from __future__ import annotations

import contextlib

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

_NOTHING = contextlib.nullcontext()


def span(name: str):
    """A context that records `name` while a torch profiler records."""
    if _profiler_enabled():
        return record_function(name)
    return _NOTHING
