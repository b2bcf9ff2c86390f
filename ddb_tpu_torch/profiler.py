"""Query profiling (reference: src/main/query_profiler.hpp:124,
per-operator timing in parallel/pipeline_executor.cpp Start/EndOperator).

Collects per-operator wall time + output cardinality during execution and
renders an EXPLAIN ANALYZE tree.  Timing forces device sync per operator
(block on the batch count), so profiled runs are slightly slower — same
trade as the reference's profiler.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class OperatorProfile:
    name: str
    node_id: int
    seconds: float = 0.0
    cardinality: int = -1
    extra: str = ""


class QueryProfiler:
    def __init__(self):
        self.profiles: Dict[int, OperatorProfile] = {}
        self.order: List[int] = []
        self.total: float = 0.0

    @contextmanager
    def operator(self, name: str, node):
        nid = id(node)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            p = self.profiles.get(nid)
            if p is None:
                p = OperatorProfile(name, nid)
                self.profiles[nid] = p
                self.order.append(nid)
            # children time is nested inside; subtract below at render
            p.seconds += dt

    def record_cardinality(self, node, batch):
        import numpy as np
        p = self.profiles.get(id(node))
        if p is not None:
            p.cardinality = int(batch.count)   # forces device sync

    def render(self, plan) -> str:
        from .plan import logical as L
        lines = []

        def self_time(node):
            p = self.profiles.get(id(node))
            if p is None:
                return 0.0, -1
            child_t = sum(self.profiles.get(id(c),
                                            OperatorProfile("", 0)).seconds
                          for c in node.children())
            return max(p.seconds - child_t, 0.0), p.cardinality

        def walk(node, depth):
            t, card = self_time(node)
            name = type(node).__name__
            detail = ""
            if isinstance(node, L.Get):
                detail = f" {node.table.name}"
                if node.filters:
                    detail += f" [{len(node.filters)} filters]"
            elif isinstance(node, L.Join):
                detail = f" ({node.join_type})"
            elif isinstance(node, L.Aggregate):
                detail = f" [{len(node.groups)} keys, " \
                         f"{len(node.aggs)} aggs]"
            lines.append(f"{'  ' * depth}{name}{detail}  "
                         f"({t*1000:.1f} ms, {card} rows)")
            for c in node.children():
                walk(c, depth + 1)

        walk(plan, 0)
        return "\n".join(lines)
