"""Static value-bound (interval) analysis over bound plans.

Used to decide, at trace time, whether an integer/decimal SUM can be
accumulated in a single int64 lane or needs two-limb (i128-style)
accumulation for exactness — the TPU-native analog of the reference's
always-hugeint decimal sum states (reference:
extension/core_functions/aggregate/distributive/sum.cpp,
src/common/types/hugeint.cpp).  DuckDB pays the 128-bit cost on every row;
we instead prove most sums can't overflow (zone-map min/max propagated
through expression intervals, reference: src/storage/statistics/ and
src/optimizer/statistics_propagator.cpp) and fall back to limb pairs only
when the proof fails.

All bounds are on RAW PHYSICAL values (decimals as scaled ints), matching
what the kernels actually accumulate.  A bound of None means "unknown".
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..expr import ir
from .. import types as T
from ..types import TypeId
from . import logical as L

Bound = Optional[Tuple[float, float]]   # (lo, hi) inclusive, raw physical


def _stat_bound(col) -> Bound:
    s = col.stats
    if s.min is None or s.max is None:
        return None
    t = col.dtype
    if not (t.is_integer or t.id in (TypeId.DECIMAL, TypeId.DATE,
                                     TypeId.TIME, TypeId.TIMESTAMP,
                                     TypeId.BOOLEAN, TypeId.VARCHAR)):
        return None
    try:
        return (float(s.min), float(s.max))
    except (TypeError, ValueError):
        return None


def node_bounds(node: L.LogicalNode) -> List[Bound]:
    """Per-output-column raw-value bounds; None where unknown."""
    if isinstance(node, L.Get):
        out = []
        for i in node.column_indices:
            out.append(_stat_bound(node.table.columns[i]))
        return out
    if isinstance(node, (L.Filter, L.Order, L.Limit, L.Sample,
                         L.Distinct)):
        return node_bounds(node.child)
    if isinstance(node, L.Project):
        child = node_bounds(node.child)
        return [expr_bounds(e, child) for e in node.exprs]
    if isinstance(node, L.Join):
        lb = node_bounds(node.left)
        rb = node_bounds(node.right)
        n_out = len(node.schema)
        out = (lb + rb)[:n_out]
        while len(out) < n_out:
            out.append(None)       # mark column etc.
        return out
    if isinstance(node, L.CrossProduct):
        lb = node_bounds(node.left)
        rb = node_bounds(node.right)
        return (lb + rb)[:len(node.schema)]
    if isinstance(node, L.Aggregate):
        child = node_bounds(node.child)
        out = [expr_bounds(g, child) for g in node.groups]
        for a in node.aggs:
            if a.kind in ("min", "max", "any_value") and a.arg is not None:
                out.append(expr_bounds(a.arg, child))
            else:
                out.append(None)
        return out[:len(node.schema)]
    # window/union/cte/... : conservative
    return [None] * len(node.schema)


def expr_bounds(e: ir.Expr, cols: List[Bound]) -> Bound:
    if isinstance(e, ir.ColRef):
        if e.index < len(cols):
            return cols[e.index]
        return None
    if isinstance(e, ir.Const):
        if e.value is None:
            return (0.0, 0.0)
        try:
            v = float(e.value)
        except (TypeError, ValueError):
            return None
        return (v, v)
    if isinstance(e, ir.Cast):
        b = expr_bounds(e.child, cols)
        if b is None:
            return None
        src, dst = e.src, e.dtype
        lo, hi = b
        # mirror expr/compile.py _cast_data raw-value semantics
        if src.id == TypeId.DECIMAL and dst.id == TypeId.DECIMAL:
            f = 10.0 ** (dst.scale - src.scale)
            return (lo * f, hi * f) if f >= 1 else (lo * f - 1, hi * f + 1)
        if dst.id == TypeId.DECIMAL and src.is_integer:
            f = 10.0 ** dst.scale
            return (lo * f, hi * f)
        if dst.id == TypeId.DECIMAL and src.id in (TypeId.FLOAT,
                                                   TypeId.DOUBLE):
            f = 10.0 ** dst.scale
            return (lo * f - 1, hi * f + 1)
        if src.id == TypeId.DECIMAL and dst.id in (TypeId.FLOAT,
                                                   TypeId.DOUBLE):
            f = 10.0 ** src.scale
            return (lo / f, hi / f)
        if src.id == TypeId.DECIMAL and dst.is_integer:
            f = 10.0 ** src.scale
            return (lo / f - 1, hi / f + 1)
        if src.id == TypeId.DATE and dst.id == TypeId.TIMESTAMP:
            return (lo * 86_400_000_000.0, hi * 86_400_000_000.0)
        return (lo, hi)
    if isinstance(e, ir.Arith):
        lb = expr_bounds(e.left, cols)
        rb = expr_bounds(e.right, cols)
        if lb is None or rb is None:
            return None
        (a, b), (c, d) = lb, rb
        if e.op == "+":
            return (a + c, b + d)
        if e.op == "-":
            return (a - d, b - c)
        if e.op == "*":
            prods = (a * c, a * d, b * c, b * d)
            return (min(prods), max(prods))
        if e.op == "/":
            return None          # binds to double anyway
        if e.op in ("//", "%"):
            m = max(abs(a), abs(b))
            return (-m, m)
        return None
    if isinstance(e, ir.Case):
        acc = expr_bounds(e.else_, cols)
        if acc is None:
            return None
        lo, hi = acc
        for _, v in e.whens:
            vb = expr_bounds(v, cols)
            if vb is None:
                return None
            lo, hi = min(lo, vb[0]), max(hi, vb[1])
        return (lo, hi)
    if isinstance(e, ir.Func):
        if e.name == "abs":
            b = expr_bounds(e.args[0], cols)
            if b is None:
                return None
            lo, hi = b
            return (0.0, max(abs(lo), abs(hi)))
        if e.name in ("coalesce", "least", "greatest", "ifnull"):
            lo = hi = None
            for a in e.args:
                ab = expr_bounds(a, cols)
                if ab is None:
                    return None
                lo = ab[0] if lo is None else min(lo, ab[0])
                hi = ab[1] if hi is None else max(hi, ab[1])
            return (lo, hi)
        return None
    if isinstance(e, (ir.Cmp, ir.BoolOp, ir.Not, ir.IsNull, ir.InList)):
        return (0.0, 1.0)
    return None


# one int64 lane can absorb `cap` addends of magnitude `m` iff cap*m < 2^62
_NARROW_LIMIT = float(2 ** 62)


def sum_fits_int64(bound: Bound, capacity: int) -> bool:
    """True if an int64 accumulator provably cannot overflow when summing
    up to `capacity` values within `bound`."""
    if bound is None:
        return False
    m = max(abs(bound[0]), abs(bound[1]))
    return m * float(capacity) < _NARROW_LIMIT


def pred_maybe_true(e: ir.Expr, cols: List[Bound],
                    nullable: Optional[List[Optional[bool]]] = None) -> bool:
    """Can this boolean filter be TRUE for ANY row whose column values
    fall inside `cols` (per-column (lo, hi) bounds, None = unknown)?

    Used for per-row-group zone-map scan skipping (reference: the
    segment-level CheckZonemap in
    src/storage/table/column_segment.cpp / table filters) — must only
    return False when the predicate is provably never TRUE over the
    group (never-true includes NULL results: SQL filters drop them).
    `nullable[i]` = does column i contain NULLs here (None = unknown).
    """
    if isinstance(e, ir.BoolOp):
        if e.op == "and":
            return all(pred_maybe_true(a, cols, nullable) for a in e.args)
        return any(pred_maybe_true(a, cols, nullable) for a in e.args)
    if isinstance(e, ir.Cmp):
        lb = expr_bounds(e.left, cols)
        rb = expr_bounds(e.right, cols)
        if lb is None or rb is None:
            return True
        (a, b), (c, d) = lb, rb
        if e.op == "==":
            return b >= c and a <= d
        if e.op == "!=":
            return not (a == b == c == d)
        if e.op == "<":
            return a < d
        if e.op == "<=":
            return a <= d
        if e.op == ">":
            return b > c
        if e.op == ">=":
            return b >= c
        return True
    if isinstance(e, ir.InList):
        if e.negated:
            return True
        cb = expr_bounds(e.child, cols)
        if cb is None:
            return True
        lo, hi = cb
        try:
            return any(lo <= float(v) <= hi for v in e.values)
        except (TypeError, ValueError):
            return True
    if isinstance(e, ir.IsNull) and isinstance(e.child, ir.ColRef) \
            and nullable is not None and e.child.index < len(nullable):
        n = nullable[e.child.index]
        if n is None or e.negated:
            # IS NOT NULL: we track has-nulls, not all-nulls -> can't prune
            return True
        return bool(n)
    if isinstance(e, ir.Const):
        return bool(e.value)
    return True
