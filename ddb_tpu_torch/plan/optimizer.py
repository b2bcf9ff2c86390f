"""Logical plan optimizer.

Covers the load-bearing subset of the reference's ~27 passes
(reference: src/optimizer/optimizer.cpp, pass list in
common/enums/optimizer_type.hpp:16-45):

* filter pushdown (reference: src/optimizer/pushdown/) — down through
  projections/joins into scans
* cross-product elimination + greedy join ordering (reference:
  src/optimizer/join_order/plan_enumerator.cpp — ours is greedy
  smallest-first rather than DP, upgraded later)
* scan column pruning (reference: remove_unused_columns.cpp)
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

from ..expr import ir
from ..types import TypeId
from . import logical as L


def optimize(plan: L.LogicalNode) -> L.LogicalNode:
    _optimize_materialized(plan, set())
    plan = push_filters(plan, [])
    plan = push_join_filters(plan)
    plan = prune_get_columns(plan)
    plan = push_limits(plan)
    plan = fuse_topn(plan)
    return plan


def _optimize_materialized(node: L.LogicalNode, seen: set) -> None:
    """Optimize each shared Materialize child exactly once, in place.
    The rewriting passes below treat Materialize as a leaf (they rebuild
    trees with copy.copy, which would clone a shared subtree apart and
    re-introduce the duplicate compile/execute work Materialize exists
    to remove)."""
    if id(node) in seen:
        return
    seen.add(id(node))
    if isinstance(node, L.Materialize):
        if not getattr(node, "_opt_done", False):
            node._opt_done = True
            node.child = optimize(node.child)
        return
    for c in node.children():
        _optimize_materialized(c, seen)


def push_limits(node: L.LogicalNode) -> L.LogicalNode:
    """Limit(Project(x)) -> Project(Limit(x)) so fewer rows are projected
    (reference: limit_pushdown.cpp).  Valid because our Project is pure
    per-row expressions."""
    if isinstance(node, L.Materialize):
        return node
    if isinstance(node, L.Limit) and isinstance(node.child, L.Project) \
            and node.limit is not None:
        proj = node.child
        inner = push_limits(L.Limit(proj.child, node.limit, node.offset,
                                    node.percent))
        return L.Project(inner, proj.exprs, proj.names, proj.schema)
    new = copy.copy(node)
    for attr in ("child", "left", "right", "base", "recursive"):
        if hasattr(new, attr):
            setattr(new, attr, push_limits(getattr(node, attr)))
    return new


def push_join_filters(node: L.LogicalNode) -> L.LogicalNode:
    """Zone-map join-filter pushdown (reference:
    join_filter_pushdown_optimizer.cpp builds runtime min/max filters from
    the build side; our build-side min/max is already known at bind time
    from column statistics, so the probe-side range filter is static).
    For each equi-join condition whose build (right) side has provable
    bounds, add lo<=key<=hi to the probe (left) side and vice versa for
    join types where pre-filtering keeps semantics."""
    from . import bounds as PB

    if isinstance(node, L.Materialize):
        return node
    if isinstance(node, L.Join) and node.conds:
        left = push_join_filters(node.left)
        right = push_join_filters(node.right)
        jt = node.join_type
        # filtering the probe side is safe unless its unmatched rows
        # survive (left/full/anti/mark keep them)
        filt_left = jt in ("inner", "right", "semi")
        filt_right = jt in ("inner", "left", "semi", "anti", "mark")
        lpreds, rpreds = [], []
        try:
            lb = PB.node_bounds(left)
            rb = PB.node_bounds(right)
            for c in node.conds:
                lt = c.left.dtype
                if not (lt.is_integer or lt.id in (
                        TypeId.DECIMAL, TypeId.DATE, TypeId.VARCHAR)):
                    continue
                if filt_left:
                    b = PB.expr_bounds(c.right, rb)
                    sb = PB.expr_bounds(c.left, lb)
                    if b is not None and (
                            sb is None or sb[0] < b[0] or sb[1] > b[1]):
                        lpreds.append(_range_pred(c.left, b))
                if filt_right:
                    b = PB.expr_bounds(c.left, lb)
                    sb = PB.expr_bounds(c.right, rb)
                    if b is not None and (
                            sb is None or sb[0] < b[0] or sb[1] > b[1]):
                        rpreds.append(_range_pred(c.right, b))
        except Exception:
            lpreds, rpreds = [], []
        if lpreds:
            left = push_filters(left, lpreds)
        if rpreds:
            right = push_filters(right, rpreds)
        return L.Join(left, right, node.join_type, node.conds, node.extra,
                      node.mark_name, node.range_cond, node.asof,
                      node.mark_in)
    new = copy.copy(node)
    for attr in ("child", "left", "right", "base", "recursive"):
        if hasattr(new, attr):
            setattr(new, attr, push_join_filters(getattr(node, attr)))
    return new


def _range_pred(key: ir.Expr, b) -> ir.Expr:
    lo, hi = int(b[0]), int(b[1])
    t = key.dtype
    return ir.BoolOp("and", [
        ir.Cmp(">=", key, ir.Const(lo, t)),
        ir.Cmp("<=", key, ir.Const(hi, t))])


# max rows a TopN keeps; beyond this the full sort is just as good
TOPN_MAX = 1 << 14


def fuse_topn(node: L.LogicalNode) -> L.LogicalNode:
    """Limit(Order(x)) -> TopN(x) (reference: topn_optimizer.cpp).  The
    payload columns then skip the sort entirely (keys+rowid sort + small
    gather, ops design in physical._exec_topn)."""
    if isinstance(node, L.Materialize):
        return node
    if isinstance(node, L.Limit) and isinstance(node.child, L.Order) \
            and node.limit is not None \
            and 0 < node.limit + node.offset <= TOPN_MAX:
        inner = fuse_topn(node.child.child)
        return L.TopN(inner, node.child.keys, node.limit, node.offset)
    new = copy.copy(node)
    for attr in ("child", "left", "right", "base", "recursive"):
        if hasattr(new, attr):
            setattr(new, attr, fuse_topn(getattr(node, attr)))
    return new


# ---------------------------------------------------------------------------
# filter pushdown + join building
# ---------------------------------------------------------------------------

def _cols_of(e: ir.Expr) -> List[int]:
    return ir.referenced_columns(e)


def _wrap(plan: L.LogicalNode, preds: List[ir.Expr]) -> L.LogicalNode:
    p = ir.make_and(preds)
    return L.Filter(plan, p) if p is not None else plan


def push_filters(node: L.LogicalNode, preds: List[ir.Expr]
                 ) -> L.LogicalNode:
    if isinstance(node, L.Materialize):
        return _wrap(node, preds)    # shared barrier: keep identity

    if isinstance(node, L.Filter):
        return push_filters(node.child,
                            preds + ir.conjuncts(node.predicate))

    if isinstance(node, L.Project):
        # rewrite predicates through the projection and keep pushing
        pushable = [_substitute(p, {i: node.exprs[i]
                                    for i in _cols_of(p)})
                    for p in preds]
        child = push_filters(node.child, pushable)
        return L.Project(child, node.exprs, node.names, node.schema)

    if isinstance(node, L.CrossProduct):
        return _build_joins(node, preds)

    if isinstance(node, L.Join):
        nl = len(node.left.schema)
        jt = node.join_type
        # which sides can absorb predicates without changing outer-join
        # semantics (NULL-extended rows must not be pre-filtered)
        push_left = jt in ("inner", "left", "semi", "anti", "mark")
        push_right = jt in ("inner", "right")
        lpreds, rpreds, stay = [], [], []
        for p in preds:
            cols = _cols_of(p)
            if push_left and all(c < nl for c in cols):
                lpreds.append(p)
            elif push_right and cols and all(c >= nl for c in cols):
                rpreds.append(ir.remap_columns(
                    p, {c: c - nl for c in cols}))
            else:
                stay.append(p)
        left = push_filters(node.left, lpreds)
        right = push_filters(node.right, rpreds)
        nj = L.Join(left, right, node.join_type, node.conds, node.extra,
                    node.mark_name, node.range_cond, node.asof,
                    node.mark_in)
        return _wrap(nj, stay)

    if isinstance(node, L.Order):
        return L.Order(push_filters(node.child, preds), node.keys)

    if isinstance(node, L.Get):
        scan_filters = list(node.filters) + preds
        return L.Get(node.table, node.column_indices, scan_filters)

    if isinstance(node, (L.Limit, L.Distinct, L.Aggregate, L.Union)):
        # recurse into children without crossing the boundary
        new = copy.copy(node)
        if isinstance(node, L.Union):
            new.left = push_filters(node.left, [])
            new.right = push_filters(node.right, [])
        else:
            new.child = push_filters(node.child, [])
        return _wrap(new, preds)

    # default: optimize children, keep preds here
    new = copy.copy(node)
    for attr in ("child", "left", "right", "base", "recursive"):
        if hasattr(new, attr):
            setattr(new, attr, push_filters(getattr(node, attr), []))
    return _wrap(new, preds)


def _substitute(e: ir.Expr, mapping: Dict[int, ir.Expr]) -> ir.Expr:
    if isinstance(e, ir.ColRef):
        return mapping.get(e.index, e)
    c = copy.copy(e)
    if isinstance(e, ir.Case):
        c.whens = [(_substitute(w, mapping), _substitute(v, mapping))
                   for w, v in e.whens]
        c.else_ = _substitute(e.else_, mapping)
        return c
    for attr in ("child", "left", "right"):
        if hasattr(e, attr):
            setattr(c, attr, _substitute(getattr(e, attr), mapping))
    if hasattr(e, "args") and not isinstance(e, ir.Case):
        c.args = tuple(_substitute(a, mapping) for a in e.args)
    return c


def _flatten_cross(node: L.LogicalNode) -> List[L.LogicalNode]:
    if isinstance(node, L.CrossProduct):
        return _flatten_cross(node.left) + _flatten_cross(node.right)
    return [node]


def _col_ndv(tc) -> Optional[float]:
    """Distinct-count estimate for a base-table column from its stats."""
    s = tc.stats
    if s.distinct_hint:
        return float(s.distinct_hint)
    if s.min is not None and s.max is not None and tc.dtype.is_integer:
        return float(max(int(s.max) - int(s.min) + 1, 1))
    return None


def _pred_selectivity(get: "L.Get", p: ir.Expr) -> float:
    """Stats-based selectivity of one pushed-down scan filter
    (reference: optimizer/statistics_propagator.cpp — ours is the
    min/max/ndv subset needed for join ordering)."""
    if isinstance(p, ir.Cmp):
        col, const, op = None, None, p.op
        if isinstance(p.left, ir.ColRef) and isinstance(p.right, ir.Const):
            col, const = p.left, p.right
        elif isinstance(p.right, ir.ColRef) and isinstance(p.left,
                                                           ir.Const):
            col, const = p.right, p.left
            op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
        if col is not None and const is not None:
            tc = get.table.columns[get.column_indices[col.index]]
            s = tc.stats
            if op == "==":
                ndv = _col_ndv(tc)
                return 1.0 / ndv if ndv else 0.1
            if op == "!=":
                ndv = _col_ndv(tc)
                return 1.0 - 1.0 / ndv if ndv else 0.9
            if op in ("<", "<=", ">", ">=") and s.min is not None \
                    and const.value is not None:
                try:
                    lo, hi, v = float(s.min), float(s.max), \
                        float(const.value)
                except (TypeError, ValueError):
                    return 1.0 / 3.0
                if hi <= lo:
                    return 0.5
                frac = min(max((v - lo) / (hi - lo), 0.0), 1.0)
                return max(frac if op in ("<", "<=") else 1.0 - frac,
                           1e-4)
    if isinstance(p, ir.BoolOp) and p.op == "or":
        s = 0.0
        for a in p.args:
            s += _pred_selectivity(get, a)
        return min(s, 1.0)
    return 0.25


def _trace_to_get(node, idx):
    """Follow a column through Filter/Project chains to its base Get;
    returns (get, base_col_idx) or (None, None) — the spine of the
    statistics propagation (reference:
    optimizer/statistics_propagator.cpp walks operators the same way,
    carrying min/max/ndv)."""
    while True:
        if isinstance(node, L.Filter):
            node = node.child
            continue
        if isinstance(node, L.Project):
            e2 = node.exprs[idx]
            c2 = _cols_of(e2)
            if len(c2) != 1:
                return None, None
            idx = c2[0]
            node = node.child
            continue
        break
    if isinstance(node, L.Get):
        return node, idx
    return None, None


def _deep_selectivity(child, pred) -> float:
    """Stats-based selectivity of a predicate that was NOT pushed into
    a scan: trace its columns through Projects to the base table and
    reuse the scan-filter estimator against rewritten column refs."""
    cols = _cols_of(pred)
    if len(cols) != 1:
        return 0.25
    get, base_idx = _trace_to_get(child, cols[0])
    if get is None:
        return 0.25
    import copy as _copy

    def remap(e):
        if isinstance(e, ir.ColRef):
            if base_idx >= len(get.column_indices):
                return None
            return ir.ColRef(base_idx, e.dtype, e.name, e.strdict)
        c = _copy.copy(e)
        for attr in ("child", "left", "right"):
            if hasattr(e, attr) and getattr(e, attr) is not None:
                r = remap(getattr(e, attr))
                if r is None:
                    return None
                setattr(c, attr, r)
        if hasattr(e, "args"):
            rs = []
            for a in e.args:
                r = remap(a)
                if r is None:
                    return None
                rs.append(r)
            c.args = tuple(rs)
        return c

    p2 = remap(pred)
    if p2 is None:
        return 0.25
    try:
        return _pred_selectivity(get, p2)
    except Exception:
        return 0.25


def _estimate_rows(node: L.LogicalNode) -> float:
    if isinstance(node, L.Get):
        n = float(max(node.table.num_rows, 1))
        for f in node.filters:
            n *= _pred_selectivity(node, f)
        return max(n, 1.0)
    if isinstance(node, L.Filter):
        sel = 1.0
        for p in ir.conjuncts(node.predicate):
            sel *= _deep_selectivity(node.child, p)
        return max(_estimate_rows(node.child) * max(sel, 1e-4), 1.0)
    if isinstance(node, L.Aggregate):
        child_rows = _estimate_rows(node.child)
        if not node.groups:
            return 1.0
        # output cardinality = product of group-key distinct counts,
        # clamped by input rows (reference: statistics propagation
        # feeding RadixHT sizing)
        ndv = 1.0
        for g in node.groups:
            ndv *= max(_ndv(node.child, g), 1.0)
            if ndv >= child_rows:
                break
        return max(min(ndv, child_rows), 1.0)
    if isinstance(node, L.Join):
        lr = _estimate_rows(node.left)
        rr = _estimate_rows(node.right)
        if node.join_type in ("semi", "anti"):
            return max(lr * 0.5, 1.0)
        if node.join_type == "mark":
            return lr
        if node.conds:
            # |L||R| / max ndv over the equi keys (classic estimator;
            # reference: cardinality_estimator.cpp denominators)
            denom = 1.0
            for jc in node.conds:
                denom = max(denom,
                            min(_ndv(node.left, jc.left),
                                _ndv(node.right, jc.right)))
            est = lr * rr / max(denom, 1.0)
            if node.join_type in ("left", "full"):
                est = max(est, lr)
            if node.join_type in ("right", "full"):
                est = max(est, rr)
            return max(est, 1.0)
        return max(lr, rr)
    if isinstance(node, L.Limit):
        base = _estimate_rows(node.child)
        if node.limit is not None:
            return max(min(float(node.limit), base), 1.0)
        return base
    if isinstance(node, L.Distinct):
        return max(_estimate_rows(node.child) * 0.5, 1.0)
    if isinstance(node, L.Project):
        return _estimate_rows(node.child)
    kids = node.children()
    if kids:
        return max(_estimate_rows(k) for k in kids)
    return 1.0


def _ndv(part, expr) -> float:
    """Crude per-expr distinct-count estimate from base-table stats."""
    cols = _cols_of(expr)
    if len(cols) != 1:
        return max(_estimate_rows(part), 1.0)
    node = part
    idx = cols[0]
    while True:
        if isinstance(node, L.Filter):
            node = node.child
            continue
        if isinstance(node, L.Project):
            e2 = node.exprs[idx]
            c2 = _cols_of(e2)
            if len(c2) != 1:
                return max(_estimate_rows(part), 1.0)
            idx = c2[0]
            node = node.child
            continue
        break
    if isinstance(node, L.Get):
        col = node.table.columns[node.column_indices[idx]]
        s = col.stats
        if s.distinct_hint:
            return float(s.distinct_hint)
        if s.min is not None and s.max is not None \
                and col.dtype.is_integer:
            return float(max(int(s.max) - int(s.min) + 1, 1))
    return max(_estimate_rows(part), 1.0)


def _build_joins(node: L.CrossProduct, preds: List[ir.Expr]
                 ) -> L.LogicalNode:
    """Flatten a cross-product tree, split predicates, greedily build a
    left-deep join tree, restore original column order with a Project."""
    children = _flatten_cross(node)
    offsets = []
    off = 0
    for c in children:
        offsets.append(off)
        off += len(c.schema)
    total_width = off

    # classify predicates
    child_of_col = {}
    for i, (c, o) in enumerate(zip(children, offsets)):
        for j in range(len(c.schema)):
            child_of_col[o + j] = i

    local_preds: List[List[ir.Expr]] = [[] for _ in children]
    join_conds = []      # (ci, cj, expr_i_local, expr_j_local)
    residual = []
    for p in preds:
        cols = _cols_of(p)
        cs = {child_of_col[c] for c in cols}
        if len(cs) == 1:
            ci = cs.pop()
            local_preds[ci].append(ir.remap_columns(
                p, {c: c - offsets[ci] for c in cols}))
        elif len(cs) == 2 and isinstance(p, ir.Cmp) and p.op == "==":
            lcols = set(_cols_of(p.left))
            rcols = set(_cols_of(p.right))
            lcs = {child_of_col[c] for c in lcols}
            rcs = {child_of_col[c] for c in rcols}
            if len(lcs) == 1 and len(rcs) == 1 and lcs != rcs:
                ci, cj = lcs.pop(), rcs.pop()
                le = ir.remap_columns(p.left, {c: c - offsets[ci]
                                               for c in lcols})
                re_ = ir.remap_columns(p.right, {c: c - offsets[cj]
                                                 for c in rcols})
                join_conds.append((ci, cj, le, re_))
            else:
                residual.append(p)
        else:
            residual.append(p)

    # push local predicates
    parts = [push_filters(c, lp) for c, lp in zip(children, local_preds)]
    sizes = [_estimate_rows(p) for p in parts]

    # ---- DP join enumeration (reference: optimizer/join_order/
    # plan_enumerator.cpp DPccp) for up to 11 relations; greedy beyond.
    # Cost = sum of intermediate cardinalities; card(S) = prod(base) /
    # prod(max ndv per join edge inside S) — the reference's
    # cardinality_estimator.cpp denominator idea.
    _ndv_cache = {}

    def cond_ndv(k):
        if k not in _ndv_cache:
            ci, cj, le, re_ = join_conds[k]
            _ndv_cache[k] = max(_ndv(parts[ci], le),
                                _ndv(parts[cj], re_), 1.0)
        return _ndv_cache[k]

    dp_tree = None
    if 2 <= len(parts) <= 11:
        dp_tree = _dp_join_order(len(parts), sizes, join_conds, cond_ndv)

    if dp_tree is not None:
        applied = set()
        current, placed_offsets, cur_width = _build_join_tree(
            dp_tree, parts, join_conds, applied)
        conds_left = [jc for k, jc in enumerate(join_conds)
                      if k not in applied]
        return _joins_postlude(children, offsets, parts, current,
                               placed_offsets, cur_width, conds_left,
                               residual)

    # greedy left-deep join order by ESTIMATED OUTPUT CARDINALITY:
    # |L join R| ~= |L| * |R| / max(ndv(Lkey), ndv(Rkey)) — avoids
    # low-cardinality-key fan-out blowups (e.g. joining two fact-side
    # tables on nationkey).  Reference analog: cardinality_estimator.cpp.
    remaining = set(range(len(parts)))
    conds_left = list(join_conds)

    def cond_children(jc):
        return {jc[0], jc[1]}

    if conds_left:
        start = min((c for jc in conds_left for c in cond_children(jc)),
                    key=lambda c: sizes[c])
    else:
        start = min(remaining, key=lambda c: sizes[c])

    current = parts[start]
    cur_size = sizes[start]
    placed = [start]                 # child order in current plan
    placed_offsets = {start: 0}
    cur_width = len(parts[start].schema)
    remaining.discard(start)

    def local_to_current(ci, e):
        return ir.remap_columns(
            e, {c: c + placed_offsets[ci] for c in _cols_of(e)})

    while remaining:
        # find conds connecting placed <-> unplaced, estimate join output
        candidates = {}
        for jc in conds_left:
            ci, cj, le, re_ = jc
            if ci in placed_offsets and cj in remaining:
                new, pe, ne = cj, le, re_
                psrc = parts[ci]
            elif cj in placed_offsets and ci in remaining:
                new, pe, ne = ci, re_, le
                psrc = parts[cj]
            else:
                continue
            ndv = max(_ndv(psrc, pe), _ndv(parts[new], ne), 1.0)
            est = cur_size * sizes[new] / ndv
            if new not in candidates or est < candidates[new]:
                candidates[new] = est
        if not candidates:
            nxt = min(remaining, key=lambda c: sizes[c])
            right = parts[nxt]
            current = L.CrossProduct(current, right)
            cur_size = cur_size * sizes[nxt]
            placed_offsets[nxt] = cur_width
            cur_width += len(right.schema)
            placed.append(nxt)
            remaining.discard(nxt)
            continue
        # pick the candidate with the smallest estimated output
        nxt = min(candidates, key=lambda c: candidates[c])
        cur_size = max(candidates[nxt], 1.0)
        # gather ALL conds connecting placed set with nxt
        use, keep = [], []
        for jc in conds_left:
            ci, cj, le, re_ = jc
            if ci in placed_offsets and cj == nxt:
                use.append((local_to_current(ci, le), re_))
            elif cj in placed_offsets and ci == nxt:
                use.append((local_to_current(cj, re_), le))
            else:
                keep.append(jc)
        conds_left = keep
        right = parts[nxt]
        conds = [L.JoinCond(le, re_) for le, re_ in use]
        current = L.Join(current, right, "inner", conds)
        placed_offsets[nxt] = cur_width
        cur_width += len(right.schema)
        placed.append(nxt)
        remaining.discard(nxt)

    return _joins_postlude(children, offsets, parts, current,
                           placed_offsets, cur_width, conds_left, residual)


def _joins_postlude(children, offsets, parts, current, placed_offsets,
                    cur_width, conds_left, residual):
    """Shared tail of join building: leftover cycle conds + residual
    predicates become filters; a Project restores original column order."""
    def local_to_current(ci, e):
        return ir.remap_columns(
            e, {c: c + placed_offsets[ci] for c in _cols_of(e)})

    leftover = []
    for ci, cj, le, re_ in conds_left:
        leftover.append(ir.Cmp("==", local_to_current(ci, le),
                               local_to_current(cj, re_)))

    # residual predicates: remap from original order to current order
    remapped_residual = []
    col_map = {}
    for ci in placed_offsets:
        for j in range(len(parts[ci].schema)):
            col_map[offsets[ci] + j] = placed_offsets[ci] + j
    for p in residual:
        remapped_residual.append(ir.remap_columns(
            p, {c: col_map[c] for c in _cols_of(p)}))

    current = _wrap(current, leftover + remapped_residual)

    # restore original column order
    exprs, names = [], []
    for ci, (c, o) in enumerate(zip(children, offsets)):
        for j, f in enumerate(c.schema.fields):
            exprs.append(ir.ColRef(placed_offsets[ci] + j, f.dtype,
                                   f.name, f.strdict))
            names.append(f.name)
    return L.Project(current, exprs, names,
                     L.Schema(tuple(f for c in children
                                    for f in c.schema.fields)))


def _dp_join_order(n, sizes, conds, cond_ndv):
    """DPsub enumeration over connected splits (reference:
    optimizer/join_order/plan_enumerator.cpp).  Returns a bushy tree of
    ("leaf", i) / ("join", left_tree, right_tree); right side = estimated
    smaller (build) side (reference: build_probe_side_optimizer.cpp)."""
    card_memo = {}

    def card(mask):
        c = card_memo.get(mask)
        if c is None:
            c = 1.0
            for i in range(n):
                if mask >> i & 1:
                    c *= sizes[i]
            for k, (ci, cj, _, _) in enumerate(conds):
                if mask >> ci & 1 and mask >> cj & 1:
                    c /= cond_ndv(k)
            c = max(c, 1.0)
            card_memo[mask] = c
        return c

    edge_pairs = [(1 << ci, 1 << cj) for ci, cj, _, _ in conds]

    def connected(s1, s2):
        for mi, mj in edge_pairs:
            if (s1 & mi and s2 & mj) or (s1 & mj and s2 & mi):
                return True
        return False

    best = [None] * (1 << n)
    for i in range(n):
        best[1 << i] = (0.0, ("leaf", i))
    for mask in range(3, 1 << n):
        if mask & (mask - 1) == 0:      # single relation
            continue
        lowest = mask & -mask
        cm = card(mask)
        found = None
        for want_connected in (True, False):
            s1 = (mask - 1) & mask
            while s1:
                s2 = mask ^ s1
                if (s1 & lowest) and s2 \
                        and best[s1] is not None and best[s2] is not None \
                        and (not want_connected or connected(s1, s2)):
                    cost = best[s1][0] + best[s2][0] + cm
                    if found is None or cost < found[0]:
                        if card(s1) >= card(s2):
                            tree = ("join", best[s1][1], best[s2][1])
                        else:
                            tree = ("join", best[s2][1], best[s1][1])
                        found = (cost, tree)
                s1 = (s1 - 1) & mask
            if found is not None:
                break                    # cross products only as fallback
        best[mask] = found
    full = best[(1 << n) - 1]
    return full[1] if full else None


def _build_join_tree(tree, parts, conds, applied):
    """Assemble the L.Join tree from a DP tree, applying every equi-cond
    at the first join where both endpoints are available.  Returns
    (plan, {child_index: column_offset}, width)."""
    if tree[0] == "leaf":
        i = tree[1]
        return parts[i], {i: 0}, len(parts[i].schema)
    _, lt, rt = tree
    lplan, lmap, lw = _build_join_tree(lt, parts, conds, applied)
    rplan, rmap, rw = _build_join_tree(rt, parts, conds, applied)

    def shift(e, off):
        return ir.remap_columns(e, {c: c + off for c in _cols_of(e)})

    jconds = []
    for k, (ci, cj, le, re_) in enumerate(conds):
        if k in applied:
            continue
        if ci in lmap and cj in rmap:
            jconds.append(L.JoinCond(shift(le, lmap[ci]),
                                     shift(re_, rmap[cj])))
            applied.add(k)
        elif cj in lmap and ci in rmap:
            jconds.append(L.JoinCond(shift(re_, lmap[cj]),
                                     shift(le, rmap[ci])))
            applied.add(k)
    if jconds:
        plan = L.Join(lplan, rplan, "inner", jconds)
    else:
        plan = L.CrossProduct(lplan, rplan)
    offs = dict(lmap)
    offs.update({k: v + lw for k, v in rmap.items()})
    return plan, offs, lw + rw


# ---------------------------------------------------------------------------
# scan column pruning
# ---------------------------------------------------------------------------

def prune_get_columns(node: L.LogicalNode,
                      needed: Optional[set] = None) -> L.LogicalNode:
    """Narrow Get nodes to the columns actually used upstream.

    `needed` = set of output column indices required from this node
    (None => all).  Round-1 scope: prunes Gets below
    Project/Filter/Join/Aggregate chains."""
    if isinstance(node, L.Materialize):
        return node
    if isinstance(node, L.Get):
        used = set(needed) if needed is not None else set(
            range(len(node.schema)))
        for f in node.filters:
            used.update(_cols_of(f))
        keep = sorted(used)
        if len(keep) == len(node.column_indices):
            return node
        remap = {old: i for i, old in enumerate(keep)}
        new_indices = [node.column_indices[i] for i in keep]
        new_filters = [ir.remap_columns(f, {c: remap[c]
                                            for c in _cols_of(f)})
                       for f in node.filters]
        g = L.Get(node.table, new_indices, new_filters)
        if needed is not None and len(keep) != len(node.schema):
            # upstream references must be remapped; emit Project shim with
            # the ORIGINAL schema width by reinserting pruned cols is
            # wasteful — instead callers pass through _PruneCtx below.
            return g, remap
        return g

    return _prune_rec(node)


def _prune_rec(node: L.LogicalNode) -> L.LogicalNode:
    """Recursive pruning: computes needed sets per operator."""
    if isinstance(node, L.Materialize):
        return node
    if isinstance(node, L.Project):
        used = set()
        for e in node.exprs:
            used.update(_cols_of(e))
        child, remap = _prune_child(node.child, used)
        exprs = [ir.remap_columns(e, {c: remap[c] for c in _cols_of(e)})
                 for e in node.exprs]
        return L.Project(child, exprs, node.names, node.schema)

    if isinstance(node, L.Aggregate):
        import dataclasses
        used = set()
        for g in node.groups:
            used.update(_cols_of(g))
        for a in node.aggs:
            for arg in (a.arg, a.arg2):
                if arg is not None:
                    used.update(_cols_of(arg))
            for (oe, _d, _nl) in (a.order_by or ()):
                used.update(_cols_of(oe))
        child, remap = _prune_child(node.child, used)
        groups = [ir.remap_columns(g, {c: remap[c] for c in _cols_of(g)})
                  for g in node.groups]

        def remap_arg(arg):
            if arg is None:
                return None
            return ir.remap_columns(arg, {c: remap[c]
                                          for c in _cols_of(arg)})

        aggs = [dataclasses.replace(
                    a, arg=remap_arg(a.arg), arg2=remap_arg(a.arg2),
                    order_by=[(remap_arg(oe), d, nl)
                              for (oe, d, nl) in a.order_by]
                    if a.order_by else None)
                for a in node.aggs]
        return L.Aggregate(child, groups, aggs, node.group_names,
                           node.schema)

    new = copy.copy(node)
    for attr in ("child", "left", "right", "base", "recursive"):
        if hasattr(new, attr):
            setattr(new, attr, _prune_rec(getattr(node, attr)))
    return new


def _prune_child(child: L.LogicalNode, used: set):
    """Prune a child to `used` columns; returns (new_child, remap)."""
    if isinstance(child, L.Get):
        res = prune_get_columns(child, used)
        if isinstance(res, tuple):
            return res
        return res, {i: i for i in range(len(res.schema))}
    if isinstance(child, L.Filter) and isinstance(child.child, L.Get):
        used2 = set(used) | set(_cols_of(child.predicate))
        res = prune_get_columns(child.child, used2)
        if isinstance(res, tuple):
            g, remap = res
        else:
            g, remap = res, {i: i for i in range(len(res.schema))}
        pred = ir.remap_columns(child.predicate,
                                {c: remap[c]
                                 for c in _cols_of(child.predicate)})
        return L.Filter(g, pred), remap
    return _prune_rec(child), {i: i for i in range(len(child.schema))}
