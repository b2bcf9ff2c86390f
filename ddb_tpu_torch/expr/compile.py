"""Expression IR -> eager torch evaluation over a Batch.

PyTorch port of ddb_tpu/expr/compile.py.  Every node evaluates to
(data, nulls) where nulls is an optional bool tensor (True => NULL).
SQL three-valued logic:
  * arithmetic/comparison propagate NULL if any input is NULL
  * AND/OR use Kleene logic
  * predicates used as filters treat NULL as False (select_mask)

Integer division and modulo floor like jnp (`torch.div(...,
rounding_mode="floor")`, `torch.remainder`); integer true division and
decimal scaling name float64 explicitly, since torch's default float is
float32.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import types as T
from ..types import TypeId
from . import ir
from ..batch import Batch, torch_dtype


def _or_nulls(*masks):
    masks = [m for m in masks if m is not None]
    if not masks:
        return None
    out = masks[0]
    for m in masks[1:]:
        out = out | m
    return out


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def evaluate(e: ir.Expr, batch: Batch):
    """Returns (data: Tensor[cap], nulls: Optional[bool Tensor[cap]])."""
    return _EVAL[type(e)](e, batch)


def evaluate_const(e: ir.Expr):
    """Fold a column-free expression on the host: (data[1], nulls[1])."""
    return evaluate(e, Batch((), torch.ones(1, dtype=torch.bool),
                             torch.tensor(1, dtype=torch.int32)))


def select_mask(e: ir.Expr, batch: Batch):
    """Predicate -> row mask: TRUE rows only (NULL => False), AND sel."""
    data, nulls = evaluate(e, batch)
    m = data
    if nulls is not None:
        m = m & ~nulls
    return m & batch.sel


# ---------------------------------------------------------------------------

def _eval_colref(e: ir.ColRef, b: Batch):
    col = b.columns[e.index]
    return col.data, col.nulls


def _eval_const(e: ir.Const, b: Batch):
    cap = b.sel.shape[0]
    dt = torch_dtype(e.dtype.np_dtype)
    if e.value is None:
        return (torch.zeros(cap, dtype=dt, device=b.device),
                torch.ones(cap, dtype=torch.bool, device=b.device))
    return torch.full((cap,), _py(e.value), dtype=dt, device=b.device), None


def _py(v):
    """numpy scalar -> Python scalar (torch takes Python numbers)."""
    return v.item() if isinstance(v, np.generic) else v


def _eval_cast(e: ir.Cast, b: Batch):
    data, nulls = evaluate(e.child, b)
    return _cast_data(data, e.src, e.dtype), nulls


def _cast_data(data, src, dst):
    if src == dst:
        return data
    sid, did = src.id, dst.id
    i64, f64 = torch.int64, torch.float64
    if sid == TypeId.DECIMAL and did == TypeId.DECIMAL:
        if dst.scale > src.scale:
            return data.to(i64) * T.decimal_scale_factor(
                dst.scale - src.scale)
        if dst.scale < src.scale:
            return _div_floor_to_even(data, src.scale - dst.scale)
        return data
    if did == TypeId.DECIMAL:
        if src.is_integer:
            return data.to(i64) * T.decimal_scale_factor(dst.scale)
        if sid in (TypeId.FLOAT, TypeId.DOUBLE):
            return torch.round(
                data.to(f64) * T.decimal_scale_factor(dst.scale)).to(i64)
    if sid == TypeId.DECIMAL:
        if did in (TypeId.FLOAT, TypeId.DOUBLE):
            return (data.to(torch_dtype(dst.np_dtype))
                    / T.decimal_scale_factor(src.scale))
        if dst.is_integer:
            return _div_floor_to_even(data, src.scale).to(
                torch_dtype(dst.np_dtype))
    if sid == TypeId.DATE and did in (TypeId.TIMESTAMP,
                                      TypeId.TIMESTAMPTZ):
        return data.to(i64) * 86_400_000_000
    if sid in (TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ) \
            and did == TypeId.DATE:
        return _fdiv(data.to(i64), 86_400_000_000).to(torch.int32)
    if sid in (TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ) \
            and did == TypeId.TIME:
        return torch.remainder(data.to(i64), 86_400_000_000)
    # TIMETZ packing: utc_micros * 2^17 + (57599 - offset_sec)
    # (reference: dtime_tz_t, src/include/duckdb/common/types/time.hpp)
    if did == TypeId.TIMETZ and sid == TypeId.TIME:
        return data.to(i64) * 131072 + 57599   # offset +00
    if sid == TypeId.TIMETZ and did == TypeId.TIME:
        d64 = data.to(i64)
        utc = _fdiv(d64, 131072)
        off = 57599 - (d64 - utc * 131072)
        return torch.remainder(utc + off * 1_000_000, 86_400_000_000)
    if sid in (TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ) \
            and did == TypeId.TIMETZ:
        return torch.remainder(data.to(i64),
                               86_400_000_000) * 131072 + 57599
    if sid in (TypeId.FLOAT, TypeId.DOUBLE) and dst.is_integer:
        # float -> integer rounds half-to-even (reference:
        # std::nearbyint in NumericTryCast, cast_operators.hpp)
        return torch.round(data).to(torch_dtype(dst.np_dtype))
    return data.to(torch_dtype(dst.np_dtype))


def _div_floor_to_even(data, scale_diff):
    """Divide by 10^k with round-half-away-from-zero (duckdb semantics)."""
    f = T.decimal_scale_factor(scale_diff)
    data = data.to(torch.int64)
    half = f // 2
    adj = torch.where(data >= 0, data + half, data - half)
    return _fdiv(adj, f)


def _eval_arith(e: ir.Arith, b: Batch):
    ld, ln = evaluate(e.left, b)
    rd, rn = evaluate(e.right, b)
    nulls = _or_nulls(ln, rn)
    op = e.op
    if op == "+":
        out = ld + rd
    elif op == "-":
        out = ld - rd
    elif op == "*":
        if e.dtype.id == TypeId.DECIMAL:
            out = ld.to(torch.int64) * rd.to(torch.int64)
        else:
            out = ld * rd
    elif op == "/":
        if not (ld.is_floating_point() or rd.is_floating_point()):
            ld, rd = ld.to(torch.float64), rd.to(torch.float64)
        out = ld / rd
    elif op in ("//", "%"):
        safe = torch.where(rd == 0, torch.ones_like(rd), rd)
        if ld.is_floating_point() or rd.is_floating_point():
            # reference: float // is plain division (-7.5 // 2 = -3.75);
            # float % truncates (sign follows the dividend)
            out = ld / safe if op == "//" \
                else ld - torch.trunc(ld / safe) * safe
        else:
            # integer division truncates toward zero (-7 // 2 = -3)
            q = _fdiv(ld, safe)
            rfl = ld - q * safe
            tq = q + ((rfl != 0) & ((ld < 0) != (safe < 0))).to(q.dtype)
            out = tq if op == "//" else ld - tq * safe
        nulls = _or_nulls(nulls, rd == 0)
    elif op == "&":
        out = ld & rd
    elif op == "|":
        out = ld | rd
    elif op == "xor":
        out = ld ^ rd
    elif op in ("<<", ">>"):
        # shifts >= bit width are 0 in the reference
        width = torch.iinfo(ld.dtype).bits
        sh = torch.clamp(rd, 0, width - 1).to(ld.dtype)
        moved = torch.bitwise_left_shift(ld, sh) if op == "<<" \
            else torch.bitwise_right_shift(ld, sh)
        out = torch.where((rd >= width) | (rd < 0),
                          torch.zeros_like(moved), moved)
    else:
        raise ValueError(op)
    want = torch_dtype(e.dtype.np_dtype)
    if out.dtype != want:
        out = out.to(want)
    return out, nulls


_CMP = {
    "==": torch.eq, "!=": torch.ne,
    "<": torch.lt, "<=": torch.le,
    ">": torch.gt, ">=": torch.ge,
}


def _eval_cmp(e: ir.Cmp, b: Batch):
    ld, ln = evaluate(e.left, b)
    rd, rn = evaluate(e.right, b)
    return _CMP[e.op](ld, rd), _or_nulls(ln, rn)


def _eval_boolop(e: ir.BoolOp, b: Batch):
    vals = [evaluate(a, b) for a in e.args]
    conj = e.op == "and"
    # AND: F if any F, else N if any N, else T;
    # OR:  T if any T, else N if any N, else F
    acc = decided = any_null = None
    for d, n in vals:
        v = d if n is None else (d & ~n)
        dec = (~d if n is None else (~d & ~n)) if conj else v
        if acc is None:
            acc, decided = v, dec
        else:
            acc = (acc & v) if conj else (acc | v)
            decided = decided | dec
        any_null = _or_nulls(any_null, n)
    if any_null is None:
        return acc, None
    return acc, any_null & ~decided


def _eval_not(e: ir.Not, b: Batch):
    d, n = evaluate(e.child, b)
    return ~d, n


def _eval_isnull(e: ir.IsNull, b: Batch):
    d, n = evaluate(e.child, b)
    isn = torch.zeros(d.shape[0], dtype=torch.bool, device=d.device) \
        if n is None else n
    return (~isn if e.negated else isn), None


def _eval_case(e: ir.Case, b: Batch):
    else_d, else_n = evaluate(e.else_, b)
    out = else_d.to(torch_dtype(e.dtype.np_dtype))
    cap = out.shape[0]
    out_n = else_n if else_n is not None else \
        torch.zeros(cap, dtype=torch.bool, device=out.device)
    decided = torch.zeros(cap, dtype=torch.bool, device=out.device)
    # first-match-wins, evaluated front to back
    for cond, val in e.whens:
        cd, cn = evaluate(cond, b)
        take = cd if cn is None else (cd & ~cn)
        take = take & ~decided
        vd, vn = evaluate(val, b)
        out = torch.where(take, vd.to(out.dtype), out)
        out_n = out_n & ~take if vn is None \
            else torch.where(take, vn, out_n)
        decided = decided | take
    return out, out_n


def _eval_inlist(e: ir.InList, b: Batch):
    d, n = evaluate(e.child, b)
    vals = [_py(v) for v in e.values]
    if _ints_of(vals, d.dtype):
        # integers of the column's own type: one binary search of each
        # row in the sorted list, not two passes a value (a DELETE of
        # 1,500 keys would make 3,000 passes over the table)
        table = torch.tensor(sorted(set(vals)), dtype=d.dtype,
                             device=d.device)
        pos = torch.searchsorted(table, d.contiguous())
        acc = table[pos.clamp_(max=table.shape[0] - 1)] == d
    else:
        acc = torch.zeros(d.shape[0], dtype=torch.bool, device=d.device)
        for v in vals:
            acc = acc | (d == v)
    if e.negated:
        acc = ~acc
    return acc, n


def _ints_of(vals, dtype) -> bool:
    """True when every value is an integer that `dtype`, an integer
    dtype, holds exactly."""
    if not vals or dtype in (torch.bool,) or dtype.is_floating_point:
        return False
    info = torch.iinfo(dtype)
    return all(type(v) is int and info.min <= v <= info.max for v in vals)


def _table(raw, device, np_dtype=None, convert=False):
    """A lookup table as a tensor on `device`.  A table of Python values
    (or any, when `convert`) takes the physical type np_dtype."""
    a = np.asarray(raw)
    if convert or (a.dtype == object and np_dtype is not None):
        a = a.astype(np_dtype)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _eval_dictlookup(e: ir.DictLookup, b: Batch):
    d, n = evaluate(e.child, b)
    raw_table, raw_nulls = e.table, e.null_table
    np_dtype = e.dtype.np_dtype
    runtime = callable(raw_table)
    if runtime:
        # lazy table over a store filled at run time: built now, after
        # the child (evaluated above) has filled the store
        from . import functions
        functions.HOST_CALLS["dictlookup"] += 1
        raw_table, raw_nulls = raw_table()
        if len(raw_table) == 0:
            return (torch.zeros(d.shape[0], dtype=torch_dtype(np_dtype),
                                device=d.device),
                    torch.ones(d.shape[0], dtype=torch.bool,
                               device=d.device))
    table = _table(raw_table, d.device, np_dtype, convert=runtime)
    if table.shape[0] == 0:      # empty dictionary (e.g. empty table)
        nulls = n
        if raw_nulls is not None:
            nulls = torch.ones(d.shape[0], dtype=torch.bool,
                               device=d.device)
        return torch.zeros(d.shape[0], dtype=table.dtype,
                           device=d.device), nulls
    if e.base:
        d = d - e.base
    idx = torch.clamp(d.to(torch.int64), 0, table.shape[0] - 1)
    nulls = n
    if raw_nulls is not None:
        nulls = _or_nulls(n, _table(raw_nulls, d.device)[idx])
    return table[idx], nulls


def _eval_dictlookup2(e: ir.DictLookup2, b: Batch):
    ld, ln = evaluate(e.left, b)
    rd, rn = evaluate(e.right, b)
    table = _table(e.table, ld.device)
    nulls = _or_nulls(ln, rn)
    if table.shape[0] == 0:
        return torch.zeros(ld.shape[0], dtype=table.dtype,
                           device=ld.device), nulls
    idx = ld.to(torch.int64) * e.right_card + rd.to(torch.int64)
    idx = torch.clamp(idx, 0, table.shape[0] - 1)
    if e.null_table is not None:
        nulls = _or_nulls(nulls, _table(e.null_table, ld.device)[idx])
    return table[idx], nulls


def _eval_func(e: ir.Func, b: Batch):
    from . import functions
    return functions.dispatch(e, b, evaluate)


_EVAL = {
    ir.ColRef: _eval_colref,
    ir.Const: _eval_const,
    ir.Cast: _eval_cast,
    ir.Arith: _eval_arith,
    ir.Cmp: _eval_cmp,
    ir.BoolOp: _eval_boolop,
    ir.Not: _eval_not,
    ir.IsNull: _eval_isnull,
    ir.Case: _eval_case,
    ir.InList: _eval_inlist,
    ir.DictLookup: _eval_dictlookup,
    ir.DictLookup2: _eval_dictlookup2,
    ir.Func: _eval_func,
}
