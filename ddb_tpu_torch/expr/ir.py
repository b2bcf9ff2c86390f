"""Bound expression IR.

Typed expression trees referencing input columns by position — the analog of
the reference's bound Expression hierarchy (reference:
src/planner/expression/*, src/include/duckdb/planner/expression.hpp), but
designed to compile to fused, branch-free jnp code over whole batches rather
than to an interpreted per-chunk executor
(reference: src/execution/expression_executor.cpp).

Type/scale resolution (duckdb-compatible):
  +,-   on DECIMAL: rescale to max scale
  *     on DECIMAL: scale = s1 + s2
  /     always binds to DOUBLE (matches duckdb's decimal division -> double)
  comparisons on DECIMAL: rescale to common scale first
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

from .. import types as T
from ..types import DataType, TypeId


class Expr:
    dtype: DataType

    def children(self):
        return []


@dataclass
class ColRef(Expr):
    index: int
    dtype: DataType
    name: str = ""
    strdict: Any = None

    def __repr__(self):
        return f"#{self.index}:{self.name}"


@dataclass
class Const(Expr):
    value: Any            # raw physical value (already encoded), None => NULL
    dtype: DataType

    def __repr__(self):
        return f"const({self.value}:{self.dtype})"


@dataclass
class Cast(Expr):
    child: Expr
    dtype: DataType
    src: DataType = None

    def __post_init__(self):
        if self.src is None:
            self.src = self.child.dtype

    def children(self):
        return [self.child]


@dataclass
class Arith(Expr):
    """op in {+,-,*,/,//,%}; operands pre-promoted by bind_arith."""
    op: str
    left: Expr
    right: Expr
    dtype: DataType

    def children(self):
        return [self.left, self.right]


@dataclass
class Cmp(Expr):
    """op in {==,!=,<,<=,>,>=}; operands pre-promoted."""
    op: str
    left: Expr
    right: Expr
    dtype: DataType = T.BOOLEAN

    def children(self):
        return [self.left, self.right]


@dataclass
class BoolOp(Expr):
    """Kleene AND/OR over boolean children."""
    op: str                # 'and' | 'or'
    args: Sequence[Expr] = ()
    dtype: DataType = T.BOOLEAN

    def children(self):
        return list(self.args)


@dataclass
class Not(Expr):
    child: Expr
    dtype: DataType = T.BOOLEAN

    def children(self):
        return [self.child]


@dataclass
class IsNull(Expr):
    child: Expr
    negated: bool = False
    dtype: DataType = T.BOOLEAN

    def children(self):
        return [self.child]


@dataclass
class Case(Expr):
    """CASE WHEN c1 THEN v1 ... ELSE e END (whens pre-promoted)."""
    whens: Sequence            # list[(cond Expr, value Expr)]
    else_: Expr
    dtype: DataType

    def children(self):
        out = []
        for c, v in self.whens:
            out += [c, v]
        out.append(self.else_)
        return out


@dataclass
class InList(Expr):
    child: Expr
    values: Sequence           # raw physical constants (no nulls)
    negated: bool = False
    dtype: DataType = T.BOOLEAN

    def children(self):
        return [self.child]


@dataclass
class DictLookup(Expr):
    """Gather from a host-computed per-code table (LIKE, prefix, regexp on
    dictionary-encoded strings).  table: numpy bool/int array indexed by the
    child's dictionary code.  null_table (optional bool array) marks codes
    whose result is SQL NULL (e.g. json_extract on a missing path)."""
    child: Expr
    table: Any                 # np.ndarray, one entry per dict code
    dtype: DataType
    label: str = "dict_lookup"
    null_table: Any = None     # optional np.bool_ array, same length
    base: int = 0              # index = child_value - base (bounded-domain
                               # tables, e.g. numeric -> varchar stringify)

    def children(self):
        return [self.child]


@dataclass
class DictLookup2(Expr):
    """Gather from a host-computed pair table indexed by
    (left_code * right_card + right_code) — two-dictionary functions like
    concat(col, col).  Pair-table size is capped at bind time."""
    left: Expr
    right: Expr
    table: Any                 # np.ndarray of left_card * right_card
    right_card: int
    dtype: DataType
    label: str = "dict_lookup2"
    null_table: Any = None     # optional np.bool_ array, same length

    def children(self):
        return [self.left, self.right]


@dataclass
class Func(Expr):
    """Scalar function by name; kernels registered in expr/functions.py."""
    name: str
    args: Sequence[Expr]
    dtype: DataType
    extra: Any = None          # function-specific static payload

    def children(self):
        return list(self.args)


# ---------------------------------------------------------------------------
# binding helpers (type promotion)
# ---------------------------------------------------------------------------

def promote(e: Expr, target: DataType) -> Expr:
    if e.dtype == target:
        return e
    return Cast(e, target)


def common_type(a: DataType, b: DataType) -> DataType:
    if a == b:
        return a
    if a.id == TypeId.NULL:
        return b
    if b.id == TypeId.NULL:
        return a
    if a.is_numeric and b.is_numeric:
        return T.max_numeric(a, b)
    # BOOLEAN compares/combines with numerics as 0/1 (reference:
    # implicit BOOLEAN -> integer cast, src/function/cast_rules.cpp)
    if a.id == TypeId.BOOLEAN and b.is_numeric:
        return b
    if b.id == TypeId.BOOLEAN and a.is_numeric:
        return a
    if a.id == TypeId.DATE and b.id == TypeId.TIMESTAMP:
        return T.TIMESTAMP
    if b.id == TypeId.DATE and a.id == TypeId.TIMESTAMP:
        return T.TIMESTAMP
    # TIMESTAMPTZ wins over naive temporal types (reference: implicit
    # cast ranks TIMESTAMP -> TIMESTAMP_TZ, src/function/cast_rules.cpp).
    # NOTE: the implicit shift here assumes UTC sessions; the binder
    # lowers explicit casts through the session TimeZone tables.
    if {a.id, b.id} <= {TypeId.TIMESTAMPTZ, TypeId.TIMESTAMP,
                        TypeId.DATE} and TypeId.TIMESTAMPTZ in (
            a.id, b.id):
        return T.TIMESTAMPTZ
    if a.is_string and b.is_string:
        return a
    raise TypeError(f"no common type for {a} and {b}")


def bind_comparison(op: str, left: Expr, right: Expr) -> Expr:
    ct = common_type(left.dtype, right.dtype)
    if ct.id == TypeId.DECIMAL:
        ls = left.dtype.scale if left.dtype.id == TypeId.DECIMAL else 0
        rs = right.dtype.scale if right.dtype.id == TypeId.DECIMAL else 0
        s = max(ls, rs)
        # a large rescale could overflow int64 (sums near 18 digits);
        # fall back to exact-enough double comparison
        if s - min(ls, rs) > 6:
            return Cmp(op, promote(left, T.DOUBLE),
                       promote(right, T.DOUBLE))
        ct = T.DECIMAL(18, s)
    return Cmp(op, promote(left, ct), promote(right, ct))


_TS_IDS = (TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ)


def bind_arith(op: str, left: Expr, right: Expr) -> Expr:
    lt, rt = left.dtype, right.dtype
    # date/interval arithmetic
    if lt.id == TypeId.DATE or rt.id == TypeId.DATE:
        return _bind_date_arith(op, left, right)
    # timestamp/time/interval arithmetic in the micros domain
    # (reference: operators in src/common/operator/add.cpp/subtract.cpp)
    if op == "-" and lt.id in _TS_IDS and rt.id in _TS_IDS:
        return Arith("-", left, right, T.INTERVAL)
    if op == "-" and lt.id == TypeId.TIME and rt.id == TypeId.TIME:
        return Arith("-", left, right, T.INTERVAL)
    if lt.id in _TS_IDS + (TypeId.TIME,) and rt.id == TypeId.INTERVAL:
        return Arith(op, left, right, lt)
    if op == "+" and lt.id == TypeId.INTERVAL \
            and rt.id in _TS_IDS + (TypeId.TIME,):
        return Arith(op, left, right, rt)
    if lt.id == TypeId.INTERVAL and rt.id == TypeId.INTERVAL \
            and op in ("+", "-"):
        return Arith(op, left, right, T.INTERVAL)
    if op in ("&", "|", "<<", ">>", "xor"):
        # integer bitwise (reference: core_functions/scalar/operators/
        # bitwise.cpp; BIT-typed operands are handled at the binder seam)
        ct = common_type(lt, rt)
        if not ct.is_integer:
            raise ValueError(
                f"bitwise {op} requires integer operands, got {lt}/{rt}")
        return Arith(op, promote(left, ct), promote(right, ct), ct)
    if op == "/":
        return Arith("/", promote(left, T.DOUBLE), promote(right, T.DOUBLE),
                     T.DOUBLE)
    if op in ("//", "%"):
        ct = common_type(lt, rt)
        return Arith(op, promote(left, ct), promote(right, ct), ct)
    ct = common_type(lt, rt)
    if ct.id == TypeId.DECIMAL:
        ls = lt.scale if lt.id == TypeId.DECIMAL else 0
        rs = rt.scale if rt.id == TypeId.DECIMAL else 0
        if op == "*":
            # product scale adds; operands NOT rescaled
            out = T.DECIMAL(18, ls + rs)
            return Arith("*", _as_decimal(left), _as_decimal(right), out)
        s = max(ls, rs)
        out = T.DECIMAL(18, s)
        return Arith(op, promote(_as_decimal(left), out),
                     promote(_as_decimal(right), out), out)
    return Arith(op, promote(left, ct), promote(right, ct), ct)


def _as_decimal(e: Expr) -> Expr:
    if e.dtype.id == TypeId.DECIMAL:
        return e
    if e.dtype.is_integer:
        return Cast(e, T.DECIMAL(18, 0))
    raise TypeError(f"cannot treat {e.dtype} as decimal")


def _bind_date_arith(op: str, left: Expr, right: Expr) -> Expr:
    lt, rt = left.dtype, right.dtype
    if op == "-" and lt.id == TypeId.DATE and rt.id == TypeId.DATE:
        return Arith("-", left, right, T.BIGINT)
    if lt.id == TypeId.DATE and rt.is_integer:
        return Arith(op, left, promote(right, T.INTEGER), T.DATE)
    if rt.id == TypeId.DATE and lt.is_integer and op == "+":
        return Arith(op, promote(left, T.INTEGER), right, T.DATE)
    if lt.id == TypeId.DATE and rt.id == TypeId.INTERVAL:
        # interval encoded as (months<<32)|days? — round 1: interval literals
        # are folded to day counts at parse; micros ignored for DATE math
        return Arith(op, left, right, T.DATE)
    raise TypeError(f"bad date arithmetic {lt} {op} {rt}")


def conjuncts(e: Optional[Expr]):
    """Flatten an AND tree into a list of conjuncts."""
    if e is None:
        return []
    if isinstance(e, BoolOp) and e.op == "and":
        out = []
        for a in e.args:
            out.extend(conjuncts(a))
        return out
    return [e]


def make_and(parts) -> Optional[Expr]:
    parts = [p for p in parts if p is not None]
    if not parts:
        return None
    if len(parts) == 1:
        return parts[0]
    return BoolOp("and", tuple(parts))


def walk(e: Expr):
    yield e
    for c in e.children():
        yield from walk(c)


def referenced_columns(e: Expr):
    return sorted({n.index for n in walk(e) if isinstance(n, ColRef)})


def remap_columns(e: Expr, mapping) -> Expr:
    """Rewrite ColRef indices through `mapping` (dict old->new)."""
    import copy
    if isinstance(e, ColRef):
        return ColRef(mapping[e.index], e.dtype, e.name, e.strdict)
    c = copy.copy(e)
    if isinstance(e, Case):
        c.whens = [(remap_columns(w, mapping), remap_columns(v, mapping))
                   for w, v in e.whens]
        c.else_ = remap_columns(e.else_, mapping)
        return c
    for attr in ("child", "left", "right"):
        if hasattr(e, attr):
            setattr(c, attr, remap_columns(getattr(e, attr), mapping))
    if hasattr(e, "args") and not isinstance(e, Case):
        c.args = tuple(remap_columns(a, mapping) for a in e.args)
    return c
