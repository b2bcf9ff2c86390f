"""Result comparison against reference answer sets.

The reference compares benchmark results with numeric normalization
(reference: test/sqlite/result_helper.cpp, benchmark RESULT_ANSWER files):
decimals compare by value (380456 == 380456.00), doubles by value with
tight tolerance (their answers were printed by shortest-round-trip).
"""

from __future__ import annotations

import datetime
import decimal
import math
from typing import List, Tuple


def format_row(row) -> List[str]:
    out = []
    for v in row:
        if v is None:
            out.append("NULL")
        elif isinstance(v, bool):
            out.append("true" if v else "false")
        elif isinstance(v, float):
            out.append(repr(v))
        elif isinstance(v, datetime.datetime):
            out.append(v.isoformat(sep=" "))
        elif isinstance(v, datetime.date):
            out.append(v.isoformat())
        else:
            out.append(str(v))
    return out


def _values_equal(mine, ref: str) -> bool:
    if mine is None:
        return ref in ("", "NULL")
    if isinstance(mine, bool):
        return ref.lower() in (("true", "t", "1") if mine
                               else ("false", "f", "0"))
    if isinstance(mine, (int, decimal.Decimal)):
        try:
            return decimal.Decimal(str(mine)) == decimal.Decimal(ref)
        except decimal.InvalidOperation:
            return False
    if isinstance(mine, float):
        try:
            r = float(ref)
        except ValueError:
            return False
        if mine == r:
            return True
        if math.isnan(mine) and math.isnan(r):
            return True
        # absolute tolerance for catastrophic-cancellation noise around
        # zero (e.g. corr()^2 of uncorrelated data: 0.0 vs 2.7e-33 —
        # both are "zero" computed in different summation orders)
        if abs(mine - r) < 1e-20:
            return True
        denom = max(abs(mine), abs(r), 1e-300)
        return abs(mine - r) / denom < 1e-10
    if isinstance(mine, datetime.datetime):
        return mine.isoformat(sep=" ").startswith(ref) or \
            ref.startswith(mine.isoformat(sep=" "))
    if isinstance(mine, datetime.date):
        return mine.isoformat() == ref
    return str(mine) == ref


def compare_result(rows: List[tuple], ref_rows: List[List[str]],
                   ordered: bool = True) -> Tuple[bool, str]:
    """Compare engine rows against reference string rows."""
    if len(rows) != len(ref_rows):
        return False, f"row count {len(rows)} != {len(ref_rows)}"
    if not ordered:
        rows = sorted(rows, key=lambda r: [str(x) for x in r])
        ref_rows = sorted(ref_rows)
    for i, (r, ref) in enumerate(zip(rows, ref_rows)):
        if len(r) != len(ref):
            return False, f"row {i}: col count {len(r)} != {len(ref)}"
        for j, (v, rv) in enumerate(zip(r, ref)):
            if not _values_equal(v, rv):
                return False, (f"row {i} col {j}: {v!r} != {rv!r} "
                               f"(row={format_row(r)}, ref={ref})")
    return True, "ok"
