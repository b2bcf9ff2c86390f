"""Scalar functions (PyTorch port of ddb_tpu/expr/functions.py).

Date math is branch-free integer arithmetic on days-since-epoch (civil
calendar algorithms).  This slice ports the date-part, rounding and
NULL-handling functions; every other function raises NotImplementedError
with its name.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import types as T
from . import ir


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _civil_from_days(z):
    """days since 1970-01-01 -> (year, month, day) as int32 tensors."""
    z = z.to(torch.int64) + 719468
    era = _fdiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097                                    # [0, 146096]
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))  # [0, 365]
    mp = _fdiv(5 * doy + 2, 153)                              # [0, 11]
    d = doy - _fdiv(153 * mp + 2, 5) + 1                      # [1, 31]
    m = torch.where(mp < 10, mp + 3, mp - 9)                  # [1, 12]
    y = torch.where(m <= 2, y + 1, y)
    return y.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def days_from_civil(y, m, d):
    """(y, m, d) -> days since 1970-01-01 (host, numpy)."""
    y = np.asarray(y, dtype=np.int64)
    m = np.asarray(m, dtype=np.int64)
    d = np.asarray(d, dtype=np.int64)
    y = y - (m <= 2)
    era = np.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (np.where(m > 2, m - 3, m + 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def add_months_host(days: int, months: int) -> int:
    """Host-side date + INTERVAL n MONTH (duckdb clamps day-of-month)."""
    import datetime
    base = datetime.date(1970, 1, 1) + datetime.timedelta(days=int(days))
    y = base.year + (base.month - 1 + months) // 12
    m = (base.month - 1 + months) % 12 + 1
    # clamp day to end of month
    for dd in (base.day, 30, 29, 28):
        try:
            nd = datetime.date(y, m, dd)
            break
        except ValueError:
            continue
    return (nd - datetime.date(1970, 1, 1)).days


def _days_from_civil_dev(y, m, d):
    """Device version of days_from_civil (int64 tensors)."""
    y, m, d = (x.to(torch.int64) for x in (y, m, d))
    y = y - (m <= 2).to(torch.int64)
    era = _fdiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    doy = _fdiv(153 * torch.where(m > 2, m - 3, m + 9) + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _or(*masks):
    out = None
    for x in masks:
        if x is not None:
            out = x if out is None else (out | x)
    return out


_MATH1 = {
    "ln": torch.log, "log": torch.log10, "log2": torch.log2,
    "log10": torch.log10, "exp": torch.exp, "sign": torch.sign,
    "trunc": torch.trunc,
}


def dispatch(e: ir.Func, batch, evaluate):
    name = e.name
    if name in ("year", "month", "day", "quarter"):
        d, n = evaluate(e.args[0], batch)
        y, m, dd = _civil_from_days(d)
        if name == "quarter":
            return (_fdiv(m - 1, 3) + 1).to(torch.int64), n
        return {"year": y, "month": m, "day": dd}[name].to(torch.int64), n
    if name in ("dayofweek", "isodow"):
        d, n = evaluate(e.args[0], batch)
        # 1970-01-01 was a Thursday (dow 4 with Sunday=0)
        dow = torch.remainder(d.to(torch.int64) + 4, 7)
        if name == "isodow":
            dow = torch.where(dow == 0, torch.full_like(dow, 7), dow)
        return dow, n
    if name in ("date_trunc_year", "date_trunc_month"):
        d, n = evaluate(e.args[0], batch)
        y, m, _ = _civil_from_days(d)
        if name == "date_trunc_year":
            m = torch.ones_like(m)
        return _days_from_civil_dev(y, m, torch.ones_like(m)) \
            .to(torch.int32), n
    if name == "abs":
        d, n = evaluate(e.args[0], batch)
        return torch.abs(d), n
    if name == "round":
        d, n = evaluate(e.args[0], batch)
        if e.args[0].dtype.id == T.TypeId.DECIMAL:
            # handled at bind time as a decimal cast; here: identity
            return d, n
        f = 10.0 ** (e.extra or 0)
        return torch.round(d * f) / f, n
    if name in ("floor", "ceil"):
        d, n = evaluate(e.args[0], batch)
        return (torch.floor if name == "floor" else torch.ceil)(d), n
    if name == "sqrt":
        d, n = evaluate(e.args[0], batch)
        return torch.sqrt(d.to(torch.float64)), n
    if name in _MATH1:
        d, n = evaluate(e.args[0], batch)
        return _MATH1[name](d.to(torch.float64)), n
    if name in ("pow", "power"):
        a, an = evaluate(e.args[0], batch)
        b, bn = evaluate(e.args[1], batch)
        return torch.pow(a.to(torch.float64), b.to(torch.float64)), \
            _or(an, bn)
    if name == "coalesce":
        out_d, out_n = evaluate(e.args[0], batch)
        for a in e.args[1:]:
            d, n = evaluate(a, batch)
            if out_n is None:
                break
            out_d = torch.where(out_n, d.to(out_d.dtype), out_d)
            out_n = (out_n & n) if n is not None else None
        return out_d, out_n
    if name in ("least", "greatest"):
        fn = torch.minimum if name == "least" else torch.maximum
        out_d, out_n = evaluate(e.args[0], batch)
        for a in e.args[1:]:
            d, n = evaluate(a, batch)
            # NULLs are ignored (SQL least/greatest semantics)
            both = fn(out_d, d)
            if out_n is not None:
                both = torch.where(out_n, d, both)
            if n is not None:
                both = torch.where(n & ~(out_n if out_n is not None
                                         else torch.zeros_like(n)),
                                   out_d, both)
            out_d = both
            out_n = (out_n & n) if (out_n is not None and n is not None) \
                else None
        return out_d, out_n
    if name == "nullif":
        a, an = evaluate(e.args[0], batch)
        b, bn = evaluate(e.args[1], batch)
        eq = a == b
        if bn is not None:
            eq = eq & ~bn
        return a, _or(an, eq)
    if name == "ifnull":
        a, an = evaluate(e.args[0], batch)
        b, bn = evaluate(e.args[1], batch)
        if an is None:
            return a, None
        return torch.where(an, b.to(a.dtype), a), \
            (an & bn) if bn is not None else None
    raise NotImplementedError(name)
