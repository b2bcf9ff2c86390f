"""Scalar functions (PyTorch port of ddb_tpu/expr/functions.py).

Date math is branch-free integer arithmetic on days-since-epoch (civil
calendar algorithms).  Everything is tensor code on the batch's device
with no host read, except the two seams that run Python per row:
`__stringify__` and `__pyudf__` fetch their operands, run on the host and
put the result back on the batch's device (one host synchronisation
each; HOST_CALLS counts them).

Floor division and modulo of possibly negative micros go through `_fdiv`
and `torch.remainder`, which floor like jnp's `//` and `%`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import types as T
from ..batch import to_numpy
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


US_DAY = 86_400_000_000

# host round trips made by the per-row seams, by seam name
HOST_CALLS = {"stringify": 0, "pyudf": 0, "dictlookup": 0}


def _gamma(x):
    # exp(lgamma) is |gamma|; gamma is negative on (-1, 0), (-3, -2), ...
    neg = (x < 0) & (torch.remainder(torch.floor(x), 2) == 1)
    g = torch.exp(torch.lgamma(x))
    return torch.where(neg, -g, g)


def _cbrt(x):
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


_MATH1 = {
    "ln": torch.log, "log": torch.log10, "log2": torch.log2,
    "log10": torch.log10, "exp": torch.exp, "sin": torch.sin,
    "cos": torch.cos, "tan": torch.tan, "asin": torch.asin,
    "acos": torch.acos, "atan": torch.atan, "sinh": torch.sinh,
    "cosh": torch.cosh, "tanh": torch.tanh, "sign": torch.sign,
    "radians": torch.deg2rad, "degrees": torch.rad2deg, "cbrt": _cbrt,
    "acosh": torch.acosh, "asinh": torch.asinh, "atanh": torch.atanh,
    "cot": lambda x: 1.0 / torch.tan(x),
    "gamma": _gamma, "lgamma": torch.lgamma, "trunc": torch.trunc,
}

_BOOL_MATH1 = {
    "isnan": torch.isnan, "isinf": torch.isinf,
    "isfinite": torch.isfinite, "signbit": torch.signbit,
}

_FACTORIALS = [math.factorial(i) for i in range(21)]


def _lshr(x, k: int):
    """Logical right shift of int64 bit patterns by 0 < k < 64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _add_months(days, months):
    """days since epoch + months, the day of month clamped to the
    target month's length (reference: Interval::Add, date.cpp
    AddMonths).  int64 days out."""
    y, m, dd = _civil_from_days(days)
    t = y.to(torch.int64) * 12 + (m - 1) + months
    y2 = _fdiv(t, 12)
    m2 = t - y2 * 12 + 1
    one = torch.ones_like(m2)
    ny = torch.where(m2 == 12, y2 + 1, y2)
    nm = torch.where(m2 == 12, one, m2 + 1)
    first = _days_from_civil_dev(y2, m2, one)
    first_next = _days_from_civil_dev(ny, nm, one)
    dd2 = torch.minimum(dd.to(torch.int64), first_next - first)
    return _days_from_civil_dev(y2, m2, dd2)


def _iso_thursday(d):
    """(days of the Thursday of d's ISO week, its year, that year's
    January 1st)."""
    d64 = d.to(torch.int64)
    dow = torch.remainder(d64 + 4, 7)                # Sunday=0
    isodow = torch.where(dow == 0, torch.full_like(dow, 7), dow)
    th = d64 - (isodow - 1) + 3
    ty, _, _ = _civil_from_days(th)
    one = torch.ones_like(ty)
    return th, ty.to(torch.int64), _days_from_civil_dev(ty, one, one)


def _device_table(e, key, values, dtype, device):
    """A small bind-time table as a tensor on `device`, made once a plan
    node and device and kept on the node."""
    cache = e.__dict__.setdefault("_device_tables", {})
    t = cache.get((key, device))
    if t is None:
        t = torch.as_tensor(np.asarray(values), dtype=dtype).to(device)
        cache[(key, device)] = t
    return t


def _runtime_codes(out_sd, texts, lv, out_dtype=np.int32):
    """Fill the runtime dictionary `out_sd` with the distinct live texts
    and return every row's code into it (0 where not live)."""
    uniq = np.unique(texts[lv].astype(str)) if lv.any() \
        else np.array([], dtype=object)
    out_sd.values = uniq.astype(object)
    out_sd._lookup = None
    codes = np.zeros(len(texts), dtype=out_dtype)
    if lv.any():
        codes[lv] = np.searchsorted(uniq, texts[lv].astype(str)) \
            .astype(out_dtype)
    return codes


def _stringify(e, batch, evaluate):
    """temporal -> VARCHAR on unbounded columns: the host formats this
    batch's values, fills the runtime output dictionary and returns
    per-row codes."""
    src_dtype, src_sd, out_sd = e.extra
    d, n = evaluate(e.args[0], batch)
    HOST_CALLS["stringify"] += 1
    a = to_numpy(d)
    lv = to_numpy(batch.sel)
    if n is not None:
        lv = lv & ~to_numpy(n)
    texts = np.empty(len(a), dtype=object)
    texts[:] = ""
    for i in np.nonzero(lv)[0]:
        texts[i] = T.stringify_value(a[i], src_dtype, src_sd)
    codes = _runtime_codes(out_sd, texts, lv)
    return torch.from_numpy(codes).to(d.device), n


def _pyudf(e, batch, evaluate):
    """User-defined scalar function (and the binder's list and lambda
    seams): row-wise evaluation on the host over the fetched operands
    (reference: python UDFs, tools/pythonpkg/src/python_udf.cpp)."""
    fn, arg_dicts = e.extra[0], e.extra[1]
    pass_nulls = len(e.extra) > 2 and e.extra[2]
    out_sd = e.extra[3] if len(e.extra) > 3 else None
    vals, nulls = [], []
    for a in e.args:
        d, nl = evaluate(a, batch)
        vals.append(d)
        nulls.append(nl)
    cap = batch.sel.shape[0]
    dev = batch.device
    out_np = np.dtype(e.dtype.np_dtype)
    stringify = out_sd is not None
    # the function runs only on rows that are selected and (unless
    # pass_nulls) have no NULL argument: one that raises on filtered-out
    # values must not fail the query
    live = batch.sel
    if not pass_nulls:
        for nl in nulls:
            if nl is not None:
                live = live & ~nl
    HOST_CALLS["pyudf"] += 1
    live_np = to_numpy(live)
    cols = []
    for arr, sd in zip(vals, arg_dicts):
        a = to_numpy(arr)
        if sd is not None:
            a = sd.decode(np.clip(a, 0, max(len(sd) - 1, 0))
                          .astype(np.int64))
        cols.append(a)
    ncols = [np.zeros(cap, dtype=bool) if nl is None else to_numpy(nl)
             for nl in nulls] if pass_nulls else []
    outv = np.zeros(cap, dtype=out_np)
    outn = np.zeros(cap, dtype=bool)
    texts = np.empty(cap, dtype=object) if stringify else None
    if stringify:
        texts[:] = ""
    for i, row in enumerate(zip(*cols) if cols else ((),) * cap):
        if not live_np[i]:
            outn[i] = True
            continue
        if pass_nulls:
            v = fn(row, tuple(nc[i] for nc in ncols))
        else:
            v = fn(*row)
        if v is None:
            outn[i] = True
        elif stringify:
            texts[i] = str(v)
        else:
            outv[i] = v
    if stringify:
        outv = _runtime_codes(out_sd, texts, ~outn & live_np, out_np)
    n = torch.from_numpy(outn).to(dev)
    if not pass_nulls:
        for nl in nulls:
            if nl is not None:
                n = n | nl
    return torch.from_numpy(outv).to(dev), n


def dispatch(e: ir.Func, batch, evaluate):
    name = e.name
    i64, f64 = torch.int64, torch.float64

    def arg(i):
        return evaluate(e.args[i], batch)

    if name == "tz_shift":
        # piecewise-constant offset lookup over a small bind-time
        # transition table
        d, n = arg(0)
        bounds, delta = e.extra
        # the first bound stands for minus infinity (it wraps when the
        # zone table is scaled to micros)
        bounds = np.concatenate([[np.iinfo(np.int64).min], bounds[1:]])
        tb = _device_table(e, "bounds", bounds, i64, d.device)
        td = _device_table(e, "delta", delta, i64, d.device)
        idx = torch.searchsorted(tb, d.to(i64).contiguous(), right=True) - 1
        return d + td[torch.clamp(idx, 0, len(delta) - 1)], n
    if name == "timetz_from_tz":
        # (wall micros in the connection's zone, utc micros) -> packed
        # TIMETZ carrying that zone's offset at that instant
        w, n1 = arg(0)
        u, n2 = arg(1)
        off = _fdiv(w - u, 1_000_000)
        tod = torch.remainder(w, US_DAY)
        return (tod - off * 1_000_000) * 131072 + (57599 - off), _or(n1, n2)
    if name == "__stringify__":
        return _stringify(e, batch, evaluate)
    if name == "__pyudf__":
        return _pyudf(e, batch, evaluate)
    if name == "floordiv_pow52":
        d, n = arg(0)
        return _fdiv(d.to(i64), 1 << 52), n
    if name == "bit_count":
        # SWAR popcount of the two's-complement pattern at the declared
        # width, on int64 bit patterns (torch has no uint64 arithmetic on
        # every device; the multiply wraps as uint64's does)
        d, n = arg(0)
        w = {T.TypeId.TINYINT: 8, T.TypeId.SMALLINT: 16,
             T.TypeId.INTEGER: 32}.get(e.args[0].dtype.id, 64)
        v = d.to(i64)
        if w < 64:
            v = v & ((1 << w) - 1)
        v = v - (_lshr(v, 1) & 0x5555555555555555)
        v = (v & 0x3333333333333333) + (_lshr(v, 2) & 0x3333333333333333)
        v = (v + _lshr(v, 4)) & 0x0F0F0F0F0F0F0F0F
        return _lshr(v * 0x0101010101010101, 56), n
    if name == "months_between_us":
        # whole calendar months from b (arg1) to a (arg0), both
        # timestamp micros: months then clamped so b + months <= a
        # (reference: Interval::GetAge, src/common/types/interval.cpp)
        a_us, n1 = arg(0)
        b_us, n2 = arg(1)
        ad, bd = _fdiv(a_us, US_DAY), _fdiv(b_us, US_DAY)
        ay, am, _ = _civil_from_days(ad)
        by, bm, _ = _civil_from_days(bd)
        months = (ay.to(i64) - by) * 12 + (am - bm)
        sign = torch.where(a_us >= b_us, 1, -1)
        # step months toward b while the anchor overshoots a
        for _ in range(2):
            anchor = _add_months(bd, months) * US_DAY + (b_us - bd * US_DAY)
            over = torch.where(sign > 0, anchor > a_us, anchor < a_us)
            months = months - torch.where(over, sign, 0)
        return months, _or(n1, n2)
    if name == "add_months_dyn_us":
        # timestamp micros + per-row month count
        ts, n1 = arg(0)
        months, n2 = arg(1)
        days = _fdiv(ts, US_DAY)
        return _add_months(days, months) * US_DAY + (ts - days * US_DAY), \
            _or(n1, n2)
    if name in ("add_months_days", "add_months_us"):
        d, n = arg(0)
        months = int(e.extra)
        if name == "add_months_us":
            days = _fdiv(d, US_DAY)
            return _add_months(days, months) * US_DAY \
                + (d - days * US_DAY), n
        return _add_months(d, months).to(torch.int32), n
    if name in ("year", "month", "day", "quarter"):
        d, n = arg(0)
        y, m, dd = _civil_from_days(d)
        if name == "quarter":
            return (_fdiv(m - 1, 3) + 1).to(i64), n
        return {"year": y, "month": m, "day": dd}[name].to(i64), n
    if name in ("dayofweek", "isodow"):
        d, n = arg(0)
        # 1970-01-01 was a Thursday (dow 4 with Sunday=0)
        dow = torch.remainder(d.to(i64) + 4, 7)
        if name == "isodow":
            dow = torch.where(dow == 0, torch.full_like(dow, 7), dow)
        return dow, n
    if name in ("date_trunc_year", "date_trunc_month"):
        d, n = arg(0)
        y, m, _ = _civil_from_days(d)
        if name == "date_trunc_year":
            m = torch.ones_like(m)
        return _days_from_civil_dev(y, m, torch.ones_like(m)) \
            .to(torch.int32), n
    if name == "date_trunc_week":
        # ISO week starts Monday; 1970-01-01 was a Thursday
        d, n = arg(0)
        dd = d.to(i64)
        return (dd - torch.remainder(dd + 3, 7)).to(d.dtype), n
    if name == "abs":
        d, n = arg(0)
        return torch.abs(d), n
    if name == "rowid":
        return torch.arange(batch.sel.shape[0], dtype=i64,
                            device=batch.device), None
    if name == "random":
        g = torch.Generator(device=batch.device)
        g.manual_seed(int(e.extra or 0) & 0x7FFFFFFF)
        return torch.rand(batch.sel.shape[0], dtype=f64, generator=g,
                          device=batch.device), None
    if name == "round":
        d, n = arg(0)
        if e.args[0].dtype.id == T.TypeId.DECIMAL:
            # handled at bind time as a decimal cast; here: identity
            return d, n
        f = 10.0 ** (e.extra or 0)
        return torch.round(d * f) / f, n
    if name in ("floor", "ceil"):
        d, n = arg(0)
        return (torch.floor if name == "floor" else torch.ceil)(d), n
    if name == "sqrt":
        d, n = arg(0)
        return torch.sqrt(d.to(f64)), n
    if name in _MATH1:
        d, n = arg(0)
        return _MATH1[name](d.to(f64)), n
    if name in _BOOL_MATH1:
        d, n = arg(0)
        return _BOOL_MATH1[name](d.to(f64)), n
    if name in ("atan2", "nextafter"):
        a, an = arg(0)
        b, bn = arg(1)
        fn = torch.atan2 if name == "atan2" else torch.nextafter
        return fn(a.to(f64), b.to(f64)), _or(an, bn)
    if name in ("gcd", "lcm"):
        a, an = arg(0)
        b, bn = arg(1)
        aa, bb = torch.abs(a.to(i64)), torch.abs(b.to(i64))
        g = torch.gcd(aa, bb)
        if name == "gcd":
            return g, _or(an, bn)
        return torch.where(g == 0, 0, _fdiv(aa, torch.clamp(g, min=1)) * bb), \
            _or(an, bn)
    if name == "factorial":
        d, n = arg(0)
        table = _device_table(e, "factorial", _FACTORIALS, i64, d.device)
        return table[torch.clamp(d.to(i64), 0, 20)], n
    if name == "even":
        # round to the next even number away from zero
        d, n = arg(0)
        x = d.to(f64)
        return torch.sign(x) * torch.ceil(torch.abs(x) / 2.0) * 2.0, n
    if name == "to_timestamp":
        # seconds (double) since epoch -> TIMESTAMP micros
        d, n = arg(0)
        return torch.floor(d.to(f64) * 1e6).to(i64), n
    if name == "make_date":
        (y, yn), (m, mn), (d, dn) = arg(0), arg(1), arg(2)
        return _days_from_civil_dev(y, m, d).to(torch.int32), \
            _or(yn, mn, dn)
    if name == "make_time":
        (h, hn), (m, mn), (s, sn) = arg(0), arg(1), arg(2)
        us = (h.to(i64) * 3600 + m.to(i64) * 60) * 1_000_000 \
            + torch.floor(s.to(f64) * 1e6).to(i64)
        return us, _or(hn, mn, sn)
    if name == "make_timestamp":
        if len(e.args) == 1:
            return arg(0)                       # micros passthrough
        vals, ns = zip(*(arg(i) for i in range(6)))
        y, m, d, h, mi, s = vals
        us = _days_from_civil_dev(y, m, d) * US_DAY \
            + (h.to(i64) * 3600 + mi.to(i64) * 60) * 1_000_000 \
            + torch.floor(s.to(f64) * 1e6).to(i64)
        return us, _or(*ns)
    if name == "time_bucket":
        # time_bucket(width_us, ts[, origin]): floor to width boundary
        d, n = arg(0)
        width, origin = e.extra
        dd = d.to(i64) - origin
        return (dd - torch.remainder(dd, width)) + origin, n
    if name in ("pow", "power"):
        a, an = arg(0)
        b, bn = arg(1)
        return torch.pow(a.to(f64), b.to(f64)), _or(an, bn)
    if name == "coalesce":
        out_d, out_n = arg(0)
        for a in e.args[1:]:
            d, n = evaluate(a, batch)
            if out_n is None:
                break
            out_d = torch.where(out_n, d.to(out_d.dtype), out_d)
            out_n = (out_n & n) if n is not None else None
        return out_d, out_n
    if name in ("least", "greatest"):
        fn = torch.minimum if name == "least" else torch.maximum
        out_d, out_n = arg(0)
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
        a, an = arg(0)
        b, bn = arg(1)
        eq = a == b
        if bn is not None:
            eq = eq & ~bn
        return a, _or(an, eq)
    if name == "ifnull":
        a, an = arg(0)
        b, bn = arg(1)
        if an is None:
            return a, None
        return torch.where(an, b.to(a.dtype), a), \
            (an & bn) if bn is not None else None
    if name == "ts_date":
        # TIMESTAMP (micros) -> DATE (days), floor division
        d, n = arg(0)
        return _fdiv(d.to(i64), US_DAY).to(torch.int32), n
    if name == "ts_trunc":
        # truncate TIMESTAMP micros to the granularity in e.extra
        d, n = arg(0)
        dd = d.to(i64)
        return dd - torch.remainder(dd, int(e.extra)), n
    if name in ("ts_minute", "ts_hour", "ts_second", "ts_millisecond",
                "ts_microsecond"):
        d, n = arg(0)
        us_in_day = torch.remainder(d.to(i64), US_DAY)
        if name == "ts_hour":
            return _fdiv(us_in_day, 3_600_000_000), n
        if name == "ts_minute":
            return torch.remainder(_fdiv(us_in_day, 60_000_000), 60), n
        if name == "ts_second":
            return torch.remainder(_fdiv(us_in_day, 1_000_000), 60), n
        if name == "ts_millisecond":
            # seconds+ms field, i.e. ms within the minute
            return _fdiv(torch.remainder(us_in_day, 60_000_000), 1_000), n
        return torch.remainder(us_in_day, 60_000_000), n
    if name == "dayofyear":
        d, n = arg(0)
        y, _, _ = _civil_from_days(d)
        one = torch.ones_like(y)
        return d.to(i64) - _days_from_civil_dev(y, one, one) + 1, n
    if name in ("week", "isoyear", "yearweek"):
        # ISO week/year via the Thursday of the date's ISO week
        d, n = arg(0)
        th, ty, jan1 = _iso_thursday(d)
        if name == "isoyear":
            return ty, n
        week = _fdiv(th - jan1, 7) + 1
        return (week if name == "week" else ty * 100 + week), n
    if name == "last_day":
        d, n = arg(0)
        y, m, _ = _civil_from_days(d)
        ny = torch.where(m == 12, y + 1, y)
        nm = torch.where(m == 12, torch.ones_like(m), m + 1)
        first_next = _days_from_civil_dev(ny, nm, torch.ones_like(nm))
        return (first_next - 1).to(torch.int32), n
    if name in ("century", "decade", "millennium"):
        d, n = arg(0)
        y = _civil_from_days(d)[0].to(i64)
        if name == "decade":
            return _fdiv(y, 10), n
        if name == "century":
            return _fdiv(y + 99, 100), n
        return _fdiv(y + 999, 1000), n
    if name == "epoch_raw":
        # exact integer micros/millis/nanos since epoch
        d, n = arg(0)
        us = d.to(i64)
        if e.args[0].dtype.id == T.TypeId.DATE:
            us = us * US_DAY       # TIMESTAMP/TIME/INTERVAL are micros
        if e.extra == "epoch_ms":
            return _fdiv(us, 1000), n
        if e.extra == "epoch_ns":
            return us * 1000, n
        return us, n
    if name in ("epoch", "epoch_ms"):
        d, n = arg(0)
        src = e.args[0].dtype
        secs = d.to(i64)
        if src.id == T.TypeId.DATE:
            secs = secs * 86400
        elif src.id == T.TypeId.TIMESTAMP:
            secs = _fdiv(secs, 1_000_000)
        return (secs * 1000 if name == "epoch_ms" else secs), n
    raise NotImplementedError(f"scalar function {name}")
