"""Logical/physical type system.

TPU-native analog of the reference's LogicalType/PhysicalType split
(reference: src/include/duckdb/common/types.hpp:63-234).  SQL-level types
(DECIMAL, DATE, VARCHAR, ...) map onto a small set of dense jnp dtypes that
tile well on TPU:

  BOOLEAN            -> bool_
  TINYINT/SMALLINT/
  INTEGER            -> int32   (narrow ints widened; int8/int16 tile poorly)
  BIGINT             -> int64
  FLOAT              -> float32
  DOUBLE             -> float64 (kept OFF the hot path; final divisions happen
                                 host-side for bit-exactness)
  DECIMAL(w<=18, s)  -> int64 fixed-point, value * 10^s
  DATE               -> int32 days since 1970-01-01
  TIMESTAMP          -> int64 micros since epoch
  VARCHAR            -> int32 dictionary code (sorted dict => code order ==
                        string order; see storage/strings.py)

There are no pointers/var-len payloads on device: strings live as codes, the
dictionaries stay on host (reference uses FSST/dict compression similarly,
src/storage/compression/).
"""

from __future__ import annotations

import datetime
import decimal
import enum
from dataclasses import dataclass, field

import numpy as np


class TypeId(enum.Enum):
    INVALID = 0
    BOOLEAN = 1
    TINYINT = 2
    SMALLINT = 3
    INTEGER = 4
    BIGINT = 5
    HUGEINT = 6
    FLOAT = 7
    DOUBLE = 8
    DECIMAL = 9
    DATE = 10
    TIME = 11
    TIMESTAMP = 12
    INTERVAL = 13
    VARCHAR = 14
    NULL = 15
    LIST = 16
    STRUCT = 17
    MAP = 18
    BLOB = 19
    UUID = 20
    UNION = 21
    TIMESTAMPTZ = 22
    TIMETZ = 23


_INT_IDS = (TypeId.TINYINT, TypeId.SMALLINT, TypeId.INTEGER, TypeId.BIGINT,
            TypeId.HUGEINT)


@dataclass(frozen=True)
class DataType:
    id: TypeId
    width: int = 0   # decimal precision
    scale: int = 0   # decimal scale
    child: "DataType" = None   # LIST element / MAP key type
    child2: "DataType" = None  # MAP value type
    children: tuple = None     # STRUCT fields: ((name, DataType), ...)

    # ---- constructors ----------------------------------------------------
    def __repr__(self) -> str:
        if self.id == TypeId.DECIMAL:
            return f"DECIMAL({self.width},{self.scale})"
        if self.id == TypeId.LIST:
            return f"{self.child!r}[]"
        if self.id == TypeId.UNION:
            inner = ", ".join(f"{n} {t!r}" for n, t in
                              (self.children or ()))
            return f"UNION({inner})"
        if self.id == TypeId.STRUCT:
            inner = ", ".join(f"{n} {t!r}" for n, t in
                              (self.children or ()))
            return f"STRUCT({inner})"
        if self.id == TypeId.MAP:
            return f"MAP({self.child!r}, {self.child2!r})"
        if self.id == TypeId.TIMESTAMPTZ:
            return "TIMESTAMP WITH TIME ZONE"
        if self.id == TypeId.TIMETZ:
            return "TIME WITH TIME ZONE"
        return self.id.name

    # ---- classification --------------------------------------------------
    @property
    def is_integer(self) -> bool:
        return self.id in _INT_IDS

    @property
    def is_numeric(self) -> bool:
        return self.is_integer or self.id in (
            TypeId.FLOAT, TypeId.DOUBLE, TypeId.DECIMAL)

    @property
    def is_string(self) -> bool:
        return self.id == TypeId.VARCHAR

    @property
    def is_temporal(self) -> bool:
        return self.id in (TypeId.DATE, TypeId.TIME, TypeId.TIMESTAMP,
                           TypeId.TIMESTAMPTZ, TypeId.TIMETZ)

    @property
    def is_wide(self) -> bool:
        """Values may exceed int64: columns of this type may carry a second
        (high) limb; value = hi * 2^32 + lo (lo unsigned 32-bit in an int64
        lane).  DECIMAL(w>18) and HUGEINT (reference: hugeint.cpp i128)."""
        return (self.id == TypeId.DECIMAL and self.width > 18) \
            or self.id == TypeId.HUGEINT

    # ---- physical mapping ------------------------------------------------
    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(_PHYSICAL[self.id])

    def __hash__(self):
        return hash((self.id, self.width, self.scale, self.child,
                     self.child2, self.children))


_PHYSICAL = {
    TypeId.BOOLEAN: np.bool_,
    TypeId.TINYINT: np.int32,
    TypeId.SMALLINT: np.int32,
    TypeId.INTEGER: np.int32,
    TypeId.BIGINT: np.int64,
    TypeId.HUGEINT: np.int64,    # TODO(i128): two-limb representation
    TypeId.FLOAT: np.float32,
    TypeId.DOUBLE: np.float64,
    TypeId.DECIMAL: np.int64,
    TypeId.DATE: np.int32,
    TypeId.TIME: np.int64,
    TypeId.TIMESTAMP: np.int64,
    TypeId.TIMESTAMPTZ: np.int64,   # UTC instant, micros since epoch
    TypeId.TIMETZ: np.int64,   # utc_micros * 2^17 + (57599 - offset_sec):
                               # raw order = UTC instant, ties broken by
                               # DESCENDING offset (matches the reference's
                               # dtime_tz comparison semantics)
    TypeId.INTERVAL: np.int64,   # micros; months handled at bind time
    TypeId.VARCHAR: np.int32,    # dictionary code
    TypeId.NULL: np.int32,
    TypeId.LIST: np.int32,       # list-store id (storage/lists.py)
    TypeId.STRUCT: np.int32,     # struct-store id (storage/nested.py)
    TypeId.UNION: np.int32,      # union-store id (storage/nested.py)
    TypeId.MAP: np.int32,        # map-store id (storage/nested.py)
    TypeId.BLOB: np.int32,       # blob-store id (dictionary of bytes)
    TypeId.UUID: np.int32,       # dictionary code (like VARCHAR)
}


def LIST(child: DataType) -> DataType:
    """Nested LIST type; rows hold list-store ids, element payloads live
    host-side (reference: LogicalType::LIST, src/common/types.cpp;
    var-size payloads have no device representation on TPU by design)."""
    return DataType(TypeId.LIST, child=child)


def STRUCT(fields) -> DataType:
    """Nested STRUCT type; rows hold struct-store ids (reference:
    LogicalType::STRUCT, src/common/types.cpp).  fields: iterable of
    (name, DataType)."""
    return DataType(TypeId.STRUCT, children=tuple(
        (str(n), t) for n, t in fields))


def MAP(key: DataType, value: DataType) -> DataType:
    """MAP type; rows hold map-store ids (reference: LogicalType::MAP)."""
    return DataType(TypeId.MAP, child=key, child2=value)


def UNION(members) -> DataType:
    """Tagged UNION type; rows hold union-store ids (reference:
    LogicalType::UNION, src/common/types.cpp + union_type.cpp).
    members: iterable of (name, DataType)."""
    return DataType(TypeId.UNION, children=tuple(
        (str(n), t) for n, t in members))

BOOLEAN = DataType(TypeId.BOOLEAN)
TINYINT = DataType(TypeId.TINYINT)
SMALLINT = DataType(TypeId.SMALLINT)
INTEGER = DataType(TypeId.INTEGER)
BIGINT = DataType(TypeId.BIGINT)
HUGEINT = DataType(TypeId.HUGEINT)
FLOAT = DataType(TypeId.FLOAT)
DOUBLE = DataType(TypeId.DOUBLE)
DATE = DataType(TypeId.DATE)
TIME = DataType(TypeId.TIME)
TIMESTAMP = DataType(TypeId.TIMESTAMP)
TIMESTAMPTZ = DataType(TypeId.TIMESTAMPTZ)
TIMETZ = DataType(TypeId.TIMETZ)


_TIMETZ_MAX_OFF = 57599            # +/- 15:59:59 like the reference


class Hour24Time(datetime.time):
    """The valid DuckDB TIME value 24:00:00, which datetime.time cannot
    represent — renders as 24:00:00, compares as midnight."""

    def __new__(cls, tzinfo=None):
        return super().__new__(cls, 0, 0, 0, 0, tzinfo)

    def isoformat(self, *a):
        return "24:00:00"

    def __str__(self):
        return "24:00:00"

    def replace(self, *a, **kw):
        if set(kw) <= {"tzinfo"} and not a:
            return Hour24Time(kw.get("tzinfo"))
        return datetime.time(0, 0).replace(*a, **kw)


def timetz_pack(wall_us: int, offset_sec: int) -> int:
    utc = wall_us - offset_sec * 1_000_000
    return utc * 131072 + (_TIMETZ_MAX_OFF - offset_sec)


def timetz_unpack(raw: int):
    utc, enc = divmod(int(raw), 131072)
    off = _TIMETZ_MAX_OFF - enc
    return utc + off * 1_000_000, off


import re as _re

_TIME_RE = _re.compile(
    r"^(\d{1,2}):(\d{0,2})(?::(\d{0,2})(\.\d+)?)?"
    r"(?:\s*([+-])(\d{2})(?::?(\d{2}))?(?::?(\d{2}))?)?$")


def parse_time_text(text: str):
    """HH:MM[:SS[.ffffff]][±HH[:MM[:SS]]] -> (wall_us, offset_sec|None).
    Accepts hour 24, empty minutes ('11:'), and compact ±HHMM offsets
    (reference: Time::TryConvertTime / dtime_tz parsing)."""
    txt = str(text).strip()
    m = _TIME_RE.match(txt)
    if m is None:
        # date / timestamp strings cast to their time-of-day (reference:
        # Time::TryConvertTime falls back through timestamp parsing;
        # date-only strings yield midnight)
        import datetime as _dt
        for fmt in ("%Y-%m-%d %H:%M:%S", "%Y-%m-%d", "%m/%d/%Y",
                    "%m/%d/%y"):
            try:
                dt = _dt.datetime.strptime(txt, fmt)
                us = ((dt.hour * 60 + dt.minute) * 60 + dt.second) \
                    * 1_000_000 + dt.microsecond
                return us, None
            except ValueError:
                continue
        try:
            dt = _dt.datetime.fromisoformat(txt)
            us = ((dt.hour * 60 + dt.minute) * 60 + dt.second) \
                * 1_000_000 + dt.microsecond
            return us, None
        except ValueError:
            pass
        raise ValueError(f"invalid time '{text}'")
    h = int(m.group(1))
    mi = int(m.group(2) or 0)
    se = int(m.group(3) or 0)
    frac = m.group(4)
    # fraction TRUNCATES past micros (reference: Time::TryConvertTime)
    us = int((frac[1:] + "000000")[:6]) if frac else 0
    if h > 24 or mi > 59 or se > 59 or (h == 24 and (mi or se or us)):
        raise ValueError(f"invalid time '{text}'")
    wall = ((h * 60 + mi) * 60 + se) * 1_000_000 + us
    off = None
    if m.group(5):
        sign = -1 if m.group(5) == "-" else 1
        oh = int(m.group(6))
        om = int(m.group(7) or 0)
        os_ = int(m.group(8) or 0)
        off = sign * (oh * 3600 + om * 60 + os_)
        if abs(off) > _TIMETZ_MAX_OFF:
            raise ValueError(f"time offset out of range '{text}'")
    return wall, off


def parse_timetz_text(text: str) -> int:
    import datetime
    txt = str(text).strip()
    try:
        wall, off = parse_time_text(txt)
        return timetz_pack(wall, off or 0)
    except ValueError:
        pass
    # timestamp strings cast by their time-of-day (reference:
    # CastTimestampToTimeTz)
    tm = datetime.datetime.fromisoformat(txt).timetz()
    us = ((tm.hour * 60 + tm.minute) * 60 + tm.second) * 1_000_000 \
        + tm.microsecond
    off = 0
    if tm.tzinfo is not None:
        off = int(tm.tzinfo.utcoffset(None).total_seconds())
    return timetz_pack(us, off)


def format_timetz(raw: int) -> str:
    wall, off = timetz_unpack(int(raw))
    wall %= 86_400_000_000
    s, us = divmod(wall, 1_000_000)
    h, s = divmod(s, 3600)
    m, s = divmod(s, 60)
    t = f"{h:02d}:{m:02d}:{s:02d}"
    if us:
        t += f".{us:06d}".rstrip("0")
    sign = "+" if off >= 0 else "-"
    ao = abs(off)
    oh, rem = divmod(ao, 3600)
    om, os_ = divmod(rem, 60)
    t += f"{sign}{oh:02d}"
    if om or os_:
        t += f":{om:02d}"
    if os_:
        t += f":{os_:02d}"
    return t
INTERVAL = DataType(TypeId.INTERVAL)
VARCHAR = DataType(TypeId.VARCHAR)
SQLNULL = DataType(TypeId.NULL)
BLOB = DataType(TypeId.BLOB)
UUID = DataType(TypeId.UUID)


def DECIMAL(width: int, scale: int) -> DataType:
    # widths 19..38 are "wide": sums/values beyond int64 carry a second
    # limb column (see DataType.is_wide, ops/aggregate.py wide sums)
    return DataType(TypeId.DECIMAL, min(width, 38), scale)


_EPOCH = datetime.date(1970, 1, 1)


def td_micros(delta: "datetime.timedelta") -> int:
    """Exact integer micros of a timedelta (float total_seconds()
    loses precision past ~2^53 us ≈ year 2255)."""
    return (delta.days * 86_400_000_000 + delta.seconds * 1_000_000
            + delta.microseconds)

# Order used for implicit-cast promotion between numeric types
# (reference: src/function/cast_rules.cpp implicit cast cost matrix).
_NUMERIC_ORDER = [TypeId.TINYINT, TypeId.SMALLINT, TypeId.INTEGER,
                  TypeId.BIGINT, TypeId.HUGEINT, TypeId.DECIMAL,
                  TypeId.FLOAT, TypeId.DOUBLE]


def max_numeric(a: DataType, b: DataType) -> DataType:
    """Common promoted type for a binary numeric op (duckdb-style)."""
    if a == b:
        return a
    ia, ib = _NUMERIC_ORDER.index(a.id), _NUMERIC_ORDER.index(b.id)
    hi, lo = (a, b) if ia >= ib else (b, a)
    if hi.id == TypeId.DECIMAL:
        if lo.id == TypeId.DECIMAL:
            scale = max(a.scale, b.scale)
            width = max(a.width - a.scale, b.width - b.scale) + scale
            return DECIMAL(width, scale)
        # integer + decimal -> decimal with enough integral digits
        return DECIMAL(18, hi.scale)
    return hi


def decimal_scale_factor(n: int) -> int:
    return 10 ** n


def literal_type(v) -> DataType:
    if v is None:
        return SQLNULL
    if isinstance(v, bool):
        return BOOLEAN
    if isinstance(v, int):
        return INTEGER if -2**31 <= v < 2**31 else BIGINT
    if isinstance(v, float):
        return DOUBLE
    if isinstance(v, decimal.Decimal):
        sign, digits, exp = v.as_tuple()
        scale = max(0, -exp)
        return DECIMAL(max(len(digits), scale + 1), scale)
    if isinstance(v, str):
        return VARCHAR
    if isinstance(v, datetime.date) and not isinstance(v, datetime.datetime):
        return DATE
    if isinstance(v, datetime.datetime):
        return TIMESTAMP
    raise TypeError(f"unsupported literal {v!r}")


def encode_literal(v, t: DataType):
    """Python value -> raw physical value for device use."""
    if v is None:
        return 0
    if t.id == TypeId.DECIMAL:
        d = decimal.Decimal(str(v))
        return int((d * decimal_scale_factor(t.scale)).to_integral_value())
    if t.id == TypeId.DATE:
        if isinstance(v, str):
            sp = temporal_special(v, t)
            if sp is not None:
                return sp
            v = datetime.date.fromisoformat(v)
        if v == datetime.date.max:
            return DATE_INF
        if v == datetime.date.min:
            return DATE_NINF
        return (v - _EPOCH).days
    if t.id in (TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ):
        if isinstance(v, str):
            sp = temporal_special(v, t)
            if sp is not None:
                return sp
            v = datetime.datetime.fromisoformat(v)
        if v.replace(tzinfo=None) == datetime.datetime.max:
            return TS_INF
        if v.replace(tzinfo=None) == datetime.datetime.min:
            return TS_NINF
        if v.tzinfo is not None:
            # aware -> UTC instant (exact integer micros; float
            # total_seconds() loses precision past ~2^53 us)
            d = v - datetime.datetime(1970, 1, 1,
                                      tzinfo=datetime.timezone.utc)
        else:
            d = v - datetime.datetime(1970, 1, 1)
        return td_micros(d)
    if t.id == TypeId.TIME:
        if isinstance(v, str):
            wall, _off = parse_time_text(v)
            return wall
        if isinstance(v, datetime.time):
            return ((v.hour * 60 + v.minute) * 60 + v.second) \
                * 1_000_000 + v.microsecond
        return int(v)
    if t.id == TypeId.TIMETZ:
        if isinstance(v, str):
            return parse_timetz_text(v)
        if isinstance(v, datetime.time):
            us = ((v.hour * 60 + v.minute) * 60 + v.second) \
                * 1_000_000 + v.microsecond
            off = 0
            if v.tzinfo is not None:
                off = int(v.tzinfo.utcoffset(None).total_seconds())
            return timetz_pack(us, off)
        return int(v)
    if t.id == TypeId.INTERVAL:
        if isinstance(v, str):
            return parse_interval_text(v)
        if isinstance(v, datetime.timedelta):
            return td_micros(v)
        if isinstance(v, Interval):
            return interval_pack(v.months, v.micros)
        return int(v)
    if t.id == TypeId.BOOLEAN:
        return bool(v)
    if t.id in (TypeId.FLOAT, TypeId.DOUBLE):
        return float(v)
    return int(v)


# infinity sentinels (reference: date_t/timestamp_t infinity,
# src/include/duckdb/common/types/date.hpp) — surfaced to Python as
# date/datetime max/min like the reference client
DATE_INF = 2 ** 31 - 1
DATE_NINF = -(2 ** 31 - 1)
TS_INF = 2 ** 63 - 1
TS_NINF = -(2 ** 63 - 1)


def temporal_special(text, t: DataType):
    """'infinity' / '-infinity' / 'epoch' literals -> sentinel raw
    value, or None if not special."""
    s = text.strip().lower()
    if s in ("infinity", "+infinity", "inf"):
        return DATE_INF if t.id == TypeId.DATE else TS_INF
    if s in ("-infinity", "-inf"):
        return DATE_NINF if t.id == TypeId.DATE else TS_NINF
    if s == "epoch":
        return 0
    return None


def decode_value(raw, t: DataType, strdict=None):
    """Physical value -> Python value (for result materialization)."""
    if t.id == TypeId.DECIMAL:
        return decimal.Decimal(int(raw)).scaleb(-t.scale)
    if t.id == TypeId.DATE:
        if int(raw) >= DATE_INF:
            return datetime.date.max
        if int(raw) <= DATE_NINF:
            return datetime.date.min
        return _EPOCH + datetime.timedelta(days=int(raw))
    if t.id == TypeId.TIMESTAMP:
        if int(raw) >= TS_INF:
            return datetime.datetime.max
        if int(raw) <= TS_NINF:
            return datetime.datetime.min
        return datetime.datetime(1970, 1, 1) \
            + datetime.timedelta(microseconds=int(raw))
    if t.id == TypeId.TIMESTAMPTZ:
        # aware datetime in UTC; renderers shift to the session TimeZone
        # (reference: timestamp_tz rendered via ICU in the set zone)
        if int(raw) >= TS_INF:
            return datetime.datetime.max
        if int(raw) <= TS_NINF:
            return datetime.datetime.min
        return datetime.datetime(
            1970, 1, 1, tzinfo=datetime.timezone.utc) \
            + datetime.timedelta(microseconds=int(raw))
    if t.id == TypeId.TIME:
        if int(raw) == 86_400_000_000:
            return Hour24Time()
        us = int(raw) % 86_400_000_000
        s, us = divmod(us, 1_000_000)
        h, s = divmod(s, 3600)
        m, s = divmod(s, 60)
        return datetime.time(h, m, s, us)
    if t.id == TypeId.TIMETZ:
        wall, off = timetz_unpack(int(raw))
        tzi = datetime.timezone(datetime.timedelta(seconds=off))
        if wall == 86_400_000_000:
            return Hour24Time(tzi)
        wall %= 86_400_000_000
        sec, us = divmod(wall, 1_000_000)
        h, sec = divmod(sec, 3600)
        m, sec = divmod(sec, 60)
        return datetime.time(h % 24, m, sec, us, tzinfo=tzi)
    if t.id == TypeId.INTERVAL:
        months, us = interval_unpack(int(raw))
        if months == 0:
            return datetime.timedelta(microseconds=us)
        return Interval(months, us)
    if t.id == TypeId.BOOLEAN:
        return bool(raw)
    if t.id in (TypeId.FLOAT, TypeId.DOUBLE):
        return float(raw)
    if t.id == TypeId.VARCHAR:
        if strdict is None:
            raise ValueError("VARCHAR column requires a dictionary")
        return strdict.decode_one(int(raw))
    if t.id in (TypeId.LIST, TypeId.STRUCT, TypeId.MAP, TypeId.BLOB,
                TypeId.UUID, TypeId.UNION):
        if strdict is None:
            raise ValueError(f"{t.id.name} column requires a store")
        return strdict.decode_one(int(raw))
    return int(raw)


def stringify_value(raw, dtype: "DataType", strdict=None) -> str:
    """Physical value -> DuckDB cast-to-VARCHAR text (reference:
    src/common/operator/string_cast.cpp).  Fractional seconds print
    with trailing zeros stripped like the reference."""
    if dtype.id == TypeId.BOOLEAN:
        return "true" if raw else "false"
    if dtype.id == TypeId.TIMETZ:
        return format_timetz(int(raw))
    if dtype.id == TypeId.TIME:
        us = int(raw)
        s_, usec = divmod(us, 1_000_000)
        h, s_ = divmod(s_, 3600)
        m, s_ = divmod(s_, 60)
        t = f"{h:02d}:{m:02d}:{s_:02d}"
        if usec:
            t += f".{usec:06d}".rstrip("0")
        return t
    if dtype.id in (TypeId.LIST, TypeId.STRUCT, TypeId.MAP):
        from .expr.nestedtext import render_value
        return render_value(decode_value(raw, dtype, strdict))
    v = decode_value(raw, dtype, strdict)
    if dtype.id in (TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ) \
            and isinstance(v, datetime.datetime):
        base = v.replace(tzinfo=None).isoformat(sep=" ")
        if "." in base:
            base = base.rstrip("0").rstrip(".")
        if dtype.id == TypeId.TIMESTAMPTZ:
            base += "+00"
        return base
    return str(v)


# ---------------------------------------------------------------------------
# INTERVAL packing: months ride the high bits of the int64 so calendar
# intervals round-trip through storage and clients (reference:
# interval_t {months, days, micros}, src/include/duckdb/common/types/
# interval.hpp — days fold into micros here; |micros| < 2^51 ≈ 71 years)
# ---------------------------------------------------------------------------

INTERVAL_MONTH = 1 << 52


def interval_pack(months: int, micros: int) -> int:
    return months * INTERVAL_MONTH + micros


def interval_unpack(raw: int):
    months = (int(raw) + (1 << 51)) // INTERVAL_MONTH
    return months, int(raw) - months * INTERVAL_MONTH


class Interval:
    """Decoded INTERVAL with a month component (month-free intervals
    decode as plain datetime.timedelta)."""

    __slots__ = ("months", "micros")

    def __init__(self, months: int, micros: int = 0):
        self.months = int(months)
        self.micros = int(micros)

    def __eq__(self, other):
        if isinstance(other, Interval):
            return (self.months, self.micros) ==                 (other.months, other.micros)
        if isinstance(other, datetime.timedelta):
            return self.months == 0 and self.micros == td_micros(other)
        return NotImplemented

    def __hash__(self):
        return hash((self.months, self.micros))

    def __repr__(self):
        return f"Interval(months={self.months}, micros={self.micros})"

    def __str__(self):
        # duckdb Interval::ToString: "[N year[s]] [N month[s]] [N day[s]]
        # [-]HH:MM:SS[.ffffff]"
        parts = []
        years, months = divmod(abs(self.months), 12)
        sign = "-" if self.months < 0 else ""
        if years:
            parts.append(f"{sign}{years} year" + ("" if years == 1
                                                  else "s"))
        if months:
            parts.append(f"{sign}{months} month" + ("" if months == 1
                                                    else "s"))
        us = self.micros
        days, rem = divmod(abs(us), 86_400_000_000)
        dsign = "-" if us < 0 else ""
        if days:
            parts.append(f"{dsign}{days} day" + ("" if days == 1
                                                 else "s"))
        if rem or not parts:
            s_, usec = divmod(rem, 1_000_000)
            h, s_ = divmod(s_, 3600)
            m, s_ = divmod(s_, 60)
            t = f"{dsign}{h:02d}:{m:02d}:{s_:02d}"
            if usec:
                t += f".{usec:06d}".rstrip("0")
            parts.append(t)
        return " ".join(parts)


_IV_TEXT_MONTHS = {"month": 1, "mon": 1, "months": 1, "mons": 1,
                   "year": 12, "years": 12, "quarter": 3, "quarters": 3,
                   "decade": 120, "decades": 120, "century": 1200,
                   "centuries": 1200, "millennium": 12000,
                   "millennia": 12000}
_IV_TEXT_US = {"microsecond": 1, "microseconds": 1, "us": 1,
               "millisecond": 1_000, "milliseconds": 1_000, "ms": 1_000,
               "second": 1_000_000, "seconds": 1_000_000,
               "minute": 60_000_000, "minutes": 60_000_000,
               "hour": 3_600_000_000, "hours": 3_600_000_000,
               "day": 86_400_000_000, "days": 86_400_000_000,
               "week": 7 * 86_400_000_000, "weeks": 7 * 86_400_000_000}


def parse_interval_text(text: str) -> int:
    """'1 year 2 months 3 days 04:05:06' -> packed raw (reference:
    Interval::FromCString, src/common/types/interval.cpp)."""
    toks = str(text).strip().split()
    months = 0
    micros = 0
    i = 0
    while i < len(toks):
        tk = toks[i]
        if ":" in tk:
            neg = tk.startswith("-")
            wall, _ = parse_time_text(tk.lstrip("+-"))
            micros += -wall if neg else wall
            i += 1
            continue
        try:
            n = int(tk)
        except ValueError:
            raise ValueError(f"invalid interval '{text}'")
        if i + 1 >= len(toks):
            raise ValueError(f"invalid interval '{text}'")
        unit = toks[i + 1].lower()
        if unit in _IV_TEXT_MONTHS:
            months += n * _IV_TEXT_MONTHS[unit]
        elif unit in _IV_TEXT_US:
            micros += n * _IV_TEXT_US[unit]
        else:
            raise ValueError(f"invalid interval unit '{unit}'")
        i += 2
    return interval_pack(months, micros)
