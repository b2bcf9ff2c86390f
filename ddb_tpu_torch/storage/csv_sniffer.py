"""CSV dialect + schema sniffer.

TPU-native rethink of the reference's CSV sniffer
(reference: src/execution/operator/csv_scanner/sniffer/csv_sniffer.cpp:
dialect detection over candidate delimiters scored by per-row column-count
consistency, then header detection, then per-column type refinement over a
sample).  The heavy full-file parse stays in pyarrow's multithreaded C++
reader; sniffing only touches a bounded prefix.
"""

from __future__ import annotations

import csv as _csv
import io
import re
from dataclasses import dataclass, field
from typing import List, Optional

_SAMPLE_BYTES = 1 << 16
_SAMPLE_ROWS = 2048
_DELIMS = [",", "|", ";", "\t"]

_BOOL = {"true", "false", "t", "f", "0", "1", "yes", "no"}
_INT_RE = re.compile(r"^[+-]?\d{1,19}$")
_DEC_RE = re.compile(r"^[+-]?(\d+\.\d*|\.\d+|\d+)$")
_FLOAT_RE = re.compile(
    r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$|^[+-]?(inf|nan)$", re.I)
_DATE_RE = re.compile(r"^\d{4}-\d{2}-\d{2}$")
_TS_RE = re.compile(r"^\d{4}-\d{2}-\d{2}[ T]\d{2}:\d{2}(:\d{2}(\.\d+)?)?$")
_TIME_RE = re.compile(r"^\d{2}:\d{2}(:\d{2}(\.\d+)?)?$")

# type-refinement lattice, narrowest first (reference:
# sniffer/type_detection.cpp uses the same widening order)
_ORDER = ["BOOLEAN", "BIGINT", "DOUBLE", "DATE", "TIMESTAMP", "TIME",
          "VARCHAR"]


@dataclass
class SniffResult:
    delimiter: str = ","
    quote: str = '"'
    escape: str = '"'
    has_header: bool = True
    skip_rows: int = 0
    column_names: List[str] = field(default_factory=list)
    column_types: List[str] = field(default_factory=list)  # SQL type names


def _cell_type(v: str) -> str:
    s = v.strip()
    if s == "" :
        return "NULL"
    low = s.lower()
    if low in ("true", "false", "t", "f"):
        return "BOOLEAN"
    if _INT_RE.match(s):
        return "BIGINT"
    if _FLOAT_RE.match(s) or _DEC_RE.match(s):
        return "DOUBLE"
    if _DATE_RE.match(s):
        return "DATE"
    if _TS_RE.match(s):
        return "TIMESTAMP"
    if _TIME_RE.match(s):
        return "TIME"
    return "VARCHAR"


def _widen(a: str, b: str) -> str:
    if a == "NULL":
        return b
    if b == "NULL":
        return a
    if a == b:
        return a
    # BOOLEAN 0/1 vs ints: ints win; everything else falls to the wider
    pair = {a, b}
    if pair == {"BOOLEAN", "BIGINT"}:
        return "BIGINT"
    if pair == {"BIGINT", "DOUBLE"}:
        return "DOUBLE"
    if pair == {"DATE", "TIMESTAMP"}:
        return "TIMESTAMP"
    return "VARCHAR"


def _parse_sample(text: str, delim: str, quote: str) -> List[List[str]]:
    try:
        rd = _csv.reader(io.StringIO(text), delimiter=delim,
                         quotechar=quote, doublequote=True)
        rows = []
        for r in rd:
            rows.append(r)
            if len(rows) >= _SAMPLE_ROWS:
                break
        return rows
    except _csv.Error:
        return []


def _score(rows: List[List[str]]) -> tuple:
    """(consistent_row_count, num_columns): more consistent rows with more
    columns wins (reference: dialect scoring prefers max consistent rows,
    then max columns)."""
    if not rows:
        return (0, 0)
    from collections import Counter
    counts = Counter(len(r) for r in rows if r)
    if not counts:
        return (0, 0)
    ncols, hits = counts.most_common(1)[0]
    if ncols <= 1:
        # single column only counts if no delimiter matched anything
        return (hits, 1)
    return (hits, ncols)


def sniff(path: str, sample_bytes: int = _SAMPLE_BYTES) -> SniffResult:
    with open(path, "rb") as f:
        raw = f.read(sample_bytes)
    # drop a trailing partial line (unless the sample is the whole file)
    whole = len(raw) < sample_bytes
    try:
        text = raw.decode("utf-8")
    except UnicodeDecodeError:
        text = raw.decode("latin-1")
    if not whole:
        text = text[:text.rfind("\n") + 1] or text
    if text.startswith("﻿"):
        text = text[1:]

    best, best_rows = None, []
    for d in _DELIMS:
        rows = _parse_sample(text, d, '"')
        sc = _score(rows)
        if best is None or sc > best[0]:
            best = (sc, d)
            best_rows = rows
    delim = best[1]
    ncols = best[0][1]
    rows = [r for r in best_rows if len(r) == ncols]
    if not rows:
        return SniffResult(delimiter=delim, has_header=False)

    # column types over data rows (excluding a potential header row)
    def col_types(rs):
        ts = ["NULL"] * ncols
        for r in rs:
            for i, v in enumerate(r):
                ts[i] = _widen(ts[i], _cell_type(v))
        return ts

    body_types = col_types(rows[1:]) if len(rows) > 1 else None
    head_types = [_cell_type(v) for v in rows[0]]
    # header iff the first row is all-VARCHAR-ish while the body has at
    # least one non-VARCHAR column, or first-row names are unique
    # non-empty strings and body types disagree with them
    has_header = False
    if body_types is not None:
        head_str = all(t in ("VARCHAR", "NULL") for t in head_types)
        body_typed = any(t not in ("VARCHAR", "NULL") for t in body_types)
        if head_str and body_typed:
            has_header = True
        # all-VARCHAR files default to headerless: with no type signal
        # there is no evidence the first row is special (reference sniffer
        # only declares a header when first-row types disagree with the
        # body: csv_scanner/sniffer/header_detection.cpp)
    types = col_types(rows[1:] if has_header else rows)
    types = [t if t != "NULL" else "VARCHAR" for t in types]
    if has_header:
        names = [v.strip() or f"column{i}"
                 for i, v in enumerate(rows[0])]
    else:
        names = [f"column{i:d}" for i in range(ncols)]
    return SniffResult(delimiter=delim, has_header=has_header,
                       column_names=names, column_types=types)


_SQL_TO_ARROW = {
    "BOOLEAN": "bool_", "BIGINT": "int64", "DOUBLE": "float64",
    "DATE": "date32", "TIMESTAMP": "timestamp", "TIME": "time64",
    "VARCHAR": "string",
}


def read_csv_auto(path: str, delim: Optional[str] = None,
                  header: Optional[bool] = None,
                  names: Optional[List[str]] = None,
                  types: Optional[dict] = None,
                  quote: str = '"'):
    """Sniff (unless overridden) then bulk-parse in torch on the
    statement's device (storage/csvscan.py, the counterpart of the
    reference's pyarrow call).  Returns a TableData."""
    from .. import types as T
    from . import csvscan

    sn = sniff(path)
    if delim is not None:
        sn.delimiter = delim
    if header is not None:
        sn.has_header = header
    elif names and not sn.has_header:
        # first row spelling the target column names IS the header
        # even when type sniffing saw all-VARCHAR (reference:
        # header_detection.cpp matches declared names)
        import csv as _csv
        try:
            with open(path, newline="") as f:
                first = next(_csv.reader(f, delimiter=sn.delimiter),
                             None)
        except OSError:
            first = None
        if first and [c.strip().lower() for c in first] \
                == [str(n).lower() for n in names]:
            sn.has_header = True
    if names:
        sn.column_names = list(names)

    def arrow_type(sql: str):
        # the reference's Arrow types, as the port's: INTEGER loads as
        # int64, TIMESTAMP in microseconds, DECIMAL(p,s) exact
        sql = sql.upper()
        if sql in ("TIMESTAMP", "DATETIME"):
            return T.TIMESTAMP
        if sql == "TIME":
            return T.TIME
        m = {"BOOLEAN": T.BOOLEAN, "BIGINT": T.BIGINT,
             "INTEGER": T.BIGINT, "INT": T.BIGINT,
             "DOUBLE": T.DOUBLE, "FLOAT": T.DOUBLE,
             "DATE": T.DATE, "VARCHAR": T.VARCHAR,
             "TEXT": T.VARCHAR}
        if sql.startswith("DECIMAL"):
            mm = re.match(r"DECIMAL\((\d+),\s*(\d+)\)", sql)
            if mm:
                return T.DECIMAL(int(mm.group(1)), int(mm.group(2)))
            return T.DOUBLE
        return m.get(sql, T.VARCHAR)

    col_types = {}
    if sn.column_names and sn.column_types:
        col_types = {n: arrow_type(t)
                     for n, t in zip(sn.column_names, sn.column_types)}
    if types:
        for k, v in types.items():
            col_types[k] = arrow_type(str(v))

    names_ = sn.column_names or None
    return csvscan.read(
        path, names_,
        None if names_ is None and not col_types
        else [col_types.get(n) for n in names_] if names_ is not None
        else None,
        delimiter=sn.delimiter, quote=quote,
        skip_first_line=bool(sn.has_header and sn.column_names))
