"""Bulk CSV parse in torch on the connection's device.

The port's counterpart of the reference's `pyarrow.csv.read_csv` call
(ddb_tpu/storage/csv_sniffer.py:read_csv_auto): the same table from the
same file, under the options the reference passes (`strings_can_be_null`,
pyarrow's default null spellings, true/false spellings, quoting with a
doubled quote as its escape, empty lines ignored).

The file is read in chunks of at most `CHUNK_BYTES` into page-locked host
memory and each chunk is uploaded.  A chunk always ends at a row end
outside quotes, so the quote parity at a chunk's start is even.  On the
device:

* tokenize: the quote parity is an int32 cumulative sum of `byte ==
  quote`; row ends are CR or LF outside quotes (an empty line, which CRLF
  leaves between its two bytes, is dropped as pyarrow drops it); field
  ends are the delimiter or a row end outside quotes; `nonzero` gives
  each field's end, and every row must hold the same number of fields;
* convert, per column: the fields are gathered into a [rows, W] byte
  matrix (W the column's longest field) through a strided window over
  the chunk, then typed: integers by Horner's rule with an overflow
  check, decimals as exact scaled integers, doubles by Clinger's fast
  path (at most 15 significant digits and a power of ten of at most 22:
  one correctly rounded IEEE multiply or divide of two exact operands),
  dates and timestamps from digits at fixed places;
* strings: fields of at most 32 bytes are packed into four big-endian
  64-bit words and sorted on the device into the chunk's dictionary;
  longer ones, and quoted ones holding a doubled quote, come from the
  host copy of the chunk.

What the device's fast path does not take (hexadecimal integers, doubles
off the fast path, exponents in decimals, zoned timestamps while
inferring) is converted on the host by pyarrow's rules, row by row; a
text that pyarrow rejects raises `CsvError` here too.

`read` returns a `TableData` of host numpy columns, as the storage model
holds tables; the string dictionaries equal `StringDictionary.encode`'s
(sorted unique values, with "" first when the column holds a NULL).
"""

from __future__ import annotations

import datetime
import decimal
import os
import re
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import types as T
from ..types import DataType, TypeId
from .strings import StringDictionary
from .table import TableColumn, TableData

# the largest chunk of the file one pass holds on the device
CHUNK_BYTES = 1 << 30

# pyarrow.csv.ConvertOptions' defaults, which the reference's reader keeps
NULL_VALUES = ("", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN",
               "-nan", "1.#IND", "1.#QNAN", "N/A", "NA", "NULL", "NaN", "n/a",
               "nan", "null")
TRUE_VALUES = ("1", "True", "TRUE", "true")
FALSE_VALUES = ("0", "False", "FALSE", "false")

# fields longer than this many bytes are typed on the host
_FAST_WIDTH = 40
# strings of at most this many bytes get their dictionary on the device
_DEVICE_STRING_BYTES = 32

# per-call counters of the last `read` (chip_smoke.py prints them)
STATS = {"rows": 0, "chunks": 0, "file_bytes": 0, "slow_float_rows": 0,
         "host_rows": 0, "odd_quote_chunks": 0, "peak_bytes": 0}
TIMINGS = {}

_INT64_MIN = -(1 << 63)
_CR, _LF, _SP, _TAB = 13, 10, 32, 9


class CsvError(ValueError):
    """A CSV text pyarrow rejects (pyarrow raises ArrowInvalid, a
    ValueError, for the same text)."""


# ---------------------------------------------------------------------------
# kinds
# ---------------------------------------------------------------------------

def _arrow_name(dt: Optional[DataType]) -> str:
    if dt is None:
        return "null"
    return {TypeId.BIGINT: "int64", TypeId.DOUBLE: "double",
            TypeId.BOOLEAN: "bool", TypeId.DATE: "date32[day]",
            TypeId.TIMESTAMP: "timestamp[us]", TypeId.VARCHAR: "string",
            TypeId.TIME: "time64[us]"}.get(
        dt.id, f"decimal128({dt.width}, {dt.scale})")


def _conversion_error(col: int, dt, text: str) -> CsvError:
    return CsvError(f"In CSV column #{col}: CSV conversion error to "
                    f"{_arrow_name(dt)}: invalid value '{text}'")


# ---------------------------------------------------------------------------
# host rules: the text of one field, unquoted, as pyarrow converts it
# ---------------------------------------------------------------------------

_WS = " \t"
_HEX_RE = re.compile(r"0[xX][0-9a-fA-F]{1,16}")
_INT_RE = re.compile(r"-?[0-9]+")
_FLOAT_RE = re.compile(r"[+-]?([0-9]+\.?[0-9]*|\.[0-9]+)([eE][+-]?[0-9]+)?")
_SPECIAL_RE = re.compile(r"[+-]?(inf|infinity|nan)", re.I)
_DEC_RE = re.compile(r"[+-]?([0-9]+\.?[0-9]*|\.[0-9]+)([eE][+-]?[0-9]+)?")
_TS_RE = re.compile(
    r"([0-9]{4})-([0-9]{2})-([0-9]{2})"
    r"(?:[ T]([0-9]{2})(?::([0-9]{2})(?::([0-9]{2})(?:\.([0-9]{1,9}))?)?)?)?"
    r"(Z|[+-][0-9]{2}(?::?[0-9]{2})?)?")
_TIME_RE = re.compile(r"([0-9]{2}):([0-9]{2})(?::([0-9]{2}))?")
_EPOCH = datetime.date(1970, 1, 1)


def _host_int(text: str):
    t = text.strip(_WS)
    if _HEX_RE.fullmatch(t):
        v = int(t[2:], 16)
        return v - (1 << 64) if v >= 1 << 63 else v
    if _INT_RE.fullmatch(t):
        v = int(t)
        if -(1 << 63) <= v < 1 << 63:
            return v
    return None


def _host_float(text: str):
    t = text.strip(_WS)
    if _FLOAT_RE.fullmatch(t) or _SPECIAL_RE.fullmatch(t):
        return float(t)
    return None


def _host_bool(text: str):
    if text in TRUE_VALUES:
        return True
    if text in FALSE_VALUES:
        return False
    return None


def _host_date(text: str):
    t = text.strip(_WS)
    if len(t) != 10 or t[4] != "-" or t[7] != "-" \
            or not (t[:4] + t[5:7] + t[8:]).isdigit() or not t.isascii():
        return None
    try:
        return (datetime.date(int(t[:4]), int(t[5:7]), int(t[8:]))
                - _EPOCH).days
    except ValueError:
        return None


def _host_timestamp(text: str, zoned: bool = False, max_frac: int = 6):
    """Microseconds of a timestamp text, or None.  `zoned`: the text must
    carry a zone offset (pyarrow's zoned kinds, inferring only), else it
    must not."""
    m = _TS_RE.fullmatch(text)
    if m is None or not text.isascii():
        return None
    y, mo, d, hh, mi, ss, frac, zone = m.groups()
    if (zone is not None) != zoned or (frac is not None
                                       and len(frac) > max_frac):
        return None
    try:
        dt = datetime.datetime(int(y), int(mo), int(d), int(hh or 0),
                               int(mi or 0), int(ss or 0))
    except ValueError:
        return None
    us = (dt - datetime.datetime(1970, 1, 1)) // datetime.timedelta(
        microseconds=1)
    if frac:
        digits = int(frac.ljust(9, "0"))
        if digits % 1000:
            return None               # below a microsecond: lost in the cast
        us += digits // 1000
    if zone and zone != "Z":
        sign = -1 if zone[0] == "-" else 1
        z = zone[1:].replace(":", "")
        off = int(z[:2]) * 60 + (int(z[2:]) if len(z) > 2 else 0)
        us -= sign * off * 60_000_000
    return us


def _host_time(text: str):
    m = _TIME_RE.fullmatch(text)
    if m is None:
        return None
    hh, mi, ss = int(m.group(1)), int(m.group(2)), int(m.group(3) or 0)
    return 0 if hh < 24 and mi < 60 and ss < 60 else None


def _host_decimal(text: str, precision: int, scale: int, col: int):
    t = text.strip(_WS)
    if not _DEC_RE.fullmatch(t):
        raise CsvError(f"In CSV column #{col}: The string '{t}' is not a "
                       f"valid decimal128 number")
    d = decimal.Decimal(t)
    sig = len("".join(map(str, d.as_tuple().digits)).lstrip("0")) or 1
    if sig > precision:
        raise CsvError(f"In CSV column #{col}: Error converting '{t}' to "
                       f"decimal128({precision}, {scale})")
    v = d.scaleb(scale)
    if v != v.to_integral_value():
        raise CsvError(f"In CSV column #{col}: Rescaling Decimal value "
                       f"would cause data loss")
    return int(v)


# ---------------------------------------------------------------------------
# device helpers
# ---------------------------------------------------------------------------

def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Clock:
    def __init__(self, device):
        self.device = device
        self.t = time.perf_counter()

    def lap(self, name: str):
        _sync(self.device)
        now = time.perf_counter()
        TIMINGS[name] = TIMINGS.get(name, 0.0) + now - self.t
        self.t = now


def _pack_le(mat: torch.Tensor) -> torch.Tensor:
    """int64 key of each row of a [n, <=8] uint8 matrix, little-endian."""
    key = torch.zeros(mat.shape[0], dtype=torch.int64, device=mat.device)
    for j in range(mat.shape[1]):
        key |= mat[:, j].to(torch.int64) << (8 * j)
    return key


def _spelling_table(words, device):
    """(sorted keys, their lengths) of byte strings of at most 8 bytes."""
    pairs = sorted((int.from_bytes(w.encode(), "little"), len(w))
                   for w in words)
    return (torch.tensor([k for k, _ in pairs], dtype=torch.int64,
                         device=device),
            torch.tensor([n for _, n in pairs], dtype=torch.int64,
                         device=device))


def _matches(key, ln, table):
    keys, lens = table
    i = torch.searchsorted(keys, key).clamp_(max=keys.numel() - 1)
    return (keys[i] == key) & (lens[i] == ln)


_POW10 = [10 ** i for i in range(23)]


class _Chunk:
    """One chunk on the device: its bytes (padded for the strided
    window), its host copy, its fields as [rows, columns], and the
    running count of doubled quotes (None when the chunk has none)."""

    def __init__(self, dev_bytes, host_bytes, starts, ends, esc, line0):
        self.b = dev_bytes
        self.host = host_bytes
        self.starts = starts
        self.ends = ends
        self.esc = esc
        self.rows = starts.shape[0]
        self.line0 = line0

    def gather(self, cs, ln, width: int):
        """([n, width] bytes, zero past each field's end, [n, width] valid)
        through the strided view whose row i holds bytes i .. i+width-1
        (the bytes are padded past the chunk's end for it)."""
        mat = self.b.unfold(0, width, 1)[cs]
        valid = torch.arange(width, device=cs.device)[None, :] < ln[:, None]
        return mat * valid, valid


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

def _tokenize(b: torch.Tensor, length: int, delim: int, quote: int,
              last: bool):
    """(field starts, field ends, field-ends-a-row flags, doubled-quote
    counts, cut) of b[:cut], where cut is one past the last row end
    outside quotes (all of b when `last`); None when b holds no row end.
    Empty lines are dropped.  Raises on quoting pyarrow reads another
    way."""
    dev = b.device
    data = b[:length]
    isq = data == quote
    inside = (torch.cumsum(isq, 0, dtype=torch.int32) & 1).bool()
    nl = ((data == _LF) | (data == _CR)) & ~inside
    term = nl | ((data == delim) & ~inside)
    esc = None
    if bool(isq.any()):
        # a quote opens a quoted run only at a field's start, and closes
        # it only before a delimiter, a row end, the end or its escape
        opening = isq & inside
        closing = isq & ~inside
        prev_ok = torch.ones_like(isq)
        prev_ok[1:] = term[:-1] | closing[:-1]
        next_ok = torch.ones_like(isq)
        next_ok[:-1] = term[1:] | isq[1:]
        bad = (opening & ~prev_ok) | (closing & ~next_ok)
        if bool(bad.any()):
            raise _OddQuotes()
        doubled = torch.zeros_like(isq)
        doubled[:-1] = closing[:-1] & isq[1:]
        if bool(doubled.any()):
            esc = torch.cumsum(doubled, 0, dtype=torch.int32)
        del opening, closing, prev_ok, next_ok, bad, doubled
    if last and length and bool(inside[length - 1]):
        raise _OddQuotes()        # pyarrow's field runs to the end
    del inside, isq
    ends = torch.nonzero(term).squeeze(1)
    del term
    if last:
        cut = length
        if length and not bool(nl[length - 1]):
            ends = torch.cat([ends, torch.tensor([length], device=dev)])
    else:
        nl_idx = torch.nonzero(nl).squeeze(1)
        if nl_idx.numel() == 0:
            return None
        cut = int(nl_idx[-1]) + 1
        ends = ends[ends < cut]
    row_end = torch.ones(ends.shape[0], dtype=torch.bool, device=dev)
    inner = ends < length
    row_end[inner] = nl[ends[inner]]
    starts = torch.zeros_like(ends)
    starts[1:] = ends[:-1] + 1
    first = torch.ones_like(row_end)
    first[1:] = row_end[:-1]
    keep = ~(first & row_end & (ends == starts))
    return starts[keep], ends[keep], row_end[keep], esc, cut


class _OddQuotes(Exception):
    """A quote inside an unquoted field, or text after a closing quote:
    the quote parity does not give pyarrow's fields."""


def _canonical(data: np.ndarray, delim: int, quote: int, last: bool):
    """(bytes, cut): the complete rows of data[:cut] parsed by pyarrow's
    state machine on the host (a quote opens a quoted run only at a
    field's start; after the run closes, the field's text goes on
    literally), written again with every field that holds a quote, the
    delimiter or a row end quoted and its quotes doubled.  The device
    tokenizer reads the result as pyarrow reads the original."""
    raw = bytes(data)
    q, d = bytes([quote]), bytes([delim])
    out = []
    row, field = [], bytearray()
    i, n, cut = 0, len(raw), 0
    state = 0            # 0 field start, 1 unquoted, 2 quoted, 3 after run

    def emit(f):
        if state in (2, 3) or q in f or d in f or b"\n" in f \
                or b"\r" in f:
            return q + bytes(f).replace(q, q + q) + q
        return bytes(f)

    while i < n:
        c = raw[i:i + 1]
        if state == 2:
            if c == q:
                if raw[i + 1:i + 2] == q:
                    field += q
                    i += 2
                    continue
                state = 3
            else:
                field += c
            i += 1
            continue
        if c == d:
            row.append(emit(field))
            field, state = bytearray(), 0
        elif c in (b"\n", b"\r"):
            if row or field or state:
                row.append(emit(field))
                out.append(d.join(row) + b"\n")
            row, field, state = [], bytearray(), 0
            if c == b"\r" and raw[i + 1:i + 2] == b"\n":
                i += 1
            cut = i + 1
        elif c == q and state == 0:
            state = 2
        else:
            field += c
            state = state or 1
        i += 1
    if last:
        if row or field or state:
            row.append(emit(field))
            out.append(d.join(row) + b"\n")
        cut = n
    return b"".join(out), cut


def _rows(chunk_host, starts, ends, row_end, ncols, line0):
    """[rows, ncols] starts and ends; a row with another count of fields
    raises as pyarrow does."""
    dev = starts.device
    if starts.numel() == 0:
        z = torch.zeros((0, ncols), dtype=torch.int64, device=dev)
        return z, z
    last_field = torch.nonzero(row_end).squeeze(1)
    counts = torch.diff(last_field, prepend=torch.tensor([-1], device=dev))
    bad = counts != ncols
    if bool(bad.any()):
        r = int(torch.nonzero(bad)[0, 0])
        s = int(starts[int(last_field[r]) - int(counts[r]) + 1])
        e = int(ends[int(last_field[r])])
        text = bytes(chunk_host[s:e]).decode("utf-8", errors="replace")
        line = line0 + int(np.count_nonzero(
            np.asarray(chunk_host[:s]) == _LF)) + 1
        raise CsvError(f"CSV parse error: Expected {ncols} columns, got "
                       f"{int(counts[r])}: {text} (line {line})")
    return starts.view(-1, ncols), ends.view(-1, ncols)


# ---------------------------------------------------------------------------
# per-column conversion of one chunk
# ---------------------------------------------------------------------------

class _Field:
    """The fields of one column of one chunk: unquoted spans, NULLs, and
    which hold a doubled quote (unescaped on the host)."""

    def __init__(self, ch: _Chunk, col: int, quote: int, tables):
        s = ch.starts[:, col]
        e = ch.ends[:, col]
        quoted = (ch.b[s] == quote) & (e > s)
        q = quoted.to(torch.int64)
        self.cs = s + q
        self.ln = (e - q) - self.cs
        if ch.esc is not None:
            hi = ch.esc[(e - 1).clamp(min=0)]
            lo = ch.esc[s]
            self.escaped = quoted & (hi > lo)
        else:
            self.escaped = torch.zeros_like(quoted)
        mat8, _ = ch.gather(self.cs, self.ln.clamp(max=8), 8)
        self.key8 = _pack_le(mat8)
        self.null = (self.ln <= 8) & ~self.escaped \
            & _matches(self.key8, self.ln, tables["null"])
        self.n = s.shape[0]
        self.ch = ch

    def host_text(self, i: int) -> str:
        cs, ln = int(self.cs[i]), int(self.ln[i])
        raw = bytes(self.ch.host[cs:cs + ln])
        if bool(self.escaped[i]):
            raw = raw.replace(b'""', b'"')
        return raw.decode("utf-8")


def _trimmed(f: _Field, ch: _Chunk, live):
    """(cs, ln) with spaces and tabs stripped from both ends."""
    cs, ln = f.cs, f.ln
    width = int(ln[live].max()) if bool(live.any()) else 0
    if width == 0 or width > _FAST_WIDTH:
        return cs, ln
    mat, valid = ch.gather(cs, ln, width)
    ws = ((mat == _SP) | (mat == _TAB)) & valid
    if not bool(ws.any()):
        return cs, ln
    content = valid & ~ws
    has = content.any(1)
    j = torch.arange(width, device=cs.device)
    lead = torch.where(content, j, width).amin(1)
    trail = torch.where(content, j, -1).amax(1) + 1
    lead = torch.where(has, lead, 0)
    trail = torch.where(has, trail, 0)
    return cs + lead, trail - lead


def _digits(mat):
    return mat.to(torch.int64) - 48


def _convert_int(f, ch, live):
    cs, ln = _trimmed(f, ch, live)
    width = max(int(ln[live].max()) if bool(live.any()) else 1, 1)
    width = min(width, _FAST_WIDTH)
    mat, valid = ch.gather(cs, ln, width)
    neg = mat[:, 0] == ord("-")
    sl = neg.to(torch.int64)
    j = torch.arange(width, device=cs.device)[None, :]
    body = valid & (j >= sl[:, None])
    isdig = (mat >= 48) & (mat <= 57)
    ok = live & (ln > sl) & (ln <= width) & ~(body & ~isdig).any(1)
    acc = torch.zeros(f.n, dtype=torch.int64, device=cs.device)
    ovf = torch.zeros(f.n, dtype=torch.bool, device=cs.device)
    lim = -922337203685477580                      # trunc(INT64_MIN / 10)
    d = _digits(mat)
    for k in range(width):
        on = body[:, k] & isdig[:, k]
        dk = d[:, k]
        ovf |= on & ((acc < lim) | ((acc == lim) & (dk > 8)))
        acc = torch.where(on, acc * 10 - dk, acc)
    ovf |= ~neg & (acc == _INT64_MIN)
    ok &= ~ovf
    return torch.where(neg, acc, -acc), ok


def _convert_double(f, ch, live, stats=None):
    """(values, converted): Clinger's fast path on the device; the other
    well-formed text (more than 15 significant digits, or a power of ten
    beyond 22) gathered and parsed on the host in one numpy conversion,
    which rounds correctly as float() does.  `stats` counts those rows."""
    cs, ln = _trimmed(f, ch, live)
    width = max(int(ln[live].max()) if bool(live.any()) else 1, 1)
    width = min(width, _FAST_WIDTH)
    mat, valid = ch.gather(cs, ln, width)
    dev = cs.device
    j = torch.arange(width, device=dev)[None, :]
    c0 = mat[:, 0]
    sl = ((c0 == ord("-")) | (c0 == ord("+"))).to(torch.int64)
    neg = c0 == ord("-")
    isdig = (mat >= 48) & (mat <= 57)
    ise = ((mat == ord("e")) | (mat == ord("E"))) & valid
    isdot = (mat == ord(".")) & valid
    has_e = ise.any(1)
    epos = torch.where(has_e, torch.argmax(ise.to(torch.uint8), 1), ln)
    mant = valid & (j >= sl[:, None]) & (j < epos[:, None])
    ndot = (isdot & mant).sum(1)
    dpos = torch.where(ndot > 0, torch.argmax((isdot & mant).to(torch.uint8),
                                              1), epos)
    mdig = mant & isdig
    ok = live & (ln <= width) & (ndot <= 1) & ~(mant & ~isdig & ~isdot).any(1)
    ok &= mdig.any(1)
    # exponent: an optional sign, then 1 to 4 digits
    ex = valid & (j > epos[:, None])
    esl = torch.zeros_like(sl)
    if bool(has_e.any()):
        at = (epos + 1).clamp(max=width - 1)
        ec = mat.gather(1, at[:, None]).squeeze(1)
        esl = (has_e & ((ec == ord("-")) | (ec == ord("+")))).to(torch.int64)
        eneg = has_e & (ec == ord("-"))
        edig = ex & (j > (epos + esl)[:, None])
        nexp = edig.sum(1)
        ok &= ~has_e | ((nexp >= 1) & (nexp <= 4) & ~(edig & ~isdig).any(1))
        ev = torch.zeros(f.n, dtype=torch.int64, device=dev)
        d = _digits(mat)
        for k in range(width):
            ev = torch.where(edig[:, k], ev * 10 + d[:, k], ev)
        ev = torch.where(eneg, -ev, ev)
    else:
        ev = torch.zeros(f.n, dtype=torch.int64, device=dev)
    # mantissa: significant digits by Horner's rule, leading zeros skipped
    m = torch.zeros(f.n, dtype=torch.int64, device=dev)
    nsig = torch.zeros(f.n, dtype=torch.int64, device=dev)
    nfrac = torch.zeros(f.n, dtype=torch.int64, device=dev)
    d = _digits(mat)
    for k in range(width):
        on = mdig[:, k]
        started = (nsig > 0) | (d[:, k] > 0)
        take = on & started & (nsig < 19)
        m = torch.where(take, m * 10 + d[:, k], m)
        nsig = torch.where(on & started, nsig + 1, nsig)
        nfrac = torch.where(on & (k > dpos), nfrac + 1, nfrac)
    k10 = ev - nfrac
    fast = ok & (nsig <= 15) & (k10.abs() <= 22)
    fast |= ok & (m == 0) & (nsig == 0)
    p10 = torch.tensor([float(10 ** i) for i in range(23)],
                       dtype=torch.float64, device=dev)
    mag = p10[k10.abs().clamp(max=22)]
    mf = m.to(torch.float64)
    val = torch.where(k10 >= 0, mf * mag, mf / mag)
    val = torch.where(m == 0, torch.zeros_like(val), val)
    val = torch.where(neg, -val, val)
    rows = torch.nonzero(ok & ~fast).squeeze(1)
    if rows.numel():
        text = np.ascontiguousarray(mat[rows].cpu().numpy())
        val[rows] = torch.from_numpy(
            text.view(f"S{width}").ravel().astype(np.float64)).to(dev)
        if stats is not None:
            stats["slow_float_rows"] += rows.numel()
    return val, ok


def _convert_decimal(f, ch, live, precision, scale):
    cs, ln = _trimmed(f, ch, live)
    width = max(int(ln[live].max()) if bool(live.any()) else 1, 1)
    width = min(width, _FAST_WIDTH)
    mat, valid = ch.gather(cs, ln, width)
    dev = cs.device
    j = torch.arange(width, device=dev)[None, :]
    c0 = mat[:, 0]
    sl = ((c0 == ord("-")) | (c0 == ord("+"))).to(torch.int64)
    neg = c0 == ord("-")
    isdig = (mat >= 48) & (mat <= 57)
    isdot = (mat == ord(".")) & valid
    body = valid & (j >= sl[:, None])
    ndot = (isdot & body).sum(1)
    dpos = torch.where(ndot > 0, torch.argmax((isdot & body).to(torch.uint8),
                                              1), ln)
    dig = body & isdig
    ok = live & (ln <= width) & (ndot <= 1) & ~(body & ~isdig & ~isdot).any(1)
    ok &= dig.any(1)
    m = torch.zeros(f.n, dtype=torch.int64, device=dev)
    nsig = torch.zeros(f.n, dtype=torch.int64, device=dev)
    nfrac = torch.zeros(f.n, dtype=torch.int64, device=dev)
    drop = torch.zeros(f.n, dtype=torch.int64, device=dev)   # cut digits
    lost = torch.zeros(f.n, dtype=torch.bool, device=dev)
    d = _digits(mat)
    for k in range(width):
        on = dig[:, k]
        frac = on & (k > dpos)
        nfrac = torch.where(frac, nfrac + 1, nfrac)
        extra = frac & (nfrac > scale)
        lost |= extra & (d[:, k] != 0)
        drop = torch.where(extra, drop + 1, drop)
        started = (nsig > 0) | (d[:, k] > 0)
        nsig = torch.where(on & started, nsig + 1, nsig)
        take = on & ~extra & (nsig <= 18)
        m = torch.where(take, m * 10 + d[:, k], m)
    kept = nfrac - drop
    ok &= (nsig <= min(precision, 18)) & ~lost
    shift = (scale - kept).clamp(min=0)
    p10 = torch.tensor(_POW10[:19], dtype=torch.int64, device=dev)
    v = m * p10[shift.clamp(max=18)]
    return torch.where(neg, -v, v), ok


def _civil_days(y, mo, d):
    """Days since 1970-01-01 of proleptic Gregorian dates (int64)."""
    y = y - (mo <= 2).to(torch.int64)
    era = torch.div(y, 400, rounding_mode="floor")
    yoe = y - era * 400
    mp = (mo + 9) % 12
    doy = torch.div(153 * mp + 2, 5, rounding_mode="floor") + d - 1
    doe = yoe * 365 + torch.div(yoe, 4, rounding_mode="floor") \
        - torch.div(yoe, 100, rounding_mode="floor") + doy
    return era * 146097 + doe - 719468


def _month_days(y, mo):
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    table = torch.tensor([0, 31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                         dtype=torch.int64, device=y.device)
    return table[mo.clamp(0, 12)] + (leap & (mo == 2)).to(torch.int64)


def _num(d, isdig, lo, hi):
    """(value, all digits) of the fixed positions lo..hi-1."""
    v = torch.zeros(d.shape[0], dtype=torch.int64, device=d.device)
    for k in range(lo, hi):
        v = v * 10 + d[:, k]
    return v, isdig[:, lo:hi].all(1)


def _date_parts(mat, isdig):
    d = _digits(mat)
    y, oky = _num(d, isdig, 0, 4)
    mo, okm = _num(d, isdig, 5, 7)
    dd, okd = _num(d, isdig, 8, 10)
    ok = oky & okm & okd & (mat[:, 4] == ord("-")) & (mat[:, 7] == ord("-"))
    ok &= (mo >= 1) & (mo <= 12) & (dd >= 1) & (dd <= _month_days(y, mo))
    return _civil_days(y, mo, dd), ok


def _convert_date(f, ch, live):
    cs, ln = _trimmed(f, ch, live)
    mat, _ = ch.gather(cs, ln.clamp(max=10), 10)
    isdig = (mat >= 48) & (mat <= 57)
    days, ok = _date_parts(mat, isdig)
    return days, ok & live & (ln == 10)


def _convert_timestamp(f, ch, live):
    """Microseconds of 'YYYY-MM-DD[( |T)hh[:mm[:ss[.f{1,6}]]]]'."""
    cs, ln = f.cs, f.ln
    mat, _ = ch.gather(cs, ln.clamp(max=26), 26)
    isdig = (mat >= 48) & (mat <= 57)
    d = _digits(mat)
    days, ok = _date_parts(mat, isdig)
    sep = (mat[:, 10] == _SP) | (mat[:, 10] == ord("T"))
    hh, okh = _num(d, isdig, 11, 13)
    mi, okm = _num(d, isdig, 14, 16)
    ss, oks = _num(d, isdig, 17, 19)
    has_h, has_m, has_s = ln >= 13, ln >= 16, ln >= 19
    ok &= (ln == 10) | (sep & okh & (hh <= 23) & (ln >= 13))
    ok &= ~has_m | ((mat[:, 13] == ord(":")) & okm & (mi <= 59))
    ok &= ~has_s | ((mat[:, 16] == ord(":")) & oks & (ss <= 59))
    ok &= (ln == 10) | (ln == 13) | (ln == 16) | (ln == 19) \
        | ((ln >= 21) & (mat[:, 19] == ord(".")))
    us = torch.zeros_like(days)
    j = torch.arange(26, device=cs.device)[None, :]
    fr = (j >= 20) & (j < ln[:, None])
    ok &= ~(fr & ~isdig).any(1)
    for k in range(20, 26):
        us = us * 10 + torch.where(fr[:, k], d[:, k], 0)
    hh = torch.where(has_h, hh, 0)
    mi = torch.where(has_m, mi, 0)
    ss = torch.where(has_s, ss, 0)
    total = ((days * 24 + hh) * 60 + mi) * 60 + ss
    return total * 1_000_000 + us, ok & live & (ln <= 26)


def _convert_bool(f, ch, live, tables):
    tv = _matches(f.key8, f.ln, tables["true"]) & (f.ln <= 8)
    fv = _matches(f.key8, f.ln, tables["false"]) & (f.ln <= 8)
    return tv, live & (tv | fv) & ~f.escaped


# ---------------------------------------------------------------------------
# strings
# ---------------------------------------------------------------------------

def _string_chunk(f: _Field, ch: _Chunk, live):
    """(device codes into `values`, values (numpy bytes, sorted), host
    rows, their values (numpy bytes)): the chunk's dictionary of the
    strings of at most 32 bytes, sorted on the device, and the rest for
    the host."""
    dev = f.cs.device
    on_dev = live & ~f.escaped & (f.ln <= _DEVICE_STRING_BYTES)
    host_rows = torch.nonzero(live & ~on_dev).squeeze(1)
    idx = torch.nonzero(on_dev).squeeze(1)
    codes = torch.zeros(f.n, dtype=torch.int32, device=dev)
    values = np.zeros(0, dtype="S1")
    if idx.numel():
        cs, ln = f.cs[idx], f.ln[idx]
        words = (int(ln.max()) + 7) // 8
        mat, _ = ch.gather(cs, ln, words * 8)
        keys = []
        for w in range(words):
            k = torch.zeros(idx.numel(), dtype=torch.int64, device=dev)
            for i in range(8):
                k |= mat[:, 8 * w + i].to(torch.int64) << (8 * (7 - i))
            keys.append(k ^ _INT64_MIN)        # unsigned order as signed
        keys.append(ln)
        del mat
        perm = torch.arange(idx.numel(), device=dev)
        for k in reversed(keys):               # least significant first
            _, o = torch.sort(k[perm], stable=True)
            perm = perm[o]
        sk = torch.stack([k[perm] for k in keys], 1)
        del keys
        new = torch.ones(idx.numel(), dtype=torch.bool, device=dev)
        new[1:] = (sk[1:] != sk[:-1]).any(1)
        gid = torch.cumsum(new, 0, dtype=torch.int32) - 1
        local = torch.empty_like(gid)
        local[perm] = gid
        codes[idx] = local
        uniq = sk[new][:, :words].cpu().numpy()
        # the words back to bytes, as fixed-width byte strings (zero
        # padded, which numpy's bytes order and equality ignore)
        raw = (uniq ^ np.int64(_INT64_MIN)).astype(">i8")
        values = raw.view(f"S{words * 8}").reshape(-1)
    host_idx = host_rows.cpu().numpy()
    host_vals = np.array([f.host_text(int(i)).encode("utf-8")
                          for i in host_idx], dtype=object)
    return codes, values, host_idx, host_vals


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------

class _ColumnOut:
    """A column's pieces, chunk by chunk, on the host."""

    def __init__(self, dtype):
        self.dtype = dtype
        self.parts = []          # (values, nulls) per chunk
        self.str_parts = []      # (codes, device values, host rows, host
        #                           values, nulls) per chunk


# pyarrow's order of inferred kinds
_KINDS = ["null", "int", "bool", "date", "time", "ts", "tsz", "double",
          "string"]
_KIND_TYPE = {"null": None, "int": T.BIGINT, "bool": T.BOOLEAN,
              "date": T.DATE, "time": T.TIME, "ts": T.TIMESTAMP,
              "tsz": T.TIMESTAMP, "double": T.DOUBLE, "string": T.VARCHAR}


def _kind_takes(kind, f: _Field, ch: _Chunk, live, tables) -> bool:
    if kind == "null":
        return not bool(live.any())
    if kind == "string":
        return True
    if kind in ("time", "tsz"):
        rows = torch.nonzero(live).squeeze(1).cpu().numpy()
        if kind == "time":
            return all(_host_time(f.host_text(int(r))) is not None
                       for r in rows)
        return all(_host_timestamp(f.host_text(int(r)), True, 9)
                   is not None for r in rows)
    conv, host = {
        "int": (_convert_int, _host_int),
        "double": (_convert_double, _host_float),
        "date": (_convert_date, _host_date),
        "ts": (_convert_timestamp,
               lambda t: _host_timestamp(t, False, 9)),
        "bool": (lambda f_, c_, l_: _convert_bool(f_, c_, l_, tables),
                 _host_bool)}[kind]
    _, ok = conv(f, ch, live)
    bad = torch.nonzero(live & ~(ok & ~f.escaped)).squeeze(1).cpu().numpy()
    return all(host(f.host_text(int(r))) is not None for r in bad)


def _infer_kind(f: _Field, ch: _Chunk, tables, current: str) -> str:
    """The first of pyarrow's inferred kinds, from `current` on, that
    converts every non-NULL field of this chunk."""
    live = ~f.null
    for kind in _KINDS[_KINDS.index(current):]:
        if _kind_takes(kind, f, ch, live, tables):
            return kind
    return "string"


def _convert(f: _Field, ch: _Chunk, dt: DataType, col: int, tables,
             inferred: Optional[str] = None, clock=None):
    """Values (host ndarray, 0 where NULL) of one typed column of a
    chunk.  `inferred`: the kind pyarrow inferred, whose parse this
    follows."""
    live = ~f.null
    tid = dt.id
    host = None
    if tid == TypeId.BIGINT:
        vals, ok = _convert_int(f, ch, live)
        host = _host_int
    elif tid == TypeId.DOUBLE:
        vals, ok = _convert_double(f, ch, live, STATS)
        host = _host_float
    elif tid == TypeId.DECIMAL:
        vals, ok = _convert_decimal(f, ch, live, dt.width, dt.scale)
    elif tid == TypeId.DATE:
        vals, ok = _convert_date(f, ch, live)
        host = _host_date
    elif tid == TypeId.TIMESTAMP and inferred == "tsz":
        vals = torch.zeros(f.n, dtype=torch.int64, device=f.cs.device)
        ok = torch.zeros_like(live)
        host = (lambda t: _host_timestamp(t, True, 9))
    elif tid == TypeId.TIMESTAMP:
        vals, ok = _convert_timestamp(f, ch, live)
        host = _host_timestamp if inferred is None \
            else (lambda t: _host_timestamp(t, False, 9))
    elif tid == TypeId.BOOLEAN:
        vals, ok = _convert_bool(f, ch, live, tables)
        host = _host_bool
    else:
        raise TypeError(f"unsupported arrow type {_arrow_name(dt)} for "
                        f"column #{col}")
    ok = ok & ~f.escaped
    vals = torch.where(live, vals, torch.zeros_like(vals))
    bad = torch.nonzero(live & ~ok).squeeze(1).cpu().numpy()
    fixed = []
    for r in bad:
        text = f.host_text(int(r))
        if host is None:
            v = _host_decimal(text, dt.width, dt.scale, col)
        else:
            v = host(text)
            if v is None:
                if tid == TypeId.TIMESTAMP and \
                        _host_timestamp(text, True, 6) is not None:
                    raise CsvError(f"In CSV column #{col}: CSV conversion "
                                   f"error to timestamp[us]: expected no "
                                   f"zone offset in '{text}'")
                raise _conversion_error(col, dt, text if tid in (
                    TypeId.BOOLEAN, TypeId.TIMESTAMP) else text.strip(_WS))
        fixed.append(v)
    if len(bad):
        vals[torch.from_numpy(bad).to(vals.device)] = torch.tensor(
            fixed, dtype=vals.dtype).to(vals.device)
    if tid == TypeId.DOUBLE:
        STATS["slow_float_rows"] += len(bad)
    STATS["host_rows"] += len(bad)
    if clock is not None:
        clock.lap("convert")
    return vals


def _store(out: _ColumnOut, f: _Field, ch: _Chunk, col: int, tables,
           clock, inferred=None):
    # the chunk's values stay on the device until the whole column is
    # known: one download a column (and, for strings, one remapping of
    # the chunk's codes into the file's dictionary, on the device)
    if out.dtype.id == TypeId.VARCHAR:
        codes, values, hidx, hvals = _string_chunk(f, ch, ~f.null)
        out.str_parts.append((codes, values, hidx, hvals, f.null))
        clock.lap("dictionary")
        return
    out.parts.append((_convert(f, ch, out.dtype, col, tables, inferred,
                               clock), f.null))


_READ_THREADS = 8
_READ_PIECE = 64 << 20


def _read_into(fh, buf: np.ndarray, at: int) -> int:
    """Fill buf[at:] from the file's position on, in pieces read by
    several threads at once; the bytes read."""
    from concurrent.futures import ThreadPoolExecutor
    fd, pos = fh.fileno(), fh.tell()
    want = min(len(buf) - at, os.fstat(fd).st_size - pos)
    if want <= 0:
        return 0
    view = memoryview(buf)

    def piece(off):
        end = min(off + _READ_PIECE, want)
        while off < end:
            n = os.preadv(fd, [view[at + off:at + end]], pos + off)
            if not n:
                break
            off += n
        return off

    if want <= _READ_PIECE:
        piece(0)
    else:
        with ThreadPoolExecutor(_READ_THREADS) as ex:
            list(ex.map(piece, range(0, want, _READ_PIECE)))
    fh.seek(pos + want)
    return want


def _staging(nbytes: int, pin: bool) -> torch.Tensor:
    return torch.empty(nbytes + 1, dtype=torch.uint8, pin_memory=pin)


def _tables(device):
    return {"null": _spelling_table(NULL_VALUES, device),
            "true": _spelling_table(TRUE_VALUES, device),
            "false": _spelling_table(FALSE_VALUES, device)}


def _upload(staging: torch.Tensor, length: int, device) -> torch.Tensor:
    """The chunk on the device, padded with zeros for the strided
    window."""
    b = torch.zeros(length + _FAST_WIDTH + 1, dtype=torch.uint8,
                    device=device)
    b[:length].copy_(staging[:length])
    return b


def read(path: str, names: Optional[Sequence[str]] = None,
         types: Optional[Sequence[Optional[DataType]]] = None, *,
         delimiter: str = ",", quote: str = '"',
         skip_first_line: bool = False, device=None,
         table_name: str = "read_csv") -> TableData:
    """Parse the CSV file at `path` on `device` (the statement's device
    when None).

    `names`: the column names, every row holding that many fields; None
    takes them from the first row.  `types`: one port type a column
    (BIGINT, DOUBLE, DECIMAL(p,s), DATE, TIMESTAMP, BOOLEAN, VARCHAR), or
    None where pyarrow's inference decides.  `skip_first_line` skips one
    physical line first, as pyarrow's `skip_rows=1` does."""
    from ..batch import current_bind_device
    device = torch.device(device) if device is not None \
        else current_bind_device()
    for k in STATS:
        STATS[k] = 0
    TIMINGS.clear()
    clock = _Clock(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    delim, qb = ord(delimiter), ord(quote)
    tables = _tables(device)
    size = os.path.getsize(path)
    STATS["file_bytes"] = size
    pin = device.type == "cuda"
    cap = max(min(CHUNK_BYTES, size), 1)
    staging = _staging(cap, pin)
    host = staging.numpy()
    names = list(names) if names is not None else None
    types = list(types) if types is not None else None
    outs = kinds = None
    raw_chunks = []               # kept while a column's kind is inferred
    carry, line0 = 0, 0
    with open(path, "rb") as fh:
        while True:
            length = carry + _read_into(fh, host[:cap], carry)
            eof = fh.tell() >= size
            clock.lap("file_read")
            if skip_first_line:
                end = _first_line_end(host, length)
                if end is None and not eof:
                    cap *= 2
                    staging, host = _regrow(staging, host, length, cap, pin)
                    carry = length
                    continue
                start = length if end is None else end + 1
                if end is not None and host[end] == _CR and start < length \
                        and host[start] == _LF:
                    start += 1
                host[:length - start] = host[start:length]
                length -= start
                skip_first_line = False
                line0 = 1
            dev_bytes = _upload(staging, length, device)
            clock.lap("upload")
            try:
                tok = _tokenize(dev_bytes, length, delim, qb, eof)
                chunk_host = host
            except _OddQuotes:
                # the whole chunk re-read byte by byte on the host
                STATS["odd_quote_chunks"] += 1
                canon, taken = _canonical(host[:length], delim, qb, eof)
                chunk_host = np.frombuffer(canon, dtype=np.uint8)
                dev_bytes = _upload(torch.from_numpy(chunk_host.copy()),
                                    len(canon), device)
                tok = None if not taken else _tokenize(
                    dev_bytes, len(canon), delim, qb, True)
                if tok is not None:
                    tok = tok[:4] + (taken,)
            if tok is None:            # no row end yet: a longer chunk
                cap *= 2
                staging, host = _regrow(staging, host, length, cap, pin)
                carry = length
                continue
            starts, ends, row_end, esc, cut = tok
            if chunk_host is host:
                chunk_host = host[:cut]
            if names is None:
                # the header: the first row's fields, quote-aware
                if starts.numel() == 0:
                    raise CsvError("Empty CSV file")
                hn = int(torch.nonzero(row_end)[0, 0]) + 1
                names = []
                for s, e in zip(starts[:hn].tolist(), ends[:hn].tolist()):
                    raw = bytes(chunk_host[s:e])
                    if raw[:1] == bytes([qb]) and len(raw) >= 2:
                        raw = raw[1:-1].replace(b'""', b'"')
                    names.append(raw.decode("utf-8"))
                starts, ends, row_end = starts[hn:], ends[hn:], row_end[hn:]
            if outs is None:
                types = types or [None] * len(names)
                kinds = ["null" if t is None else None for t in types]
                outs = [_ColumnOut(t) for t in types]
            s2, e2 = _rows(chunk_host, starts, ends, row_end, len(names),
                           line0)
            del starts, ends, row_end
            clock.lap("tokenize")
            ch = _Chunk(dev_bytes, chunk_host, s2, e2, esc, line0)
            if ch.rows:
                if any(k is not None for k in kinds):
                    raw_chunks.append(_RawChunk(ch))
                for c, out in enumerate(outs):
                    f = _Field(ch, c, qb, tables)
                    if kinds[c] is not None:
                        kinds[c] = _infer_kind(f, ch, tables, kinds[c])
                        clock.lap("convert")
                    else:
                        _store(out, f, ch, c, tables, clock)
            STATS["rows"] += ch.rows
            STATS["chunks"] += 1
            line0 += int(np.count_nonzero(chunk_host == _LF))
            del ch, s2, e2, dev_bytes, esc
            rest = length - cut
            host[:rest] = host[cut:length]
            carry = rest
            if eof:
                break
    if names is None:
        raise CsvError("Empty CSV file")
    if outs is None:
        types = types or [None] * len(names)
        kinds = ["null" if t is None else None for t in types]
        outs = [_ColumnOut(t) for t in types]
    _convert_inferred(raw_chunks, outs, kinds, qb, device, clock)
    if device.type == "cuda":
        STATS["peak_bytes"] = torch.cuda.max_memory_allocated(device) - base
    cols = [_finish(names[i], outs[i], STATS["rows"], clock)
            for i in range(len(names))]
    td = TableData(table_name, cols)
    clock.lap("assemble")
    return td


def _first_line_end(host: np.ndarray, length: int) -> Optional[int]:
    """Index of the first CR or LF in host[:length], or None; searched
    in growing windows, not over the whole chunk."""
    lo, width = 0, 1 << 16
    while lo < length:
        hi = min(length, lo + width)
        hits = np.flatnonzero((host[lo:hi] == _LF) | (host[lo:hi] == _CR))
        if len(hits):
            return lo + int(hits[0])
        lo, width = hi, width * 2
    return None


def _regrow(staging, host, keep, cap, pin):
    bigger = _staging(cap, pin)
    bigger.numpy()[:keep] = host[:keep]
    return bigger, bigger.numpy()


class _RawChunk:
    """A chunk kept on the host while a column's kind is inferred: every
    chunk is converted again once the whole file has decided."""

    def __init__(self, ch: _Chunk):
        self.host = np.array(ch.host, copy=True)
        self.starts = ch.starts.cpu()
        self.ends = ch.ends.cpu()
        self.esc = None if ch.esc is None else ch.esc.cpu()
        self.line0 = ch.line0


def _raw_on_device(r: "_RawChunk", device) -> _Chunk:
    b = torch.zeros(len(r.host) + _FAST_WIDTH + 1, dtype=torch.uint8,
                    device=device)
    b[:len(r.host)] = torch.from_numpy(r.host).to(device)
    return _Chunk(b, r.host, r.starts.to(device), r.ends.to(device),
                  None if r.esc is None else r.esc.to(device), r.line0)


def _convert_inferred(raw_chunks, outs, kinds, qb, device, clock):
    todo = [c for c, k in enumerate(kinds) if k is not None]
    tables = _tables(device)
    if len(raw_chunks) > 1:
        # a kind a later chunk chose must take every earlier chunk too:
        # widen until every chunk of the column converts under it
        for c in todo:
            settled = False
            while not settled:
                settled = True
                for r in raw_chunks:
                    ch = _raw_on_device(r, device)
                    k = _infer_kind(_Field(ch, c, qb, tables), ch, tables,
                                    kinds[c])
                    if k != kinds[c]:
                        kinds[c], settled = k, False
    for c in todo:
        dt = _KIND_TYPE[kinds[c]]
        if dt is not None and dt.id == TypeId.TIME:
            raise TypeError(f"unsupported arrow type time32[s] for column "
                            f"#{c}")
        outs[c].dtype = dt
    todo = [c for c in todo if outs[c].dtype is not None]
    if not todo:
        return
    for r in raw_chunks:
        ch = _raw_on_device(r, device)
        for c in todo:
            _store(outs[c], _Field(ch, c, qb, tables), ch, c, tables, clock,
                   inferred=kinds[c])


def _finish(name: str, out: _ColumnOut, nrows: int, clock) -> TableColumn:
    """One column of the table, its chunks joined on the device and
    downloaded once ("download" in TIMINGS; the host's work, and the
    table's stats, are "assemble")."""
    dt = out.dtype
    if dt is None:
        # pyarrow's null type: the reference stores an all-NULL INTEGER
        return TableColumn(name, T.INTEGER, np.zeros(nrows, dtype=np.int32),
                           np.ones(nrows, dtype=bool) if nrows else None)
    if dt.id == TypeId.VARCHAR:
        return _finish_strings(name, out, clock)
    if dt.id == TypeId.DECIMAL:
        store = T.DECIMAL(min(dt.width, 18), dt.scale)
    else:
        store = dt
    if out.parts:
        clock.lap("assemble")
        tdt = torch.from_numpy(np.zeros(0, dtype=store.np_dtype)).dtype
        data = torch.cat([p[0] for p in out.parts]).to(tdt).cpu().numpy()
        nulls = torch.cat([p[1] for p in out.parts]).cpu().numpy()
        out.parts.clear()
        clock.lap("download")
    else:
        data = np.zeros(0, dtype=store.np_dtype)
        nulls = np.zeros(0, dtype=bool)
    return TableColumn(name, store, data, nulls if nulls.any() else None)


def _finish_strings(name: str, out: _ColumnOut, clock) -> TableColumn:
    """The column's dictionary (StringDictionary.encode's: sorted unique
    values, "" among them when a row is NULL) and codes, from each
    chunk's."""
    parts = out.str_parts
    any_null = any(bool(p[4].any()) for p in parts)
    pieces = [p[1] for p in parts] + [
        np.array(list(p[3]), dtype="S") for p in parts if len(p[3])]
    if any_null:
        pieces.append(np.array([b""], dtype="S1"))
    pieces = [p for p in pieces if len(p)]
    # UTF-8 byte order is code-point order, numpy's order of str
    uniq = np.unique(np.concatenate(pieces)) if pieces \
        else np.zeros(0, dtype="S1")
    codes, nulls = [], []
    for pc, values, hidx, hvals, pn in parts:
        if len(values):
            lut = torch.from_numpy(np.searchsorted(uniq, values)
                                   .astype(np.int32)).to(pc.device)
            c = lut[pc.to(torch.int64)]
        else:
            c = torch.zeros_like(pc)
        if len(hidx):
            c[torch.from_numpy(hidx).to(pc.device)] = torch.from_numpy(
                np.searchsorted(uniq, np.array(list(hvals), dtype="S"))
                .astype(np.int32)).to(pc.device)
        codes.append(torch.where(pn, torch.zeros_like(c), c))
        nulls.append(pn)
    parts.clear()
    clock.lap("assemble")
    data = torch.cat(codes).cpu().numpy() if codes \
        else np.zeros(0, dtype=np.int32)
    nulls = torch.cat(nulls).cpu().numpy() if nulls \
        else np.zeros(0, dtype=bool)
    clock.lap("download")
    text = np.char.decode(uniq, "utf-8") if len(uniq) \
        else np.zeros(0, dtype="<U1")
    return TableColumn(name, T.VARCHAR, data,
                       nulls if nulls.any() else None,
                       strdict=StringDictionary(text))
