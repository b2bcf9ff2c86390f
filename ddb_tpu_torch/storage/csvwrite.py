"""CSV writer in torch on the connection's device.

The port's counterpart of the reference's `pyarrow.csv.write_csv(...,
WriteOptions(quoting_style="needed"))` calls (ddb_tpu/api.py,
`_execute_copy` and `_execute_export`): the same bytes for the same
result.  Arrow's rules, pinned by tests/test_torch_copy.py:

* the header names are quoted, a quote doubled; so is every string value;
  NULL is an empty field; rows end in LF;
* booleans are `true`/`false`; dates `2020-01-02`; timestamps
  `2020-01-02 03:04:05.000006` (a `Z` after one with a time zone); times
  `03:04:05.000006`; decimals with all their scale's digits;
* doubles in their shortest form that reads back to the same double,
  laid out as Arrow's formatter does: positional when the decimal
  exponent is in [-6, 10), else `d.ddde+XX` (`100`, `1e+15`, `0.00001`,
  `-0`, `inf`, `nan`).

Rows are formatted in chunks on the device: each column becomes a
[rows, W] byte matrix and a mask of its valid bytes; the row's bytes are
the concatenation of its columns' with the delimiter between them, and
one masked select compacts them.  A double's shortest digits come from
the smallest precision p (at most 15) at which exactly one of the three
integers nearest a * 10^j reads back to a (a read that is exact: Clinger's
fast path); the rest (16 or 17 digits, two candidates, far exponents)
take numpy's shortest repr, converted on the host in one call and parsed
on the device, and are counted in `STATS["slow_float_rows"]`.  Nested
values are rendered on the host by expr/nestedtext.render_value, as the
reference does.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import types as T
from ..types import TypeId

# rows formatted at once: about this many bytes of row matrix
_CHUNK_BYTES = 1 << 28

STATS = {"rows": 0, "bytes": 0, "slow_float_rows": 0}



class ArrowNotImplementedError(NotImplementedError):
    """A value the reference's pyarrow writer has no text for (pyarrow
    raises its ArrowNotImplementedError for the same value)."""


class _Col:
    """One output column: name, type, data and NULL mask (tensors on one
    device, live rows only) and its dictionary or store."""

    def __init__(self, name, dtype, data, nulls, strdict):
        self.name = name
        self.dtype = dtype
        self.data = data
        self.nulls = nulls
        self.strdict = strdict
        self.table = None        # string columns: (bytes [k, W], lengths)


# ---------------------------------------------------------------------------
# host text of one value (the slow paths), as Arrow writes it
# ---------------------------------------------------------------------------

def _arrow_double(x: float) -> str:
    if math.isnan(x):
        return "nan"
    if math.isinf(x):
        return "inf" if x > 0 else "-inf"
    if x == 0:
        return "-0" if math.copysign(1.0, x) < 0 else "0"
    r = repr(abs(x))
    mant, _, exp = r.partition("e")
    ip, _, fp = mant.partition(".")
    if fp == "0":
        fp = ""
    digits = (ip + fp).lstrip("0")
    lead = len(ip + fp) - len((ip + fp).lstrip("0"))
    dp = len(ip) - lead + (int(exp) if exp else 0)
    digits = digits.rstrip("0") or "0"
    return ("-" if x < 0 else "") + _layout(digits, dp)


def _layout(digits: str, dp: int) -> str:
    """double-conversion's ToShortest layout of 0.digits * 10^dp with
    Arrow's settings (positional for exponents in [-6, 10))."""
    nd = len(digits)
    exponent = dp - 1
    if -6 <= exponent < 10:
        if dp <= 0:
            return "0." + "0" * (-dp) + digits
        if dp >= nd:
            return digits + "0" * (dp - nd)
        return digits[:dp] + "." + digits[dp:]
    out = digits[0] + ("." + digits[1:] if nd > 1 else "")
    return out + "e" + ("+" if exponent >= 0 else "-") + str(abs(exponent))


def _arrow_float32(x) -> str:
    x = np.float32(x)
    if np.isnan(x) or np.isinf(x) or x == 0:
        return _arrow_double(float(x))
    s = np.format_float_scientific(abs(x), unique=True, trim="-")
    mant, _, exp = s.partition("e")
    digits = mant.replace(".", "").rstrip("0") or "0"
    dp = 1 + int(exp)
    return ("-" if x < 0 else "") + _layout(digits, dp)


def _civil(days: int):
    z = days + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + 3 if mp < 10 else mp - 9
    return y + (m <= 2), m, d


def _arrow_date(days: int) -> str:
    y, m, d = _civil(days)
    ys = f"{y:04d}" if y >= 0 else "-" + f"{-y:04d}"
    return f"{ys}-{m:02d}-{d:02d}"


def _in_range(days: int) -> bool:
    """Arrow formats years -32767 to 32767, else '<value out of range>'."""
    return -32767 <= _civil(days)[0] <= 32767


def _arrow_time_of_day(us: int) -> str:
    s, f = divmod(us, 1_000_000)
    return f"{s // 3600:02d}:{s // 60 % 60:02d}:{s % 60:02d}.{f:06d}"


def _arrow_timestamp(us: int) -> str:
    days, rem = divmod(us, 86_400_000_000)
    return _arrow_date(days) + " " + _arrow_time_of_day(rem)


def _quoted(s: str) -> bytes:
    return b'"' + s.encode("utf-8").replace(b'"', b'""') + b'"'


# ---------------------------------------------------------------------------
# device formatting: (bytes [n, W] uint8, valid [n, W] bool)
# ---------------------------------------------------------------------------

def _const(n, text: bytes, device):
    row = torch.tensor(list(text), dtype=torch.uint8, device=device)
    return row.expand(n, len(text)), torch.ones((n, len(text)),
                                                dtype=torch.bool,
                                                device=device)


def _digits_right(v: torch.Tensor, width: int):
    """(ASCII digits of |v|, right-aligned in [n, width], digit count);
    v int64, INT64_MIN included."""
    nv = torch.where(v > 0, -v, v)                 # <= 0, no overflow
    cols = []
    nd = torch.ones_like(v)
    for k in range(width):
        q = torch.div(nv, 10, rounding_mode="trunc")
        cols.append(q * 10 - nv)
        nv = q
        nd = torch.where(nv != 0, torch.full_like(nd, k + 2), nd)
    d = torch.stack(cols[::-1], 1)
    return (d + 48).to(torch.uint8), nd


def _fmt_int(v: torch.Tensor, min_digits=None):
    n, dev = v.shape[0], v.device
    digits, nd = _digits_right(v, 19)
    if min_digits is not None:
        nd = torch.clamp(nd, min=min_digits)
    j = torch.arange(19, device=dev)[None, :]
    valid = j >= (19 - nd)[:, None]
    sign = torch.full((n, 1), ord("-"), dtype=torch.uint8, device=dev)
    return (torch.cat([sign, digits], 1),
            torch.cat([(v < 0)[:, None], valid], 1))


def _fmt_decimal(v: torch.Tensor, scale: int):
    if scale == 0:
        return _fmt_int(v)
    n, dev = v.shape[0], v.device
    mat, valid = _fmt_int(v, min_digits=scale + 1)
    cut = 20 - scale
    dot = torch.full((n, 1), ord("."), dtype=torch.uint8, device=dev)
    return (torch.cat([mat[:, :cut], dot, mat[:, cut:]], 1),
            torch.cat([valid[:, :cut], torch.ones((n, 1), dtype=torch.bool,
                                                  device=dev),
                       valid[:, cut:]], 1))


def _two(v):
    return torch.stack([v // 10 + 48, v % 10 + 48], 1).to(torch.uint8)


def _civil_dev(days: torch.Tensor):
    z = days + 719468
    era = torch.div(z, 146097, rounding_mode="floor")
    doe = z - era * 146097
    yoe = torch.div(doe - torch.div(doe, 1460, rounding_mode="floor")
                    + torch.div(doe, 36524, rounding_mode="floor")
                    - torch.div(doe, 146096, rounding_mode="floor"), 365,
                    rounding_mode="floor")
    y = yoe + era * 400
    doy = doe - (365 * yoe + torch.div(yoe, 4, rounding_mode="floor")
                 - torch.div(yoe, 100, rounding_mode="floor"))
    mp = torch.div(5 * doy + 2, 153, rounding_mode="floor")
    d = doy - torch.div(153 * mp + 2, 5, rounding_mode="floor") + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    return y + (m <= 2).to(torch.int64), m, d


def _date_bytes(days: torch.Tensor):
    """([n, 10] 'YYYY-MM-DD', in range): years 0000 to 9999."""
    y, m, d = _civil_dev(days)
    ok = (y >= 0) & (y <= 9999)
    yc = y.clamp(0, 9999)
    n, dev = days.shape[0], days.device
    dash = torch.full((n, 1), ord("-"), dtype=torch.uint8, device=dev)
    mat = torch.cat([_two(yc // 100), _two(yc % 100), dash, _two(m), dash,
                     _two(d)], 1)
    return mat, ok


def _time_bytes(us: torch.Tensor):
    """[n, 15] 'HH:MM:SS.ffffff' of microseconds within a day."""
    n, dev = us.shape[0], us.device
    s = torch.div(us, 1_000_000, rounding_mode="floor")
    f = us - s * 1_000_000
    colon = torch.full((n, 1), ord(":"), dtype=torch.uint8, device=dev)
    dot = torch.full((n, 1), ord("."), dtype=torch.uint8, device=dev)
    frac = torch.stack([torch.div(f, 10 ** (5 - k), rounding_mode="floor")
                        % 10 + 48 for k in range(6)], 1).to(torch.uint8)
    return torch.cat([_two(s // 3600), colon, _two(s // 60 % 60), colon,
                      _two(s % 60), dot, frac], 1)


def _host_date(x) -> str:
    x = int(x)
    return _arrow_date(x) if _in_range(x) \
        else f"<value out of range: {x}>"


def _host_timestamp(x, zone: bool) -> str:
    x = int(x)
    if not _in_range(x // 86_400_000_000):
        return f"<value out of range: {x}>"
    return _arrow_timestamp(x) + ("Z" if zone else "")


def _fmt_date(v):
    mat, ok = _date_bytes(v)
    return mat, torch.ones_like(mat, dtype=torch.bool), _host_date, ok


def _fmt_timestamp(v, zone: bool):
    day = torch.div(v, 86_400_000_000, rounding_mode="floor")
    dmat, ok = _date_bytes(day)
    tmat = _time_bytes(v - day * 86_400_000_000)
    n, dev = v.shape[0], v.device
    parts = [dmat, torch.full((n, 1), ord(" "), dtype=torch.uint8,
                              device=dev), tmat]
    if zone:
        parts.append(torch.full((n, 1), ord("Z"), dtype=torch.uint8,
                                device=dev))
    mat = torch.cat(parts, 1)
    host = (lambda x: _host_timestamp(x, zone))
    return mat, torch.ones_like(mat, dtype=torch.bool), host, ok


_P10 = [10.0 ** i for i in range(23)]


def _shortest(a: torch.Tensor):
    """(digits m, exponent j with a == m * 10^-j, found) of positive
    finite doubles: the smallest precision up to 15 at which exactly one
    candidate reads back to a."""
    dev = a.device
    p10 = torch.tensor(_P10, dtype=torch.float64, device=dev)
    e = torch.floor(torch.log10(a)).to(torch.int64)
    # correct the estimate by exact powers where they exist
    inr = e.abs() <= 22
    pe = p10[e.abs().clamp(max=22)]
    pw = torch.where(e >= 0, pe, 1.0 / pe)
    e = torch.where(inr & (e >= 0) & (pw > a), e - 1, e)
    pe1 = p10[(e + 1).abs().clamp(max=22)]
    pw1 = torch.where(e + 1 >= 0, pe1, 1.0 / pe1)
    e = torch.where(((e + 1).abs() <= 22) & (e + 1 >= 0) & (pw1 <= a),
                    e + 1, e)
    found = torch.zeros_like(a, dtype=torch.bool)
    amb = torch.zeros_like(found)
    m_out = torch.zeros_like(e)
    j_out = torch.zeros_like(e)
    for p in range(1, 16):
        j = p - 1 - e
        ok = (j.abs() <= 22) & ~found & ~amb
        mag = p10[j.abs().clamp(max=22)]
        s = torch.where(j >= 0, a * mag, a / mag)
        m = torch.round(s)
        hits = torch.zeros_like(e)
        pick = torch.zeros_like(e)
        for dlt in (-1.0, 0.0, 1.0):
            c = m + dlt
            back = torch.where(j >= 0, c / mag, c * mag)
            hit = ok & (c > 0) & (c < 1e15) & (back == a)
            hits += hit.to(torch.int64)
            pick = torch.where(hit, c.to(torch.int64), pick)
        one = ok & (hits == 1)
        amb |= ok & (hits > 1)
        m_out = torch.where(one, pick, m_out)
        j_out = torch.where(one, j, j_out)
        found |= one
    return m_out, j_out, found


def _shortest_repr(a: torch.Tensor):
    """(m, j) of positive finite doubles from numpy's shortest repr of
    them (one conversion on the host), parsed on the device."""
    dev = a.device
    text = np.ascontiguousarray(a.cpu().numpy().astype("S32"))
    mat = torch.from_numpy(text.view(np.uint8).reshape(-1, 32)).to(dev)
    k = torch.arange(32, device=dev)[None, :]
    isdig = (mat >= 48) & (mat <= 57)
    ise = mat == ord("e")
    epos = torch.where(ise.any(1), torch.argmax(ise.to(torch.uint8), 1),
                       (mat != 0).sum(1))
    isdot = mat == ord(".")
    dpos = torch.where(isdot.any(1), torch.argmax(isdot.to(torch.uint8), 1),
                       epos)
    mant = isdig & (k < epos[:, None])
    edig = isdig & (k > epos[:, None])
    m = torch.zeros(a.shape[0], dtype=torch.int64, device=dev)
    ex = torch.zeros_like(m)
    for i in range(32):
        d = mat[:, i].to(torch.int64) - 48
        m = torch.where(mant[:, i], m * 10 + d, m)
        ex = torch.where(edig[:, i], ex * 10 + d, ex)
    eneg = (mat.gather(1, (epos + 1).clamp(max=31)[:, None]).squeeze(1)
            == ord("-"))
    nfrac = (mant & (k > dpos[:, None])).sum(1)
    return m, nfrac - torch.where(eneg, -ex, ex)


def _fmt_double(v: torch.Tensor):
    n, dev = v.shape[0], v.device
    a = v.abs()
    finite = torch.isfinite(v) & (a > 0)
    m, j, found = _shortest(torch.where(finite, a, torch.ones_like(a)))
    found &= finite
    # 16 or 17 digits, or a power of ten beyond 22: numpy's shortest repr
    rest = torch.nonzero(finite & ~found).squeeze(1)
    if rest.numel():
        m[rest], j[rest] = _shortest_repr(a[rest])
        found[rest] = True
        STATS["slow_float_rows"] += rest.numel()
    # strip trailing zeros
    for _ in range(16):
        z = found & (m % 10 == 0) & (m > 0)
        m = torch.where(z, torch.div(m, 10, rounding_mode="trunc"), m)
        j = torch.where(z, j - 1, j)
    digits, nd = _digits_right(m, 17)          # right-aligned, 17 wide
    dp = nd - j
    # left-align the digits: D[i] = digits[:, 17 - nd + i]
    W = 25
    k = torch.arange(W, device=dev)[None, :].expand(n, W)
    neg = (v < 0) | ((v == 0) & (torch.signbit(v)))
    sl = neg.to(torch.int64)[:, None]
    pos = k - sl
    ndc, dpc = nd[:, None], dp[:, None]
    exponent = dpc - 1
    positional = (exponent >= -6) & (exponent < 10)
    # a source table per row: 17 digits, then '0', '.', 'e', '+', '-', and
    # three exponent digits
    ex = exponent.abs().squeeze(1)
    exd, exn = _digits_right(ex, 3)
    lit = torch.tensor([48, 46, 101, 43, 45], dtype=torch.uint8,
                       device=dev).expand(n, 5)
    table = torch.cat([digits, lit, exd], 1)    # [n, 25]
    ZERO, DOT, E, PLUS, MINUS = 17, 18, 19, 20, 21

    def dig(i):                                   # i-th digit from the left
        return 17 - ndc + i

    z = -dpc
    # positional, dp <= 0: 0 . zeros digits
    a_idx = torch.where(pos == 0, ZERO, torch.where(
        pos == 1, DOT, torch.where(pos < 2 + z, ZERO, dig(pos - 2 - z))))
    a_len = 2 + z + ndc
    # positional, dp >= nd: digits zeros
    b_idx = torch.where(pos < ndc, dig(pos), ZERO)
    b_len = dpc
    # positional, 0 < dp < nd: digits . digits
    c_idx = torch.where(pos < dpc, dig(pos), torch.where(
        pos == dpc, DOT, dig(pos - 1)))
    c_len = ndc + 1
    # exponential: d [. ddd] e +/- exponent digits
    q = torch.where(ndc > 1, ndc + 1, torch.ones_like(ndc))
    exn_c = exn[:, None]
    d_idx = torch.where(pos == 0, dig(0), torch.where(
        (pos == 1) & (ndc > 1), DOT, torch.where(
            pos < q, dig(pos - 1), torch.where(
                pos == q, E, torch.where(
                    pos == q + 1, torch.where(exponent >= 0, PLUS, MINUS),
                    22 + 3 - exn_c + (pos - q - 2))))))
    d_len = q + 2 + exn_c
    idx = torch.where(positional, torch.where(
        dpc <= 0, a_idx, torch.where(dpc >= ndc, b_idx, c_idx)), d_idx)
    ln = torch.where(positional, torch.where(
        dpc <= 0, a_len, torch.where(dpc >= ndc, b_len, c_len)), d_len)
    idx = torch.where(pos < 0, MINUS, idx)
    mat = table.gather(1, idx.clamp(0, 24))
    valid = (pos < ln) & ((pos >= 0) | neg[:, None])
    # zero, inf and nan: constants
    for text, sel in ((b"0", (v == 0) & ~neg), (b"-0", (v == 0) & neg),
                      (b"inf", torch.isposinf(v)),
                      (b"-inf", torch.isneginf(v)), (b"nan", torch.isnan(v))):
        if bool(sel.any()):
            row = torch.zeros(W, dtype=torch.uint8, device=dev)
            row[:len(text)] = torch.tensor(list(text), dtype=torch.uint8,
                                           device=dev)
            mat = torch.where(sel[:, None], row[None, :], mat)
            valid = torch.where(sel[:, None],
                                (torch.arange(W, device=dev) < len(text))
                                [None, :], valid)
    return mat, valid


def _fmt_bool(v):
    dev = v.device
    table = torch.tensor([list(b"false"), list(b"true\0")],
                         dtype=torch.uint8, device=dev)
    mat = table[v.to(torch.int64)]
    valid = torch.arange(5, device=dev)[None, :] < torch.where(
        v, 4, 5)[:, None]
    return mat, valid


def _string_table(values, device):
    """(quoted bytes [k, W], lengths [k]) of a dictionary's values."""
    enc = [_quoted(str(s)) for s in values]
    width = max((len(b) for b in enc), default=1)
    buf = np.zeros((max(len(enc), 1), width), dtype=np.uint8)
    lens = np.zeros(max(len(enc), 1), dtype=np.int64)
    if enc:
        flat = np.frombuffer(b"".join(enc), dtype=np.uint8)
        lens[:len(enc)] = [len(b) for b in enc]
        starts = np.concatenate([[0], np.cumsum(lens[:len(enc)])[:-1]])
        rows = np.repeat(np.arange(len(enc)), lens[:len(enc)])
        cols = np.arange(len(flat)) - np.repeat(starts, lens[:len(enc)])
        buf[rows, cols] = flat
    return (torch.from_numpy(buf).to(device),
            torch.from_numpy(lens).to(device))


def _host_matrix(texts: List[bytes], device):
    width = max((len(t) for t in texts), default=1) or 1
    buf = np.zeros((len(texts), width), dtype=np.uint8)
    lens = np.array([len(t) for t in texts], dtype=np.int64)
    for i, t in enumerate(texts):
        buf[i, :len(t)] = np.frombuffer(t, dtype=np.uint8)
    mat = torch.from_numpy(buf).to(device)
    valid = torch.arange(width, device=device)[None, :] < \
        torch.from_numpy(lens).to(device)[:, None]
    return mat, valid


def _host_values(col: _Col, lo: int, hi: int) -> List[Optional[bytes]]:
    """The Arrow text of each value of rows lo..hi-1, on the host: nested
    values, blobs, floats and types without a device path."""
    from ..expr.nestedtext import render_value
    from ..storage.nested import StructValue
    t = col.dtype
    data = col.data[lo:hi].cpu().numpy()
    nulls = None if col.nulls is None else col.nulls[lo:hi].cpu().numpy()
    out = []
    for i, raw in enumerate(data):
        if nulls is not None and nulls[i]:
            out.append(None)
            continue
        if t.id == TypeId.FLOAT:
            out.append(_arrow_float32(raw).encode())
            continue
        v = T.decode_value(raw, t, col.strdict)
        if t.id == TypeId.STRUCT:
            out.append(_quoted(render_value(StructValue(dict(v)))))
        elif t.id == TypeId.MAP:
            out.append(_quoted(render_value(dict(v))))
        elif t.id == TypeId.LIST:
            out.append(_quoted(render_value(v)))
        elif t.id == TypeId.BLOB:
            b = bytes(v)
            b.decode("utf-8")              # Arrow: "Invalid UTF8 payload"
            out.append(b'"' + b.replace(b'"', b'""') + b'"')
        elif isinstance(v, str):
            out.append(_quoted(v))
        else:
            out.append(str(v).encode())
    return out


def _format(col: _Col, lo: int, hi: int):
    """(bytes [n, W], valid [n, W]) of rows lo..hi-1 of one column."""
    t = col.dtype
    tid = t.id
    v = col.data[lo:hi]
    dev = v.device
    host = ok = None
    if tid == TypeId.VARCHAR and col.strdict is not None:
        table, lens = col.table
        codes = v.to(torch.int64).clamp(0, table.shape[0] - 1)
        mat = table[codes]
        valid = torch.arange(table.shape[1], device=dev)[None, :] \
            < lens[codes][:, None]
    elif tid == TypeId.BOOLEAN:
        mat, valid = _fmt_bool(v)
    elif tid in (TypeId.TINYINT, TypeId.SMALLINT, TypeId.INTEGER,
                 TypeId.BIGINT):
        mat, valid = _fmt_int(v.to(torch.int64))
    elif tid == TypeId.DECIMAL:
        mat, valid = _fmt_decimal(v.to(torch.int64), t.scale)
    elif tid == TypeId.DOUBLE:
        mat, valid = _fmt_double(v.to(torch.float64))
    elif tid == TypeId.DATE:
        mat, valid, host, ok = _fmt_date(v.to(torch.int64))
    elif tid in (TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ):
        mat, valid, host, ok = _fmt_timestamp(
            v.to(torch.int64), tid == TypeId.TIMESTAMPTZ)
    elif tid == TypeId.TIME:
        us = v.to(torch.int64) % 86_400_000_000
        mat = _time_bytes(us)
        valid = torch.ones_like(mat, dtype=torch.bool)
    elif tid == TypeId.INTERVAL:
        months = torch.div(v.to(torch.int64), T.INTERVAL_MONTH,
                           rounding_mode="floor")
        live = months != 0
        if col.nulls is not None:
            live &= ~col.nulls[lo:hi]
        if bool(live.any()):
            raise ArrowNotImplementedError(
                "Unsupported cast from month_day_nano_interval to utf8 "
                "using function cast_string")
        mat, valid = _fmt_int(v.to(torch.int64))
    else:
        texts = _host_values(col, lo, hi)
        mat, valid = _host_matrix([b"" if x is None else x for x in texts],
                                  dev)
    if ok is not None:
        bad = torch.nonzero(~ok).squeeze(1)
        if col.nulls is not None:
            bad = bad[~col.nulls[lo:hi][bad]]
        if bad.numel():
            vals = v[bad].cpu().numpy()
            hm, hv = _host_matrix([host(x).encode() for x in vals], dev)
            w = max(mat.shape[1], hm.shape[1])
            mat = torch.nn.functional.pad(mat, (0, w - mat.shape[1]))
            valid = torch.nn.functional.pad(valid, (0, w - valid.shape[1]))
            mat[bad] = torch.nn.functional.pad(hm, (0, w - hm.shape[1]))
            valid[bad] = torch.nn.functional.pad(hv, (0, w - hv.shape[1]))
    if col.nulls is not None:
        valid = valid & ~col.nulls[lo:hi][:, None]
    return mat, valid


def header_line(names: Sequence[str], delimiter: str) -> bytes:
    return delimiter.encode().join(_quoted(n) for n in names) + b"\n"


def write_columns(cols: List[_Col], path: str, *, header: bool = True,
                  delimiter: str = ",") -> int:
    """Write the columns (tensors on one device) to `path`; the row
    count."""
    STATS["slow_float_rows"] = 0
    n = int(cols[0].data.shape[0]) if cols else 0
    dev = cols[0].data.device if cols else torch.device("cpu")
    for c in cols:
        if c.dtype.id == TypeId.VARCHAR and c.strdict is not None:
            c.table = _string_table(c.strdict.values, dev)
    written = 0
    with open(path, "wb") as fh:
        if header:
            line = header_line([c.name for c in cols], delimiter)
            fh.write(line)
            written += len(line)
        # a row's widest bytes, for the chunk's size
        width = sum(_width(c) for c in cols) + len(cols)
        step = max(1, min(n, _CHUNK_BYTES // max(width, 1)))
        sep = delimiter.encode()
        for lo in range(0, n, step):
            hi = min(n, lo + step)
            rows = hi - lo
            mats, valids = [], []
            for i, c in enumerate(cols):
                m, v = _format(c, lo, hi)
                mats.append(m)
                valids.append(v)
                tail = sep if i + 1 < len(cols) else b"\n"
                cm, cv = _const(rows, tail, dev)
                mats.append(cm)
                valids.append(cv)
            out = torch.cat(mats, 1)[torch.cat(valids, 1)]
            buf = out.cpu().numpy()
            fh.write(memoryview(buf))
            written += buf.nbytes
            del mats, valids, out
    STATS["rows"] = n
    STATS["bytes"] = written
    return n


def _width(c: _Col) -> int:
    if c.table is not None:
        return int(c.table[0].shape[1])
    return {TypeId.DOUBLE: 25, TypeId.TIMESTAMP: 26,
            TypeId.TIMESTAMPTZ: 27}.get(c.dtype.id, 21)


def write_batch(schema, batch, path: str, *, header: bool = True,
                delimiter: str = ",", nested_text: bool = True) -> int:
    """Write a result (schema and device batch) as the reference's
    pyarrow writer does.  `nested_text`: lists, structs and maps write
    as duckdb text (COPY); else they raise as pyarrow's writer does
    (EXPORT)."""
    idx = torch.nonzero(batch.sel).squeeze(1)
    cols = []
    for f, c in zip(schema.fields, batch.columns):
        if not nested_text and f.dtype.id in (TypeId.LIST, TypeId.STRUCT,
                                              TypeId.MAP):
            raise ValueError(f"Unsupported Type:{f.dtype!r}")
        if getattr(c, "hi", None) is not None:
            # the reference's writer takes int64 and raises the same class
            raise OverflowError(
                f"column {f.name}: a value past int64 has no CSV writer")
        cols.append(_Col(f.name, f.dtype, c.data[idx],
                         None if c.nulls is None else c.nulls[idx],
                         f.strdict))
    return write_columns(cols, path, header=header, delimiter=delimiter)


def write_host(columns, path: str, *, device, header: bool = True,
               delimiter: str = ",") -> int:
    """Write host columns [(name, dtype, data, nulls, strdict)] through
    `device`, which the caller names."""
    dev = torch.device(device)
    cols = [_Col(name, dt, torch.from_numpy(np.ascontiguousarray(d)).to(dev),
                 None if nl is None else torch.from_numpy(
                     np.ascontiguousarray(nl)).to(dev), sd)
            for name, dt, d, nl, sd in columns]
    return write_columns(cols, path, header=header, delimiter=delimiter)
