"""Time-zone conversion tables from the system tzdata (TZif files).

Analog of the reference's ICU extension timestamp ops
(reference: extension/icu/icu-timezone.cpp) redesigned for device
execution: at BIND time a zone's transition history is parsed into two
small sorted arrays (transition instants + utc offsets); the per-row
conversion then compiles to a branch-free table lookup
(jnp.searchsorted over a few hundred entries) — no host callback on the
hot path.

TZif parsing per RFC 8536 (v1/v2/v3).  We read /usr/share/zoneinfo.
"""

from __future__ import annotations

import os
import struct
from functools import lru_cache
from typing import Tuple

import numpy as np

ZONEINFO_DIR = "/usr/share/zoneinfo"

_US = 1_000_000


def _td_micros(delta) -> int:
    return (delta.days * 86_400_000_000 + delta.seconds * 1_000_000
            + delta.microseconds)


class UnknownTimeZone(Exception):
    pass


def _parse_tzif(data: bytes):
    """Returns (transitions_sec[int64], offsets_sec[int64]) where
    offsets[i] applies to instants in [transitions[i], transitions[i+1]).
    transitions[0] is -inf (base offset)."""
    if data[:4] != b"TZif":
        raise UnknownTimeZone("not a TZif file")
    version = data[4:5]

    def block(off, longs):
        (isutcnt, isstdcnt, leapcnt, timecnt, typecnt,
         charcnt) = struct.unpack(">6I", data[off + 20:off + 44])
        p = off + 44
        tsize = 8 if longs else 4
        fmt = ">%d%s" % (timecnt, "q" if longs else "i")
        trans = struct.unpack(fmt, data[p:p + timecnt * tsize]) \
            if timecnt else ()
        p += timecnt * tsize
        idxs = data[p:p + timecnt]
        p += timecnt
        ttinfo = []
        for i in range(typecnt):
            utoff, _isdst, _ab = struct.unpack(
                ">iBB", data[p + i * 6:p + i * 6 + 6])
            ttinfo.append(utoff)
        p += typecnt * 6 + charcnt
        p += leapcnt * ((tsize + 4) if longs else 8)
        p += isstdcnt + isutcnt
        return trans, idxs, ttinfo, p

    trans, idxs, ttinfo, end = block(0, False)
    if version in (b"2", b"3"):
        # v2+ data block follows the v1 block with 64-bit times
        trans, idxs, ttinfo, _ = block(end, True)
    if not ttinfo:
        raise UnknownTimeZone("TZif with no types")
    base = ttinfo[idxs[0]] if trans else ttinfo[0]
    transitions = np.concatenate(
        [np.array([np.iinfo(np.int64).min // 2], dtype=np.int64),
         np.asarray(trans, dtype=np.int64)])
    offsets = np.concatenate(
        [np.array([base], dtype=np.int64),
         np.asarray([ttinfo[i] for i in idxs], dtype=np.int64)])
    return transitions, offsets


@lru_cache(maxsize=64)
def zone_table(name: str) -> Tuple[np.ndarray, np.ndarray]:
    """(transitions_us, offsets_us) for a zone name; raises
    UnknownTimeZone for bad names (reference errors the same way)."""
    if not name or name.startswith(".") or ".." in name or \
            name.startswith("/"):
        raise UnknownTimeZone(f"unknown time zone {name!r}")
    path = os.path.join(ZONEINFO_DIR, name)
    if not os.path.isfile(path):
        if name.upper() in ("UTC", "GMT", "Z"):
            return (np.array([np.iinfo(np.int64).min // 2], np.int64),
                    np.array([0], np.int64))
        raise UnknownTimeZone(f"unknown time zone {name!r}")
    with open(path, "rb") as f:
        trans, offs = _parse_tzif(f.read())
    return trans * _US, offs * _US


def utc_to_wall_np(ts_us: np.ndarray, name: str) -> np.ndarray:
    """Reference helper (numpy): UTC instant -> local wall clock."""
    trans, offs = zone_table(name)
    idx = np.searchsorted(trans, ts_us, side="right") - 1
    return ts_us + offs[np.clip(idx, 0, len(offs) - 1)]


def offset_at(instant_us: int, name: str) -> int:
    """UTC offset (micros) in effect at an instant for a zone."""
    trans, offs = zone_table(name)
    idx = int(np.searchsorted(trans, instant_us, side="right")) - 1
    return int(offs[max(0, min(idx, len(offs) - 1))])


def render_timestamptz(raw_us: int, name: str) -> str:
    """DuckDB-style TIMESTAMPTZ text: wall clock in the session zone
    with a +HH / +HH:MM offset suffix (reference: ICU CastFromTimestampTZ,
    extension/icu/icu_timezone.cpp rendering via Timestamp::ToString +
    offset)."""
    import datetime
    off = offset_at(int(raw_us), name)
    wall = int(raw_us) + off
    dt = datetime.datetime(1970, 1, 1) + datetime.timedelta(
        microseconds=wall)
    base = dt.strftime("%Y-%m-%d %H:%M:%S")
    if dt.microsecond:
        base += (".%06d" % dt.microsecond).rstrip("0")
    sign = "+" if off >= 0 else "-"
    osec = abs(off) // _US
    hh, rem = divmod(osec, 3600)
    mm, ss = divmod(rem, 60)
    suffix = f"{sign}{hh:02d}"
    if mm or ss:
        suffix += f":{mm:02d}"
    if ss:
        suffix += f":{ss:02d}"
    return base + suffix


def parse_timestamptz(text: str, name: str) -> int:
    """Text -> UTC instant micros: explicit offset wins; otherwise the
    wall clock is interpreted in the given zone (reference semantics
    for VARCHAR -> TIMESTAMPTZ casts under a session TimeZone)."""
    import datetime
    dt = datetime.datetime.fromisoformat(text.strip())
    epoch = datetime.datetime(1970, 1, 1)
    if dt.tzinfo is not None:
        return _td_micros(dt - epoch.replace(
            tzinfo=datetime.timezone.utc))
    wall_us = _td_micros(dt - epoch)
    return int(wall_to_utc_np(np.asarray([wall_us], np.int64), name)[0])


def wall_to_utc_np(ts_us: np.ndarray, name: str) -> np.ndarray:
    """Reference helper (numpy): local wall clock -> UTC instant.
    Ambiguous (fall-back) wall times resolve to the LATER instant and
    invalid (gap) times shift by the pre-transition offset: ICU's
    default UCAL_WALLTIME_LAST for both repeated and skipped wall
    times, which the reference uses (extension/icu never calls
    setRepeatedWallTimeOption/setSkippedWallTimeOption)."""
    trans, offs = zone_table(name)
    wall_starts = trans + offs            # local time at each regime start
    idx = np.searchsorted(wall_starts, ts_us, side="right") - 1
    return ts_us - offs[np.clip(idx, 0, len(offs) - 1)]
