"""JSON scalar functions (capability parity with the reference's JSON
extension: extension/json/json_functions/*.cpp over yyjson).

Evaluation is host-side over string-dictionary values: every distinct JSON
document is parsed ONCE per (function, path) and the result becomes a
per-code lookup table gathered on device (see Binder._bind_string_func).
That matches the TPU design rule that var-len payloads never live on
device — only dictionary codes do.

Path syntax (reference: extension/json/json_common.cpp ValidPathOrThrow):
  - JSONPath subset: '$.key', '$.key[3]', '$."quoted key"', '$[#-1]'
    (# = length, so [#-1] is the last element), chained arbitrarily.
  - JSON Pointer: '/key/3'.
  - Bare key shorthand: 'key' (equivalent to '$.key').
Missing paths yield SQL NULL (functions below return None).
"""

from __future__ import annotations

import json
import re
from typing import Any, List, Optional, Union

_MISSING = object()

_STEP_RE = re.compile(
    r"""\.(?P<key>[A-Za-z_][A-Za-z0-9_]*)     # .key
      | \.\"(?P<qkey>(?:[^"\\]|\\.)*)\"       # ."quoted key"
      | \[(?P<idx>\#?-?\d+|\#)\]              # [3] / [#-1] / [#]
    """, re.X)


def parse_path(path: str) -> List[Union[str, int, tuple]]:
    """Parse a path string into steps: str keys, int indexes, or
    ('end', k) for from-the-end indexes."""
    if path == "":
        return []
    if path.startswith("/"):
        steps: List[Union[str, int, tuple]] = []
        for part in path[1:].split("/"):
            if part == "":
                continue
            steps.append(int(part) if part.lstrip("-").isdigit() else part)
        return steps
    if not path.startswith("$"):
        # bare key shorthand
        if path.lstrip("-").isdigit():
            return [int(path)]
        return [path]
    steps = []
    pos = 1
    while pos < len(path):
        m = _STEP_RE.match(path, pos)
        if not m:
            raise ValueError(f"invalid JSON path {path!r}")
        if m.group("key") is not None:
            steps.append(m.group("key"))
        elif m.group("qkey") is not None:
            steps.append(re.sub(r"\\(.)", r"\1", m.group("qkey")))
        else:
            idx = m.group("idx")
            if idx.startswith("#"):
                k = int(idx[1:]) if len(idx) > 1 else 0
                steps.append(("end", k))
            else:
                steps.append(int(idx))
        pos = m.end()
    return steps


def extract(doc: Any, steps) -> Any:
    """Walk parsed JSON by steps; returns _MISSING if absent."""
    cur = doc
    for s in steps:
        if isinstance(s, str):
            if not isinstance(cur, dict) or s not in cur:
                return _MISSING
            cur = cur[s]
        else:
            if not isinstance(cur, list):
                return _MISSING
            i = s if isinstance(s, int) else len(cur) + s[1]
            if i < 0:
                i += len(cur)
            if not 0 <= i < len(cur):
                return _MISSING
            cur = cur[i]
    return cur


def _parse(s: str):
    try:
        return json.loads(s), True
    except (ValueError, TypeError):
        return None, False


def _dump(v) -> str:
    return json.dumps(v, separators=(",", ":"), ensure_ascii=False)


def _at(s: str, path):
    doc, ok = _parse(s)
    if not ok:
        return _MISSING
    steps = parse_path(path) if isinstance(path, str) else [int(path)]
    return extract(doc, steps)


# ---- scalar functions (None => SQL NULL) ----------------------------------

def json_extract(s: str, path: str = "$") -> Optional[str]:
    v = _at(s, path)
    return None if v is _MISSING else _dump(v)


def json_extract_string(s: str, path: str = "$") -> Optional[str]:
    v = _at(s, path)
    if v is _MISSING or v is None:
        return None
    if isinstance(v, str):
        return v
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return _dump(v)
    return _dump(v)


def json_value(s: str, path: str = "$") -> Optional[str]:
    """Like json_extract but NULL for non-scalar results
    (reference: json_value semantics)."""
    v = _at(s, path)
    if v is _MISSING or isinstance(v, (dict, list)):
        return None
    return _dump(v)


def json_array_length(s: str, path: str = "$") -> Optional[int]:
    v = _at(s, path)
    if v is _MISSING:
        return None
    return len(v) if isinstance(v, list) else 0


def json_type(s: str, path: str = "$") -> Optional[str]:
    v = _at(s, path)
    if v is _MISSING:
        return None
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "BOOLEAN"
    if isinstance(v, int):
        return "BIGINT" if v < 2 ** 63 else "UBIGINT"
    if isinstance(v, float):
        return "DOUBLE"
    if isinstance(v, str):
        return "VARCHAR"
    return "ARRAY" if isinstance(v, list) else "OBJECT"


def json_valid(s: str) -> bool:
    return _parse(s)[1]


def json_structure(s: str) -> Optional[str]:
    doc, ok = _parse(s)
    if not ok:
        return None

    def struct(v):
        if v is None:
            return "NULL"
        if isinstance(v, bool):
            return "BOOLEAN"
        if isinstance(v, int):
            return "BIGINT" if v < 2 ** 63 else "UBIGINT"
        if isinstance(v, float):
            return "DOUBLE"
        if isinstance(v, str):
            return "VARCHAR"
        if isinstance(v, list):
            subs = [struct(x) for x in v]
            first = next((x for x in subs if x != "NULL"), "NULL")
            if any(x not in (first, "NULL") for x in subs):
                return "JSON"
            return [first]
        return {k: struct(x) for k, x in v.items()}

    return _dump(struct(doc))


def json_contains(hay: str, needle: str) -> Optional[bool]:
    hd, ok = _parse(hay)
    if not ok:
        return None
    nd, ok = _parse(needle)
    if not ok:
        nd = needle          # bare string needle

    def hit(v) -> bool:
        if v == nd:
            return True
        if isinstance(v, dict):
            return any(hit(x) for x in v.values())
        if isinstance(v, list):
            return any(hit(x) for x in v)
        return False

    return hit(hd)


def json_merge_patch(a: str, b: str) -> Optional[str]:
    """RFC 7386 merge patch (reference: json_merge_patch.cpp)."""
    da, oka = _parse(a)
    db, okb = _parse(b)
    if not (oka and okb):
        return None

    def merge(t, p):
        if not isinstance(p, dict):
            return p
        if not isinstance(t, dict):
            t = {}
        out = dict(t)
        for k, v in p.items():
            if v is None:
                out.pop(k, None)
            else:
                out[k] = merge(out.get(k), v)
        return out

    return _dump(merge(da, db))


def json_keys(s: str, path: str = "$") -> Optional[list]:
    v = _at(s, path)
    if v is _MISSING or not isinstance(v, dict):
        return None
    return list(v.keys())


def to_json(s: str) -> str:
    return _dump(s)
