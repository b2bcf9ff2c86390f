"""Text -> nested-value parsing for VARCHAR casts to LIST/STRUCT/MAP.

The reference casts strings like '[1, 2, 3]', '{a: 1, b: x}', and
'{k=v}' to nested vectors (src/common/types/vector/ string-cast paths:
VectorStringToList/ToStruct/ToMap).  Here the parsed python payloads go
into host-side stores (storage/lists.py, storage/nested.py) and rows
carry store ids — one device gather per dictionary code.

Atom rules derived from test/sql/cast/string_to_*_escapes.test:
  - quoted segments ('..' or "..") can appear anywhere in an atom;
    inside them backslash escapes ANY next character and the content
    merges with surrounding raw text;
  - outside quotes, backslash only escapes a following quote character
    (preventing a quoted segment); any other backslash is literal;
  - unquoted [ { ( nest, so commas inside don't split;
  - leading/trailing unquoted whitespace trims; quoted spaces stay;
  - a wholly-unquoted atom equal to NULL (any case) is SQL NULL, and
    unbalanced brackets / unterminated quotes are conversion errors.
"""

from __future__ import annotations


class NestedTextError(ValueError):
    pass


def _skip_ws(s: str, i: int) -> int:
    while i < len(s) and s[i].isspace():
        i += 1
    return i


def _parse_atom(s: str, i: int, stops: str):
    """Parse one element up to an unnested stop character; returns
    (text, any_quoted, next_index) — next_index points at the stop."""
    i = _skip_ws(s, i)
    out = []            # (char, protected_by_quotes)
    any_quoted = False
    depth = 0
    n = len(s)
    while i < n:
        ch = s[i]
        if ch == "\\":
            if i + 1 < n and s[i + 1] in "'\"":
                if depth == 0:
                    out.append((s[i + 1], True))
                else:
                    # nested content re-parses later: keep verbatim
                    out.append((ch, True))
                    out.append((s[i + 1], True))
                i += 2
                continue
            out.append((ch, False))
            i += 1
            continue
        if ch in "'\"":
            q = ch
            if depth > 0:
                # keep the quoted segment verbatim (incl. quotes and
                # escapes) — the nested element parses it again
                out.append((ch, True))
                i += 1
                closed = False
                while i < n:
                    c2 = s[i]
                    out.append((c2, True))
                    if c2 == "\\" and i + 1 < n:
                        out.append((s[i + 1], True))
                        i += 2
                        continue
                    i += 1
                    if c2 == q:
                        closed = True
                        break
                if not closed:
                    raise NestedTextError("unterminated quote")
                continue
            any_quoted = True
            i += 1
            closed = False
            while i < n:
                c2 = s[i]
                if c2 == "\\" and i + 1 < n:
                    out.append((s[i + 1], True))
                    i += 2
                    continue
                if c2 == q:
                    i += 1
                    closed = True
                    break
                out.append((c2, True))
                i += 1
            if not closed:
                raise NestedTextError("unterminated quote")
            continue
        if depth == 0 and ch in stops:
            break
        if ch in "[{(":
            depth += 1
        elif ch in ")}]":
            if depth == 0:
                raise NestedTextError("unbalanced brackets")
            depth -= 1
        out.append((ch, False))
        i += 1
    if depth != 0:
        raise NestedTextError("unbalanced brackets")
    while out and not out[-1][1] and out[-1][0].isspace():
        out.pop()
    return "".join(c for c, _p in out), any_quoted, i


def split_list(text: str):
    """'[a, b, c]' -> list of (element_text, any_quoted); None entries
    for unquoted NULL."""
    s = text.strip()
    if not (s.startswith("[") and s.endswith("]")):
        raise NestedTextError(f"'{text}' is not a list")
    inner = s[1:-1]
    i = _skip_ws(inner, 0)
    items = []
    if i >= len(inner):
        return items
    while True:
        atom, quoted, i = _parse_atom(inner, i, ",")
        if not quoted and atom.upper() == "NULL":
            items.append(None)
        else:
            items.append((atom, quoted))
        if i >= len(inner):
            return items
        i += 1               # consume ','


def split_pairs(text: str, sep: str):
    """'{k: v, ...}' (sep=':', struct) or '{k=v, ...}' (sep='=', map)
    -> list of ((key_text, key_quoted), value) with value either
    (text, quoted) or None for unquoted NULL."""
    s = text.strip()
    if not (s.startswith("{") and s.endswith("}")):
        raise NestedTextError(f"'{text}' is not a struct/map")
    inner = s[1:-1]
    i = _skip_ws(inner, 0)
    pairs = []
    if i >= len(inner):
        return pairs
    while True:
        key, kq, i = _parse_atom(inner, i, sep)
        if i >= len(inner) or inner[i] != sep:
            raise NestedTextError(f"expected '{sep}' in '{text}'")
        i += 1
        val, vq, i = _parse_atom(inner, i, ",")
        if not vq and val.upper() == "NULL":
            v = None
        else:
            v = (val, vq)
        pairs.append(((key, kq), v))
        if i >= len(inner):
            return pairs
        i += 1


# ---- duckdb-style rendering of nested values -------------------------

_NEEDS_QUOTES = set(",'\"[]{}=:")


def render_element(v, format_value) -> str:
    """Render one nested element like the reference's Vector::ToString:
    strings print raw unless they contain separators/quotes/brackets,
    are empty, have leading/trailing spaces, or read as NULL — then
    they wrap in single quotes with \\ and ' escaped."""
    if v is None:
        return "NULL"
    if isinstance(v, str):
        need = (v == "" or v.upper() == "NULL"
                or v[0].isspace() or v[-1].isspace()
                or any(ch in _NEEDS_QUOTES for ch in v))
        if need:
            return "'" + v.replace("\\", "\\\\") \
                          .replace("'", "\\'") + "'"
        return v
    return format_value(v)


def render_value(v) -> str:
    """Full nested-value -> duckdb text (reference: Vector::ToString
    composition for LIST/STRUCT/MAP casts to VARCHAR)."""
    from ..storage.nested import StructValue
    if v is None:
        return "NULL"
    if isinstance(v, list):
        return "[" + ", ".join(render_element(x, render_value)
                               for x in v) + "]"
    if isinstance(v, StructValue):
        return "{" + ", ".join(
            f"'{k}': {render_element(x, render_value)}"
            for k, x in v.items()) + "}"
    if isinstance(v, dict):
        return "{" + ", ".join(
            f"{render_element(k, render_value)}="
            f"{render_element(x, render_value)}"
            for k, x in v.items()) + "}"
    if isinstance(v, bool):
        return "true" if v else "false"
    import datetime
    if isinstance(v, (datetime.datetime, datetime.date, datetime.time)):
        out = v.isoformat(sep=" ") if isinstance(v, datetime.datetime) \
            else v.isoformat()
        if "." in out:
            out = out.rstrip("0").rstrip(".")
        return out
    return str(v)
