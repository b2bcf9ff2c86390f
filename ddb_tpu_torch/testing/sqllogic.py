"""Mini sqllogictest runner.

Executes the reference's `.test` files (reference: test/sqlite/
sqllogic_test_runner.cpp, format per test/sql/**) against this engine.
Supported directives: statement ok/error, query <types> [sort modes],
loop/endloop, foreach/endloop, require (skips), mode skip/unskip,
# comments.  Unsupported pragmas are ignored (verify_external etc.).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class RunResult:
    path: str
    ran: int = 0
    passed: int = 0
    failures: List[str] = field(default_factory=list)
    skipped_reason: Optional[str] = None

    @property
    def ok(self):
        return not self.failures and self.skipped_reason is None


# enable_verification / verify_external now EXECUTE (the engine's
# statement verifiers run each query through independent variants,
# api._verify_statement); only modes without an analog stay inert
_IGNORED_PRAGMAS = (
    "verify_serializer", "verify_fetch_row",
    "debug_", "force_", "threads",
)

# `require X` features this engine provides (the rest skip):
# parquet/json read+write, ICU collations + timezones, tpch/tpcds data
# generators vendored, autocomplete, 64-bit build, linux host, and the
# storage/verification modes that are no-ops for a single-binary engine
_SATISFIED_REQUIRES = {
    "parquet", "json", "icu", "autocomplete", "64bit", "notwindows",
    "skip_reload", "noforcestorage", "no_alternative_verify",
    "no_extension_autoloading", "no_latest_storage",
    "no_vector_verification", "noalternativeverify",
}


# session TimeZone used when rendering TIMESTAMPTZ values (the runner
# refreshes this from the connection before formatting each result)
_RENDER_TZ = ["UTC"]

# the checkout of the reference's source tree whose data/ and test/ files
# the .test scripts name; the reference runner executes from its root
REFERENCE_ROOT = os.environ.get("DDB_TPU_REFERENCE_ROOT", os.getcwd())





def _format_value(v) -> str:
    import datetime
    import decimal
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        import math
        if math.isnan(v):
            return "nan"
        if math.isinf(v):
            return "inf" if v > 0 else "-inf"
        if v == int(v) and abs(v) < 1e15:
            return f"{v:.1f}"
        return repr(v)
    if isinstance(v, decimal.Decimal):
        return str(v)
    if isinstance(v, datetime.timedelta):
        # duckdb Interval::ToString: "[N day[s]] [-]HH:MM:SS[.ffffff]"
        us = round(v.total_seconds() * 1e6)
        days = int(us / 86_400_000_000)   # truncate toward zero
        rem = us - days * 86_400_000_000
        parts = []
        if days:
            parts.append(f"{days} day" + ("" if abs(days) == 1 else "s"))
        if rem or not parts:
            sign = "-" if rem < 0 else ""
            rem = abs(rem)
            s_, usec = divmod(rem, 1_000_000)
            h, s_ = divmod(s_, 3600)
            m, s_ = divmod(s_, 60)
            t = f"{sign}{h:02d}:{m:02d}:{s_:02d}"
            if usec:
                t += (".%06d" % usec).rstrip("0")
            parts.append(t)
        return " ".join(parts)
    if isinstance(v, datetime.datetime):
        if v.replace(tzinfo=None) == datetime.datetime.max:
            return "infinity"
        if v.replace(tzinfo=None) == datetime.datetime.min:
            return "-infinity"
        if v.tzinfo is not None:
            # TIMESTAMPTZ: duckdb renders wall clock in the session
            # zone with a +HH[:MM] suffix (runner sets the zone via
            # _render_tz before formatting)
            zone = _RENDER_TZ[0]
            if zone not in ("UTC", None):
                try:
                    import zoneinfo
                    v = v.astimezone(zoneinfo.ZoneInfo(zone))
                except Exception:
                    pass
            off = v.utcoffset()
            base = v.replace(tzinfo=None).isoformat(sep=" ")
            total = int(off.total_seconds())
            sign = "+" if total >= 0 else "-"
            hh, rem = divmod(abs(total), 3600)
            mm, _ss = divmod(rem, 60)
            return f"{base}{sign}{hh:02d}" + (f":{mm:02d}" if mm else "")
        return v.isoformat(sep=" ")
    if isinstance(v, datetime.time):
        base = v.replace(tzinfo=None).isoformat()
        if len(base) == 5:
            base += ":00"          # duckdb always prints seconds
        if "." in base:
            base = base.rstrip("0").rstrip(".")
        if v.tzinfo is None:
            return base
        total = int(v.tzinfo.utcoffset(None).total_seconds())
        sign = "+" if total >= 0 else "-"
        hh, rem = divmod(abs(total), 3600)
        mm, ss = divmod(rem, 60)
        out = f"{base}{sign}{hh:02d}"
        if mm or ss:
            out += f":{mm:02d}"
        if ss:
            out += f":{ss:02d}"
        return out
    if isinstance(v, datetime.date):
        if v == datetime.date.max:
            return "infinity"
        if v == datetime.date.min:
            return "-infinity"
        return v.isoformat()
    if isinstance(v, (bytes, bytearray)):
        # duckdb Blob::ToString: printable ASCII raw, else \xHH
        return "".join(chr(byt) if 32 <= byt <= 126 and byt != 92
                       else "\\x%02X" % byt for byt in v)
    from ddb_tpu_torch.expr.nestedtext import render_element
    from ddb_tpu_torch.storage.nested import StructValue
    if isinstance(v, list):
        # duckdb renders nested NULLs as NULL, not Python None; string
        # elements quote per Vector::ToString rules
        return "[" + ", ".join(render_element(x, _format_value)
                               for x in v) + "]"
    if isinstance(v, StructValue):
        return "{" + ", ".join(
            f"'{k}': {render_element(x, _format_value)}"
            for k, x in v.items()) + "}"
    if isinstance(v, dict):
        return "{" + ", ".join(
            f"{render_element(k, _format_value)}="
            f"{render_element(x, _format_value)}"
            for k, x in v.items()) + "}"
    return str(v)


_SIGNED = ["tinyint", "smallint", "integer", "bigint", "hugeint"]
_UNSIGNED = ["utinyint", "usmallint", "uinteger", "ubigint", "uhugeint"]
_COMPRESSION = ["none", "uncompressed", "rle", "bitpacking",
                "dictionary", "fsst", "dict_fsst", "alp", "alprd"]


def _expand_foreach_token(tok: str, current) -> list:
    """Reference foreach collection tokens (<numeric>, <integral>, ...)
    per test/sqlite/sqllogic_test_runner.cpp ForEachTokenReplace."""
    t = tok.lower()
    if t.startswith("!"):
        try:
            current.remove(tok[1:])
            return []
        except ValueError:
            return [tok]
    if t == "<signed>":
        return list(_SIGNED)
    if t == "<unsigned>":
        return list(_UNSIGNED)
    if t == "<integral>":
        return _SIGNED + _UNSIGNED
    if t == "<numeric>":
        return _SIGNED + _UNSIGNED + ["float", "double"]
    if t == "<alltypes>":
        return _SIGNED + _UNSIGNED + ["float", "double", "bool",
                                      "interval", "varchar"]
    if t == "<compression>":
        return list(_COMPRESSION)
    return [tok]


def _values_match(got: str, want: str) -> bool:
    """Value-aware comparison matching the reference runner
    (reference: test/sqlite/result_helper.cpp CompareValues):
    booleans equal their 1/0 forms, numerics compare after parsing,
    regex expectations match."""
    if got == want:
        return True
    if want.startswith("<REGEX>:") or want.startswith("<!REGEX>:"):
        import re
        neg = want.startswith("<!")
        pat = want.split(":", 1)[1]
        try:
            hit = re.search(pat, got) is not None
        except re.error:
            return False
        return hit != neg
    # boolean equivalence (either side rendered as 1/0)
    bools = {"true": 1, "false": 0, "1": 1, "0": 0}
    if got.lower() in ("true", "false") or want.lower() in ("true",
                                                            "false"):
        g2 = bools.get(got.lower())
        w2 = bools.get(want.lower())
        if g2 is not None and w2 is not None:
            return g2 == w2
    # numeric-equality fallback (1 vs 1.0 vs 1.00; float tolerance)
    try:
        import decimal
        if decimal.Decimal(got) == decimal.Decimal(want):
            return True
        gf, wf = float(got), float(want)
        return abs(gf - wf) <= 1e-9 * max(abs(gf), abs(wf))
    except Exception:
        pass
    if want == "(empty)" and got == "":
        return True
    return False


def run_file(con, path: str, max_statements: Optional[int] = None
             ) -> RunResult:
    res = RunResult(path)
    with open(path) as f:
        lines = f.read().split("\n")

    i = 0
    loops: List[tuple] = []    # (var, values, start_line)
    env = {}
    skipping = False
    test_dir = [None]
    cons = {"": con}

    _SORTMODES = ("nosort", "sort", "rowsort", "valuesort")

    def con_for(toks) -> object:
        """Named-connection suffix (statement ok con1 / query I tran2):
        each name is a duplicate() of the base connection sharing the
        database — the reference runner's multi-connection transaction
        tests (sqllogic_command.cpp connection_name)."""
        import re as _re
        for t2 in toks:
            if t2 in _SORTMODES or t2.startswith("label="):
                continue
            # connection names are short word+digit tokens (con1,
            # tran2); longer tokens are hash-compare labels
            if not _re.fullmatch(r"[a-z]{1,8}\d{1,3}", t2):
                continue
            if t2 not in cons:
                cons[t2] = con.duplicate()
            return cons[t2]
        return con

    def subst(text: str) -> str:
        for k, v in env.items():
            text = text.replace(f"${{{k}}}", str(v))
        if "__TEST_DIR__" in text:
            # scratch dir the reference runner provides per test
            # (reference: sqllogic_test_runner.cpp ReplaceKeywords)
            if test_dir[0] is None:
                import tempfile
                test_dir[0] = tempfile.mkdtemp(prefix="sqllogic_")
            text = text.replace("__TEST_DIR__", test_dir[0])
        if "__WORKING_DIRECTORY__" in text:
            text = text.replace("__WORKING_DIRECTORY__",
                                REFERENCE_ROOT)
        # data files resolve against the reference checkout root (the
        # reference runner executes from its repo root)
        for q in ("'data/", "'test/"):
            if q in text:
                text = text.replace(q, "'" + REFERENCE_ROOT + "/" + q[1:])
        return text

    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if not line or line.startswith("#"):
            continue
        tok = line.split()
        d = tok[0].lower()

        if d == "require":
            # capabilities this engine satisfies run on; anything else
            # still skips (reference: require extension/flag gating)
            feat = tok[1].lower()
            if feat not in _SATISFIED_REQUIRES:
                res.skipped_reason = f"require {tok[1]}"
                return res
            continue
        if d == "mode":
            skipping = tok[1] == "skip"
            continue
        if skipping:
            continue
        if d in ("loop", "foreach"):
            var = tok[1]
            if d == "loop":
                vals = list(range(int(tok[2]), int(tok[3])))
            else:
                vals = []
                for p in tok[2:]:
                    vals.extend(_expand_foreach_token(p, vals))
            loops.append([var, vals, 0, i])
            env[var] = vals[0]
            continue
        if d == "endloop":
            var, vals, idx, start = loops[-1]
            if idx + 1 < len(vals):
                loops[-1][2] = idx + 1
                env[var] = vals[idx + 1]
                i = start
            else:
                loops.pop()
                env.pop(var, None)
            continue
        if d in ("statement", "query"):
            # gather SQL until blank line or ----
            sql_lines = []
            expect = None
            while i < len(lines):
                ln = lines[i]
                i += 1
                if ln.strip() == "----":
                    expect = []
                    while i < len(lines) and lines[i].strip() != "":
                        expect.append(lines[i])
                        i += 1
                    break
                if ln.strip() == "":
                    break
                sql_lines.append(ln)
            sql = subst("\n".join(sql_lines))
            res.ran += 1
            if max_statements and res.ran > max_statements:
                return res

            if d == "statement":
                want_error = tok[1] == "error"
                maybe = tok[1] == "maybe"   # either outcome accepted
                cx = con_for(tok[2:])
                low = sql.lower().strip()
                if low.startswith("pragma") and any(
                        p in low for p in _IGNORED_PRAGMAS):
                    res.passed += 1
                    continue
                try:
                    cx.execute(sql)
                    err = None
                except Exception as e:
                    err = e
                if maybe:
                    res.passed += 1
                    continue
                if want_error and err is None:
                    res.failures.append(
                        f"line {i}: expected error: {sql[:80]}")
                elif not want_error and err is not None:
                    res.failures.append(
                        f"line {i}: {type(err).__name__}: "
                        f"{str(err)[:100]} in: {sql[:80]}")
                else:
                    res.passed += 1
                continue

            # query
            sortmode = "nosort"
            decl = tok[1] if len(tok) >= 2 else ""
            if len(tok) >= 3:
                sortmode = tok[2]
            cx = con_for(tok[2:])
            try:
                rows = cx.execute(sql).fetchall()
                try:
                    _RENDER_TZ[0] = str(
                        cx.config.get("timezone") or "UTC")
                except Exception:
                    _RENDER_TZ[0] = "UTC"
                got = []
                for r in rows:
                    got.append([_format_value(v) for v in r])
            except Exception as e:
                res.failures.append(
                    f"line {i}: {type(e).__name__}: {str(e)[:100]} "
                    f"in: {sql[:80]}")
                continue
            if expect is None:
                res.passed += 1
                continue
            # expected: either tab-separated rows or one value per line
            exp_rows = [e.split("\t") for e in expect]
            ncols = len(got[0]) if got else (len(exp_rows[0])
                                            if exp_rows else 0)
            if exp_rows and len(exp_rows[0]) == 1 and ncols > 1:
                flat = [e[0] for e in exp_rows]
                exp_rows = [flat[j:j + ncols]
                            for j in range(0, len(flat), ncols)]
            if sortmode == "sort":
                got = sorted(got)
                exp_rows = sorted(exp_rows)
            if len(got) != len(exp_rows):
                res.failures.append(
                    f"line {i}: {len(got)} rows != {len(exp_rows)}: "
                    f"{sql[:80]}")
                continue
            bad = False
            for g, e in zip(got, exp_rows):
                if len(g) != len(e) or not all(
                        _values_match(a, b) for a, b in zip(g, e)):
                    res.failures.append(
                        f"line {i}: {g} != {e}: {sql[:60]}")
                    bad = True
                    break
            if not bad:
                res.passed += 1
            continue
        # unknown directive: ignore the line
    return res
