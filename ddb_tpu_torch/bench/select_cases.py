"""A corpus of small SELECT statements over seeded tables: scalar
functions, CTEs (shared and recursive), UNNEST, lists, structs, maps,
lambdas, BIT, time zones, Python functions and the aggregates that run
on the host.

The CPU tests run every statement through the reference package and
through this one on the CPU; the card's smoke run runs them through this
package on the card and on the CPU.  The statements are those of the
reference package's own tests (test_sql, test_lists, test_r4_breadth,
test_tz, test_timestamptz, test_udf, test_bit, test_nested_cast,
test_union_type), with `CREATE TABLE ... INSERT` replaced by `register`
of the same values.  Every statement orders its rows, or returns one
row, or reads rows in table order, so two executors must return the same
list.  SAMPLE and random() are not here: their draws differ by device
and are held by properties (tests/test_torch_sample.py).
"""

from __future__ import annotations

import datetime
import math

import numpy as np

ROWS = 200


def tables(seed: int = 7):
    """{table: {column: list or numpy array}}, registrable by both
    packages' `Connection.register`."""
    rng = np.random.default_rng(seed)
    n = ROWS

    def with_nulls(values, share):
        out = [v.item() if hasattr(v, "item") else v for v in values]
        for i in np.flatnonzero(rng.random(n) < share):
            out[i] = None
        return out

    day0 = datetime.date(1970, 1, 1)
    ts0 = datetime.datetime(1970, 1, 1)
    days = rng.integers(-20000, 25000, n)          # 1915 .. 2038
    micros = rng.integers(-1_500_000_000, 2_000_000_000, n) * 1_000_000 \
        + rng.integers(0, 1_000_000, n)
    x = np.round(rng.normal(0, 4, n), 3)
    x[:6] = [0.0, -0.0, 1.0, -1.0, 0.5, -2.5]
    i = rng.integers(-40, 40, n)
    i[:6] = [0, 1, -1, 20, 21, -7]
    f = {
        "id": np.arange(n, dtype=np.int32),
        "x": with_nulls(x, 0.08),
        "u": with_nulls(np.round(rng.random(n), 6), 0.05),     # in [0, 1)
        "p": with_nulls(np.round(rng.random(n) * 9 + 1.5, 4), 0.05),  # > 1
        "i": with_nulls(i, 0.08),
        "j": with_nulls(rng.integers(-12, 12, n), 0.05),
        "d": with_nulls([day0 + datetime.timedelta(days=int(v))
                         for v in days], 0.05),
        "ts": with_nulls([ts0 + datetime.timedelta(microseconds=int(v))
                          for v in micros], 0.05),
        "s": [f"w{int(v):02d}" for v in rng.integers(0, 12, n)],
    }
    g = {
        "g": [f"g{int(v)}" for v in rng.integers(0, 5, n)],
        "k": rng.integers(0, 3, n).astype(np.int32),
        "v": with_nulls(rng.integers(0, 30, n), 0.1),
        "x": with_nulls(np.round(rng.normal(10, 3, n), 2), 0.1),
        "s": with_nulls([f"s{int(v)}" for v in rng.integers(0, 8, n)], 0.1),
        "d": [day0 + datetime.timedelta(days=int(v))
              for v in rng.integers(19000, 19010, n)],
        "b": with_nulls(rng.random(n) < 0.5, 0.1),
    }
    return {
        "f": f,
        "g": g,
        "t": {"s": ["a,b", "c", "d,e,f"], "k": [1, 2, 3]},
        "u": {"a": [1, 2, 3, None], "s": ["x", "yy", "zzz", "w"]},
        "uv": {"x": [1, 2]},
        "gm": {"g": ["a", "a", "b", "b"], "v": [2.0, 8.0, 5.0, None]},
        "ev": {"t": [datetime.datetime(2024, 1, 15, 12), None,
                     datetime.datetime(2024, 7, 15, 12),
                     datetime.datetime(1970, 6, 1, 0, 0, 1),
                     datetime.datetime(2024, 3, 10, 6, 59, 59),
                     datetime.datetime(2024, 11, 3, 5, 30)]},
        "old": {"t": [datetime.datetime(1969, 6, 1, 0, 0, 1),
                      datetime.datetime(1969, 12, 1, 0, 0, 1),
                      datetime.datetime(1925, 7, 4, 9, 30)]},
        "ti": {"t": [datetime.datetime(2023, 1, 31, 1, 2, 3)]},
        "lt": {"l": [[3, 1, 2], [5], [], [2, None, 1]]},
        "nt": {"id": [1, 2, 3],
               "s": [{"x": 10, "y": "aa"}, {"x": 20, "y": "bb"}, None],
               "l": [[1, 2], [], [3]]},
        "rl": {"i": [1, 2, None], "s": ["a", "b", "c"]},
        "h": {"n": np.arange(50, dtype=np.int64)},
        "z": {"i": np.arange(5, dtype=np.int64)},
        "wg": {"x": [1, 2, 3, 4]},
        "iv": {"x": [1, 2, 12]},
        "tn": {"a": [None, 7], "b": [5, 3]},
        "edges": {"p": [1, 1, 2, 3, 4], "c": [2, 3, 4, 4, 2]},
        "bt": {"b": ["101001111", "00111"]},
    }


def setup(con) -> None:
    """The Python functions and aggregates the corpus calls."""
    con.create_function("plus_ten", lambda x: x + 10)
    con.create_function("slen", lambda s: len(s))
    con.create_function("halve", lambda x: x / 2, "DOUBLE")
    con.create_function("oddnull", lambda x: None if x % 2 else x)
    con.create_function("tag", lambda x: f"v={x}", "VARCHAR")
    con.create_aggregate(
        "geomean", lambda: [0.0, 0],
        lambda st, v: (st.__setitem__(0, st[0] + math.log(v)),
                       st.__setitem__(1, st[1] + 1)),
        lambda st: math.exp(st[0] / st[1]) if st[1] else None, "DOUBLE")
    con.create_aggregate(
        "firstlast", lambda: [], lambda st, v: st.append(str(v)),
        lambda st: (st[0] + ".." + st[-1]) if st else None, "VARCHAR")


def _f(select: str, tail: str = "") -> str:
    return f"SELECT id, {select} FROM f {tail} ORDER BY id"


# ---- scalar functions through SQL ------------------------------------------

FUNCTIONS = {
    "trig": _f("sin(x), cos(x), tan(x), atan(x), sinh(u), cosh(u), tanh(x)"),
    "inverse_trig": _f("asin(u), acos(u), atanh(u), asinh(x), acosh(p), "
                       "atan2(x, p), cot(p)"),
    "logs": _f("ln(p), log(p), log2(p), log10(p), exp(u), sqrt(p), "
               "pow(p, 2), power(u, 0.5)"),
    "rounding": _f("round(x), round(x, 1), floor(x), ceil(x), trunc(x), "
                   "sign(x), abs(x), even(x), abs(i), sign(i)"),
    "angles_roots": _f("radians(x), degrees(x), cbrt(x), gamma(p), "
                       "lgamma(p)"),
    "float_tests": _f("isnan(x), isinf(x), isfinite(x), signbit(x), "
                      "nextafter(x, p)"),
    "integer_math": _f("gcd(i, j), lcm(i, j), factorial(abs(j)), "
                       "bit_count(i), bit_count(id), i & 6, i | 1, "
                       "xor(i, 3), i << 1, i >> 1"),
    "null_handling": _f("coalesce(x, u, 0), ifnull(i, j), nullif(i, j), "
                        "least(i, j, 3), greatest(x, u)"),
    "date_parts": _f("year(d), month(d), day(d), quarter(d), dayofweek(d), "
                     "isodow(d), dayofyear(d), week(d), isoyear(d), "
                     "yearweek(d)"),
    "date_eras": _f("century(d), decade(d), millennium(d), last_day(d), "
                    "epoch(d), epoch_ms(d)"),
    "date_trunc": _f("date_trunc('year', d), date_trunc('month', d), "
                     "date_trunc('week', d)"),
    "date_arith": _f("d + INTERVAL 1 MONTH, d - INTERVAL 13 MONTH, "
                     "d + INTERVAL 1 YEAR, d + 7, d + INTERVAL 36 HOUR"),
    "ts_parts": _f("extract(hour FROM ts), extract(minute FROM ts), "
                   "extract(second FROM ts), extract(millisecond FROM ts), "
                   "extract(microsecond FROM ts), year(ts), month(ts), "
                   "dayofweek(ts)"),
    "ts_trunc": _f("date_trunc('minute', ts), date_trunc('hour', ts), "
                   "date_trunc('day', ts), date_trunc('second', ts), "
                   "ts::DATE, ts::TIME"),
    "ts_epoch": _f("epoch(ts), epoch_ms(ts), epoch_us(ts), epoch_ns(ts)"),
    "ts_arith": _f("ts + INTERVAL 1 MONTH, ts - INTERVAL 1 MONTH, "
                   "ts + INTERVAL 1 YEAR, ts + INTERVAL 90 MINUTE"),
    "ts_bucket": _f("time_bucket(INTERVAL 15 MINUTE, ts), "
                    "time_bucket(INTERVAL 1 DAY, ts)"),
    "ts_age": _f("date_diff('month', TIMESTAMP '2000-01-31 00:00:00', ts), "
                 "datediff('day', DATE '2000-01-01', d)"),
    "make": _f("make_date(2000 + j, 1 + abs(j), 1 + abs(j)), "
               "make_time(abs(j), abs(i), id % 59 + 0.25), "
               "make_timestamp(2000 + j, 1 + abs(j), 1 + abs(j), abs(j), "
               "abs(i), id % 59 + 0.25), to_timestamp(id * 37 - 2500), to_timestamp(j + 0.5)"),
    "timetz_casts": _f("ts::TIMETZ::VARCHAR, ts::TIME::TIMETZ::TIME",
                       "WHERE ts IS NOT NULL"),
    "rowid": "SELECT rowid, id FROM f WHERE id < 5 ORDER BY id",
    "filter_on_function": "SELECT count(*), sum(i) FROM f "
                          "WHERE extract(minute FROM ts) < 30 AND sin(x) > 0",
    "group_by_function": "SELECT extract(hour FROM ts) AS h, count(*), "
                         "min(d) FROM f GROUP BY h ORDER BY h",
    "string_functions": _f("length(s), upper(s), s || '!', "
                           "substring(s, 2, 2), s LIKE '%1%', "
                           "regexp_replace(s, '^w0', 'x')"),
    "case_strings": _f("CASE WHEN i > 0 THEN s ELSE '' END, "
                       "CASE WHEN x IS NULL THEN 'none' WHEN x < 0 THEN "
                       "'neg' ELSE 'pos' END"),
    "integer_bitwise": "SELECT x & 6, x | 1, x << 1, x >> 1 FROM iv",
    "constants": "SELECT 5 & 3, 5 | 3, xor(5, 3), ~5, 1 << 4, 256 >> 4, "
                 "3 ^ 4, pi(), factorial(5), gcd(12, 18), lcm(4, 6)",
}

# ---- CTEs ------------------------------------------------------------------

CTE = {
    "cte_once": "WITH r AS (SELECT g, sum(v) AS s FROM g GROUP BY g) "
                "SELECT g, s FROM r ORDER BY g",
    "cte_twice_max": "WITH r AS (SELECT g, sum(v) AS s FROM g GROUP BY g) "
                     "SELECT g, s FROM r WHERE s = (SELECT max(s) FROM r)",
    "cte_twice_join": "WITH r AS (SELECT k, count(*) AS c FROM g GROUP BY k) "
                      "SELECT a.k, a.c, b.c FROM r a JOIN r b ON a.k + 1 = "
                      "b.k ORDER BY a.k",
    "cte_twice_union": "WITH r AS (SELECT k, max(x) AS m FROM g GROUP BY k) "
                       "SELECT * FROM (SELECT k, m FROM r UNION ALL SELECT "
                       "k + 10, m FROM r) ORDER BY 1",
    "cte_chain": "WITH a AS (SELECT id, i FROM f WHERE i > 0), b AS (SELECT "
                 "id, i * 2 AS ii FROM a) SELECT count(*), sum(ii) FROM b",
    "recursive_count": "WITH RECURSIVE d(x) AS (SELECT 1 UNION ALL SELECT "
                       "x + 1 FROM d WHERE x < 25) SELECT count(*), sum(x), "
                       "max(x) FROM d",
    "recursive_rows": "WITH RECURSIVE d(x) AS (SELECT 1 UNION ALL SELECT "
                      "x + 1 FROM d WHERE x < 9) SELECT x FROM d ORDER BY x",
    "recursive_dates": "WITH RECURSIVE d(x) AS (SELECT DATE '2013-06-28' "
                       "UNION ALL SELECT x + 1 FROM d WHERE x < DATE "
                       "'2013-07-03') SELECT x FROM d ORDER BY x",
    "recursive_union_cycle": "WITH RECURSIVE d(x) AS (SELECT 0 UNION SELECT "
                             "(x + 3) % 7 FROM d) SELECT x FROM d ORDER BY x",
    "recursive_union_dedup_base": "WITH RECURSIVE d(x) AS (SELECT k FROM g "
                                  "UNION SELECT x + 1 FROM d WHERE x < 6) "
                                  "SELECT x FROM d ORDER BY x",
    "recursive_two_columns": "WITH RECURSIVE fib(a, b) AS (SELECT 0, 1 UNION "
                             "ALL SELECT b, a + b FROM fib WHERE b < 200) "
                             "SELECT a, b FROM fib ORDER BY a, b",
    "recursive_reach": "WITH RECURSIVE r(n) AS (SELECT 1 UNION SELECT c FROM "
                       "edges, r WHERE p = n) SELECT n FROM r ORDER BY n",
    "recursive_join_spine": "WITH RECURSIVE d(x) AS (SELECT DATE "
                            "'2022-01-08' UNION ALL SELECT x + 1 FROM d "
                            "WHERE x < DATE '2022-01-20') SELECT d.x, "
                            "count(g.d) FROM d LEFT JOIN g ON g.d = d.x "
                            "GROUP BY d.x ORDER BY d.x",
    "recursive_empty_base": "WITH RECURSIVE d(x) AS (SELECT k FROM g WHERE "
                            "k > 99 UNION ALL SELECT x + 1 FROM d WHERE "
                            "x < 3) SELECT count(*) FROM d",
    "scalar_subquery_in_select": "SELECT id, i - (SELECT min(i) FROM f) FROM "
                                 "f WHERE id < 8 ORDER BY id",
}

# ---- lists, structs, maps, lambdas, unnest, nested casts, BIT -----------------

LISTS = {
    "list_literal": "SELECT [1,2,3], ['x','y']",
    "from_unnest_literal": "SELECT * FROM unnest([1,2,3])",
    "unnest_select_item": "SELECT unnest([10,20])",
    "string_split_unnest": "SELECT unnest(string_split(s, ',')) AS e, k "
                           "FROM t",
    "array_length": "SELECT array_length(string_split(s, ',')) FROM t",
    "list_contains": "SELECT list_contains(string_split(s, ','), 'b') FROM t",
    "unnest_empty": "SELECT unnest(string_split(s, ',')) FROM t WHERE k > 9",
    "unnest_numbers_with_columns": "SELECT id, unnest(l) FROM nt",
    "range_table": "SELECT * FROM range(10)",
    "range_aggregate": "SELECT sum(range), count(*) FROM range(3, 30, 4)",
    "generate_series": "SELECT * FROM generate_series(1, 5)",
    "struct_literal": "SELECT {'a': 1, 'b': 'x'} AS s",
    "struct_pack_dot": "SELECT struct_pack(a := 1, b := 2).a",
    "struct_subscript": "SELECT {'a': 1, 'b': 'x'}['b']",
    "struct_dot_literal": "SELECT {'a': 1}.a",
    "row_constructor": "SELECT row(1, 'y') AS r",
    "map_subscript": "SELECT MAP {'k1': 10, 'k2': 20}['k2']",
    "map_functions": "SELECT cardinality(MAP {'a': 1}), "
                     "map_keys(MAP {'a': 1, 'b': 2}), "
                     "map_values(MAP {'a': 1, 'b': 2}), "
                     "map_contains(MAP {'a': 1}, 'a'), "
                     "map_contains(MAP {'a': 1}, 'z')",
    "struct_column_fields": "SELECT id, s.x, s.y FROM nt ORDER BY id",
    "struct_column_arith": "SELECT id, s['x'] + 1 FROM nt ORDER BY id",
    "struct_column_filter": "SELECT id, struct_extract(s, 'y') FROM nt "
                            "WHERE s.x > 15",
    "struct_column_sum": "SELECT sum(s.x) FROM nt",
    "struct_column_group": "SELECT s.x, count(*) FROM nt GROUP BY s.x "
                           "ORDER BY 1",
    "list_column_index": "SELECT id, l[1], l[-1] FROM nt ORDER BY id",
    "list_sort_column": "SELECT list_sort(l) FROM lt",
    "list_constants": "SELECT list_distinct([1,2,2,3]), "
                      "list_unique([1,2,2,3]), flatten([[1,2],[3]]), "
                      "list_slice([1,2,3,4,5], 2, 4), "
                      "array_to_string([1,2,3], '-'), "
                      "list_position([7,8,9], 8)",
    "list_column_aggregates": "SELECT list_sum(l), list_min(l), list_avg(l) "
                              "FROM lt",
    "runtime_list_numbers": "SELECT [i, i * 2] FROM rl ORDER BY s",
    "runtime_list_strings": "SELECT [s, 'x'] FROM rl ORDER BY s",
    "runtime_list_functions": "SELECT len([i, 1]), list_sum([i, i]), "
                              "list_contains([i, 4], 4) FROM rl ORDER BY s",
    "lambda_transform": "SELECT list_transform([1,2,3], x -> x + 1)",
    "lambda_filter": "SELECT list_filter([1,2,3,4], x -> x % 2 = 0)",
    "lambda_reduce": "SELECT list_reduce([1,2,3,4], (a, b) -> a + b)",
    "lambda_python_style": "SELECT list_transform([1,2], lambda x: x * 10)",
    "lambda_over_column": "SELECT id, list_transform(l, x -> x * 2), "
                          "list_filter(l, x -> x > 1) FROM nt ORDER BY id",
    "comprehension": "SELECT [x * 2 FOR x IN [1,2,3]], "
                     "[x FOR x IN [1,2,3,4] IF x > 2], array[7, 8]",
    "list_funcs_over_aggregates": "SELECT list_sort(list(i)), "
                                  "list_distinct(list(i % 2)) FROM z",
    "string_to_list": "SELECT '[12,13,14]'::INT[], '[[1,2],[3]]'::INT[][], "
                      "'[1, NULL, 3]'::INT[], '[]'::INT[]",
    "try_cast_list": "SELECT TRY_CAST('[1,2,X,2]' AS INT[]), "
                     "TRY_CAST('[12345678901]' AS INT[])",
    "string_to_struct_map": "SELECT '{key_A:0}'::STRUCT(key_A INT), "
                            "'{name: value, age: 30}'::STRUCT(name VARCHAR, "
                            "age INT), '{a=1, b=2}'::MAP(VARCHAR, INT)",
    "nested_to_varchar": "SELECT '[1,2,NULL]'::INT[]::VARCHAR, "
                         "['a,b', 'plain', '']::VARCHAR, {'a': 1}::VARCHAR",
    "quoted_atoms": "SELECT $$['x, y', z]$$::VARCHAR[], 1 == 1, 2 <> 3, "
                    "struct_pack(key_A => 42)",
    "union_value": "SELECT union_value(num := 2)",
    "bit_casts": "SELECT '0101011'::BIT, '0101011'::BITSTRING, NULL::BIT, "
                 "TRY_CAST('102' AS BIT), TRY_CAST('101' AS BIT)",
    "bit_functions": "SELECT bit_length('0'::BIT), "
                     "octet_length('101010111'::BIT), "
                     "bit_count('10101'::BIT), get_bit('1010000'::BIT, 0), "
                     "set_bit('11111'::BIT, 0, 0), "
                     "bit_position('010'::BIT, '1110101'::BIT), "
                     "bitstring('0101011'::VARCHAR, 15), "
                     "bitstring('1'::BIT, 6)",
    "bit_operators": "SELECT '10101'::BIT & '10001'::BIT, "
                     "'1011'::BIT | '0001'::BIT, xor('101'::BIT, '001'::BIT), "
                     "~('101'::BIT), '0110101'::BIT << 3, '0110101'::BIT >> 2",
    "bit_blob_casts": "SELECT 'ab'::BLOB, 'ab'::BLOB::BIT, "
                      "('ab'::BLOB::BIT << 2)::BLOB, 2::BIT, "
                      "(2::BIT & 2::BIT) = 2::BIT",
    "bit_column": "SELECT bit_length(b::BIT), bit_count(b::BIT), "
                  "set_bit(b::BIT, 3, 0) FROM bt",
    "alias_refs": "SELECT 2 AS a, a*a AS b, b+a",
}

# ---- aggregates that run on the host -------------------------------------------

HOST_AGG = {
    "list_grouped": "SELECT k % 2 AS g, list(s) FROM t GROUP BY g ORDER BY g",
    "list_ungrouped": "SELECT list(k) FROM t",
    "string_agg_ungrouped": "SELECT string_agg(s, ';') FROM t",
    "string_agg_grouped": "SELECT k % 2 AS g, string_agg(s, '|') FROM t "
                          "GROUP BY g ORDER BY g",
    "list_mixed_with_plain": "SELECT k % 2 AS g, count(*), sum(k), list(s) "
                             "FROM t GROUP BY g ORDER BY g",
    "list_by_string_key": "SELECT g, list(v), list(s) FROM g GROUP BY g "
                          "ORDER BY g",
    "list_order_by": "SELECT g, list(v ORDER BY v DESC, s), "
                     "list(s ORDER BY s NULLS FIRST, v) FROM g GROUP BY g "
                     "ORDER BY g",
    "list_distinct": "SELECT k, list(DISTINCT v ORDER BY v) FROM g "
                     "GROUP BY k ORDER BY k",
    "string_agg_order_by": "SELECT g, string_agg(s, ',' ORDER BY s DESC, v) "
                           "FROM g GROUP BY g ORDER BY g",
    "string_agg_distinct": "SELECT k, string_agg(DISTINCT s, '+' ORDER BY s) "
                           "FROM g GROUP BY k ORDER BY k",
    "string_agg_numbers_dates": "SELECT k, string_agg(v, ','), "
                                "string_agg(d, ';'), string_agg(b, '') "
                                "FROM g GROUP BY k ORDER BY k",
    "string_agg_doubles": "SELECT k, string_agg(x, ',') FROM g WHERE v < 4 "
                          "GROUP BY k ORDER BY k",
    "histogram_plain": "SELECT k, histogram(v) FROM g GROUP BY k ORDER BY k",
    "histogram_strings": "SELECT histogram(s) FROM g",
    "histogram_bins": "SELECT histogram(n, [10, 20, 30]) FROM h",
    "histogram_exact": "SELECT histogram_exact(n, [5, 99]) FROM h",
    "approx_top_k": "SELECT k, approx_top_k(v, 3) FROM g GROUP BY k "
                    "ORDER BY k",
    "mad": "SELECT g, mad(x), mad(v) FROM g GROUP BY g ORDER BY g",
    "mad_ungrouped": "SELECT mad(x) FROM g",
    "mixed_with_builtin": "SELECT g, list(v), sum(v), avg(x), min(x), "
                          "max(v), count(v), count(*), any_value(k) FROM g "
                          "GROUP BY g ORDER BY g",
    "host_two_keys": "SELECT g, k, string_agg(s, ','), sum(v) FROM g "
                     "GROUP BY g, k ORDER BY g, k",
    "host_null_key": "SELECT s, list(v) FROM g GROUP BY s ORDER BY s",
    "host_over_device_distinct": "SELECT g, list(s ORDER BY s), "
                                 "string_agg(s, ',') FROM (SELECT DISTINCT g, "
                                 "s FROM g WHERE s IS NOT NULL) GROUP BY g "
                                 "ORDER BY g",
    "unnest_of_list_agg": "SELECT g, unnest(l) FROM (SELECT g, list(v ORDER "
                          "BY v) AS l FROM g WHERE v < 5 GROUP BY g) "
                          "ORDER BY g",
    "user_aggregate": "SELECT g, geomean(v) FROM gm GROUP BY g ORDER BY g",
    "user_aggregate_all_null": "SELECT geomean(v) FROM gm WHERE v IS NULL",
    "user_aggregate_varchar": "SELECT g, firstlast(v) FROM gm GROUP BY g "
                              "ORDER BY g",
    "user_aggregate_mixed": "SELECT g, geomean(v), count(*), sum(v) FROM gm "
                            "GROUP BY g ORDER BY g",
    "within_group": "SELECT percentile_cont(0.5) WITHIN GROUP (ORDER BY x), "
                    "percentile_disc(0.25) WITHIN GROUP (ORDER BY x), "
                    "mode() WITHIN GROUP (ORDER BY x) FROM wg",
    "arg_null_variants": "SELECT arg_max(a, b), arg_max_null(a, b) FROM tn",
}

# ---- time zones, TIMETZ, stringify, Python functions -----------------------------

TZ = {
    "timezone_function": "SELECT timezone('America/New_York', TIMESTAMP "
                         "'2024-01-15 12:00:00'), TIMESTAMP '2024-07-15 "
                         "12:00:00' AT TIME ZONE 'America/New_York', "
                         "from_utc_timestamp(TIMESTAMP '2024-01-15 "
                         "17:00:00', 'America/New_York')",
    "timezone_column": "SELECT timezone('America/New_York', t) FROM ev "
                       "ORDER BY t",
    "timezone_column_inverse": "SELECT t, from_utc_timestamp(t, "
                               "'Europe/Berlin'), to_utc_timestamp(t, "
                               "'Asia/Kolkata') FROM ev ORDER BY t",
    "tstz_literal": "SELECT '2024-01-01 00:00:00+02'::TIMESTAMPTZ, "
                    "typeof('2024-01-01 00:00:00+02'::TIMESTAMPTZ), "
                    "typeof(CAST('2024-01-01' AS TIMESTAMP WITH TIME ZONE))",
    "at_time_zone": "SELECT '2021-01-01 05:00:00'::TIMESTAMP AT TIME ZONE "
                    "'America/New_York', ('2021-01-01 10:00:00+00'"
                    "::TIMESTAMPTZ) AT TIME ZONE 'America/New_York'",
    "tstz_compare": "SELECT '2024-01-01 00:00:00+00'::TIMESTAMPTZ = "
                    "'2024-01-01 01:00:00+01'::TIMESTAMPTZ, "
                    "'2024-01-01 00:00:00+00'::TIMESTAMPTZ > TIMESTAMP "
                    "'2023-01-01 00:00:00'",
    "interval_hours": "SELECT TIMESTAMP '2024-01-01 00:00:00' + INTERVAL 1 "
                      "HOUR, '2024-01-01 00:00:00+00'::TIMESTAMPTZ + "
                      "INTERVAL 90 MINUTE",
    "interval_months_clamp": "SELECT TIMESTAMP '2024-01-31 10:00:00' + "
                             "INTERVAL 1 MONTH, TIMESTAMP '2024-03-31 "
                             "10:00:00' - INTERVAL 1 MONTH",
    "interval_months_column": "SELECT t + INTERVAL 1 MONTH, t + INTERVAL 1 "
                              "YEAR FROM ti",
    "timestamp_difference": "SELECT TIMESTAMP '2024-01-02 02:00:00' - "
                            "TIMESTAMP '2024-01-01 00:00:00'",
    "time_wraps": "SELECT TIME '23:30:00' + INTERVAL 1 HOUR, DATE "
                  "'2024-01-01' + INTERVAL 36 HOUR",
    "timetz_compare": "SELECT timetz '10:00:00+05' < timetz '06:30:00+00', "
                      "timetz '10:00:00+05' = timetz '05:00:00+00', "
                      "(timetz '10:00:00+05')::varchar, ('2023-08-20 "
                      "16:15:03.123456'::TIMESTAMP::TIMETZ)::varchar",
    "timetz_order": "SELECT t::varchar FROM (SELECT unnest([timetz "
                    "'05:00:00+00', timetz '10:00:00+05', timetz "
                    "'00:00:00-05']) AS t) ORDER BY t",
    "time_parsing": "SELECT try_cast('11' AS time), try_cast('11:' AS "
                    "time)::varchar, '14:42:04.999999999'::TIME::VARCHAR, "
                    "('2021-08-20'::TIME)::varchar",
    "stringify_timestamps": "SELECT t::VARCHAR FROM ev ORDER BY t",
    "stringify_dates": "SELECT id, d::VARCHAR, length(ts::VARCHAR) FROM f "
                       "WHERE id < 40 ORDER BY id",
    "strftime": "SELECT strftime(DATE '2024-01-05', '%Y/%m/%-d'), "
                "strftime('%d.%m.%Y', DATE '1992-03-02')",
    "udf_basic": "SELECT a, plus_ten(a) FROM u ORDER BY a",
    "udf_varchar_arg": "SELECT slen(s), halve(a) FROM u WHERE a = 3",
    "udf_none_is_null": "SELECT oddnull(a) FROM u ORDER BY a",
    "udf_in_where_and_agg": "SELECT sum(plus_ten(a)) FROM u WHERE slen(s) > 1",
    "udf_varchar_return": "SELECT tag(x) FROM uv ORDER BY 1",
    "udf_varchar_return_length": "SELECT length(tag(x)) FROM uv ORDER BY 1",
    "udf_over_seeded": "SELECT id, plus_ten(i), tag(j), slen(s) FROM f "
                       "WHERE i IS NOT NULL ORDER BY id",
}

# statements that read the connection's time zone setting; run with the
# zone set on both connections (`set_timezone`)
ZONE = "America/New_York"
ZONED = {
    "zoned_cast": "SELECT '2024-01-01 12:00:00'::TIMESTAMPTZ, "
                    "('2024-01-01 17:00:00+00'::TIMESTAMPTZ)::TIMESTAMP, "
                    "year('2024-01-01 03:00:00+00'::TIMESTAMPTZ)",
    "zoned_column_cast": "SELECT t::TIMESTAMPTZ, "
                           "extract(hour FROM t::TIMESTAMPTZ), "
                           "t::TIMESTAMPTZ::VARCHAR FROM ev ORDER BY t",
    "zoned_timetz": "SELECT t::TIMESTAMPTZ::TIMETZ::VARCHAR FROM ev "
                      "WHERE t IS NOT NULL ORDER BY t",
}


def set_timezone(con, zone: str) -> None:
    """Set the time zone of a connection of either package."""
    con.config.set("timezone", zone)


# Statements where the reference package's device layer is wrong and this
# one is right (ROADMAP.md section 3 names each fault); the tests hold
# them against values computed independently.
DEVIATIONS = {
    # the reference counts transition bounds at or below the instant, and
    # the first bound, a stand-in for minus infinity, wraps when the zone
    # table is scaled to micros: instants before 1970 land one transition
    # off
    "timezone_before_1970": "SELECT t, timezone('America/New_York', t), "
                            "from_utc_timestamp(t, 'Europe/Berlin') FROM old "
                            "ORDER BY t",
    # the reference's host aggregate reads a wide (two-limb) sum's low
    # word only
    "host_over_wide_sum": "SELECT g, list(t) FROM (SELECT g, sum(v * "
                          "300000000000000000) AS t FROM g GROUP BY g) "
                          "GROUP BY g ORDER BY g",
    # and so a wide sum that a recursive CTE (UNION: de-duplicated each
    # round) carries comes out of the reference wrapped
    "recursive_over_wide_sum": "WITH RECURSIVE d(g, t, i) AS (SELECT g, "
                               "sum(v * 300000000000000000), 0 FROM g GROUP "
                               "BY g UNION SELECT g, t, (i + 1) % 3 FROM d) "
                               "SELECT g, i, t FROM d ORDER BY g, i",
}

GROUPS = {"functions": FUNCTIONS, "cte": CTE, "lists": LISTS,
          "host_agg": HOST_AGG, "tz": TZ}


def all_statements():
    """{group/name: sql} of every statement that needs no zone setting."""
    return {f"{g}/{n}": sql for g, d in GROUPS.items() for n, sql in d.items()}
