"""A corpus of small window and holistic-aggregate statements with the
tables they read, made from a seed.

The CPU tests run every statement through the reference package and
through this one on the CPU; the card's smoke run runs them through this
package on the card and on the CPU.  Every statement orders its rows by
a unique key, so two executors must return the same list.  ORDER BY ties
inside a window are resolved by input row (both packages sort stably).
"""

from __future__ import annotations

import datetime

import numpy as np

ROWS = 240


def tables(seed: int = 5):
    """{table: {column: list or numpy array}}, registrable by both
    packages' `Connection.register`.

    w: ROWS rows; id unique; p a partition key (6 values and NULLs); o an
    order key with ties and NULLs; f doubles with NULLs, -0.0 and values
    from 1e-3 to 1e15 in magnitude by partition; d dates; s strings; v
    ints with NULLs; b booleans.  k: a small table to join w.p against.
    The others are the tables of the reference package's window tests."""
    rng = np.random.default_rng(seed)
    n = ROWS

    def with_nulls(values, share):
        out = [v.item() if hasattr(v, "item") else v for v in values]
        for i in np.flatnonzero(rng.random(n) < share):
            out[i] = None
        return out

    p = rng.integers(0, 6, n)
    o = rng.integers(0, 12, n)
    scale = np.array([1e15, 1.0, 1e-3, 1e6, 1.0, 1e3])[p]
    f = np.round(rng.normal(0, 10, n), 3) * scale
    f[rng.integers(0, n, 4)] = -0.0
    f[rng.integers(0, n, 4)] = 0.0
    day0 = datetime.date(2024, 1, 1)
    w = {
        "id": np.arange(n, dtype=np.int32),
        "p": with_nulls(p, 0.05),
        "o": with_nulls(o, 0.08),
        "f": with_nulls(f, 0.1),
        "d": [day0 + datetime.timedelta(days=int(x))
              for x in rng.integers(0, 20, n)],
        "s": [f"s{int(x):02d}" for x in rng.integers(0, 9, n)],
        "v": with_nulls(rng.integers(-50, 50, n), 0.15),
        "b": with_nulls(rng.random(n) < 0.5, 0.1),
    }
    return {
        "w": w,
        "k": {"p": [0, 1, 2, 2, 7], "label": ["zero", "one", "two", "deux",
                                              "seven"]},
        "t": {"g": ["a", "a", "a", "b", "b"], "x": [3, 1, 2, 10, 20],
              "v": [30, 10, 20, 100, 200]},
        "r": {"x": [10, 10, 20, 30, 30]},
        "wr": {"g": ["a", "a", "a", "a", "b", "b"], "t": [1, 2, 4, 7, 1, 10],
               "v": [10, 20, 30, 40, 5, 6]},
        "q": {"g": ["a", "a", "a", "b", "b"], "v": [1, 3, 2, 5, 4]},
        "ta": {"cls": ["a", "a", "b", "b"], "item": ["i1", "i2", "i3", "i4"],
               "v": [10, 20, 30, 40]},
    }


def _w(select: str, tail: str = "") -> str:
    return f"SELECT id, {select} FROM w {tail} ORDER BY id"


_PO = "PARTITION BY p ORDER BY o"

WINDOW = {
    # ---- ranking ----------------------------------------------------------
    "ranking": _w(f"row_number() OVER ({_PO}), rank() OVER ({_PO}), "
                  f"dense_rank() OVER ({_PO})"),
    "distribution": _w(f"percent_rank() OVER ({_PO}), cume_dist() OVER "
                       f"({_PO}), ntile(3) OVER ({_PO})"),
    "desc_nulls_first": _w("rank() OVER (PARTITION BY p ORDER BY o DESC "
                           "NULLS FIRST), row_number() OVER (PARTITION BY p "
                           "ORDER BY o DESC NULLS FIRST)"),
    "desc_nulls_last": _w("dense_rank() OVER (PARTITION BY s ORDER BY f "
                          "DESC NULLS LAST, id)"),
    "no_partition": _w("row_number() OVER (ORDER BY f, id), "
                       "rank() OVER (ORDER BY d)"),
    "string_and_bool_keys": _w("row_number() OVER (PARTITION BY s, b "
                               "ORDER BY d, id)"),
    # ---- lag / lead / value functions ---------------------------------------
    "lag_lead": _w(f"lag(v) OVER ({_PO}), lead(f) OVER ({_PO}), "
                   f"lag(s, 2) OVER ({_PO}), lead(v, 3) OVER ({_PO})"),
    "first_last_default": _w(f"first_value(v) OVER ({_PO}), "
                             f"last_value(v) OVER ({_PO}), "
                             f"first_value(s) OVER ({_PO})"),
    "nth_value": _w(f"nth_value(v, 2) OVER ({_PO}), nth_value(f, 4) OVER "
                    "(PARTITION BY p ORDER BY id ROWS BETWEEN 2 PRECEDING "
                    "AND 2 FOLLOWING)"),
    "first_last_framed": _w("first_value(v) OVER (PARTITION BY p ORDER BY id "
                            "ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING), "
                            "last_value(f) OVER (PARTITION BY p ORDER BY id "
                            "ROWS BETWEEN 2 PRECEDING AND 1 PRECEDING)"),
    # ---- aggregates over the default frame ----------------------------------
    "running_int": _w(f"sum(v) OVER ({_PO}), count(v) OVER ({_PO}), "
                      f"count(*) OVER ({_PO}), avg(v) OVER ({_PO})"),
    "running_float": _w(f"sum(f) OVER ({_PO}), avg(f) OVER ({_PO})"),
    "running_minmax": _w(f"min(f) OVER ({_PO}), max(v) OVER ({_PO}), "
                         f"min(d) OVER ({_PO}), max(b) OVER ({_PO})"),
    "partition_totals": _w("sum(v) OVER (PARTITION BY p), avg(f) OVER "
                           "(PARTITION BY p), min(v) OVER (PARTITION BY s), "
                           "max(f) OVER (PARTITION BY s), count(*) OVER "
                           "(PARTITION BY p)"),
    "whole_table": _w("sum(v) OVER (), count(f) OVER (), max(d) OVER ()"),
    "distinct_over_partition": _w("count(DISTINCT v) OVER (PARTITION BY p), "
                                  "sum(DISTINCT v) OVER (PARTITION BY p), "
                                  "avg(DISTINCT o) OVER (PARTITION BY s), "
                                  "count(DISTINCT f) OVER ()"),
    # ---- ROWS frames ----------------------------------------------------------
    "rows_moving_sum": _w("sum(v) OVER (PARTITION BY p ORDER BY id ROWS "
                          "BETWEEN 2 PRECEDING AND CURRENT ROW), count(v) "
                          "OVER (PARTITION BY p ORDER BY id ROWS BETWEEN 1 "
                          "PRECEDING AND 3 FOLLOWING)"),
    "rows_centered_avg": _w("avg(v) OVER (PARTITION BY p ORDER BY id ROWS "
                            "BETWEEN 1 PRECEDING AND 1 FOLLOWING), sum(f) "
                            "OVER (PARTITION BY p ORDER BY id ROWS BETWEEN 3 "
                            "PRECEDING AND 2 FOLLOWING)"),
    "rows_minmax": _w("min(v) OVER (PARTITION BY p ORDER BY id ROWS BETWEEN "
                      "3 PRECEDING AND 1 FOLLOWING), max(f) OVER (PARTITION "
                      "BY p ORDER BY id ROWS BETWEEN 5 PRECEDING AND 5 "
                      "FOLLOWING)"),
    "rows_running_minmax": _w("min(v) OVER (PARTITION BY p ORDER BY id ROWS "
                              "BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW), "
                              "max(v) OVER (ORDER BY id ROWS UNBOUNDED "
                              "PRECEDING)"),
    "rows_to_the_end": _w("sum(v) OVER (PARTITION BY p ORDER BY id ROWS "
                          "BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING), "
                          "min(f) OVER (PARTITION BY p ORDER BY id ROWS "
                          "BETWEEN 1 FOLLOWING AND UNBOUNDED FOLLOWING)"),
    "rows_empty_frame": _w("sum(v) OVER (PARTITION BY p ORDER BY id ROWS "
                           "BETWEEN 3 FOLLOWING AND 5 FOLLOWING), count(*) "
                           "OVER (PARTITION BY p ORDER BY id ROWS BETWEEN 4 "
                           "PRECEDING AND 2 PRECEDING)"),
    # ---- RANGE value frames ---------------------------------------------------
    "range_int": _w("sum(v) OVER (PARTITION BY p ORDER BY o RANGE BETWEEN 2 "
                    "PRECEDING AND CURRENT ROW), count(*) OVER (PARTITION BY "
                    "p ORDER BY o RANGE BETWEEN 1 PRECEDING AND 3 "
                    "FOLLOWING)"),
    "range_desc_nulls_first": _w("sum(v) OVER (PARTITION BY p ORDER BY o "
                                 "DESC NULLS FIRST RANGE BETWEEN 2 PRECEDING "
                                 "AND 1 FOLLOWING), max(v) OVER (PARTITION BY "
                                 "p ORDER BY o DESC RANGE BETWEEN 3 PRECEDING "
                                 "AND CURRENT ROW)"),
    "range_float": _w("count(v) OVER (ORDER BY f RANGE BETWEEN 5.5 PRECEDING "
                      "AND 0.25 FOLLOWING), min(v) OVER (PARTITION BY s ORDER "
                      "BY f RANGE BETWEEN 10 PRECEDING AND 10 FOLLOWING)"),
    "range_date": _w("sum(v) OVER (PARTITION BY s ORDER BY d RANGE BETWEEN "
                     "3 PRECEDING AND CURRENT ROW), count(*) OVER (ORDER BY "
                     "d DESC RANGE BETWEEN 2 PRECEDING AND 1 FOLLOWING)"),
    "range_decimal": _w("sum(v) OVER (PARTITION BY p ORDER BY CAST(o AS "
                        "DECIMAL(8,2)) RANGE BETWEEN 1.5 PRECEDING AND 2 "
                        "FOLLOWING)"),
    "range_unbounded_following": _w("sum(v) OVER (PARTITION BY p ORDER BY o "
                                    "RANGE BETWEEN CURRENT ROW AND UNBOUNDED "
                                    "FOLLOWING)"),
    # ---- GROUPS frames and EXCLUDE --------------------------------------------
    "groups": _w("sum(v) OVER (PARTITION BY p ORDER BY o GROUPS BETWEEN 1 "
                 "PRECEDING AND 1 FOLLOWING), min(v) OVER (PARTITION BY p "
                 "ORDER BY o GROUPS BETWEEN 2 PRECEDING AND CURRENT ROW), "
                 "count(*) OVER (ORDER BY s GROUPS BETWEEN CURRENT ROW AND 1 "
                 "FOLLOWING)"),
    "exclude_current_row": _w("sum(v) OVER (PARTITION BY p ORDER BY o ROWS "
                              "BETWEEN 2 PRECEDING AND 2 FOLLOWING EXCLUDE "
                              "CURRENT ROW), max(v) OVER (PARTITION BY p "
                              "ORDER BY id ROWS BETWEEN 2 PRECEDING AND 2 "
                              "FOLLOWING EXCLUDE CURRENT ROW)"),
    "exclude_group": _w("sum(v) OVER (PARTITION BY p ORDER BY o RANGE "
                        "BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING "
                        "EXCLUDE GROUP), min(v) OVER (PARTITION BY p ORDER "
                        "BY o ROWS BETWEEN 3 PRECEDING AND 3 FOLLOWING "
                        "EXCLUDE GROUP)"),
    "exclude_ties": _w("count(v) OVER (PARTITION BY p ORDER BY o ROWS "
                       "BETWEEN 3 PRECEDING AND 3 FOLLOWING EXCLUDE TIES), "
                       "max(v) OVER (PARTITION BY p ORDER BY o GROUPS "
                       "BETWEEN 1 PRECEDING AND 1 FOLLOWING EXCLUDE TIES)"),
    # ---- dead rows: filtered and joined inputs -----------------------------
    "filtered_input": _w(f"row_number() OVER ({_PO}), sum(v) OVER ({_PO}), "
                         "count(*) OVER (), min(v) OVER (ORDER BY id ROWS "
                         "BETWEEN 2 PRECEDING AND CURRENT ROW)",
                         "WHERE v > 0 AND o IS NOT NULL"),
    "filtered_to_nothing": "SELECT id, row_number() OVER (ORDER BY id) "
                           "FROM w WHERE v > 1000",
    "joined_input": "SELECT w.id, k.label, rank() OVER (PARTITION BY "
                    "k.label ORDER BY w.o), sum(w.v) OVER (PARTITION BY w.p "
                    "ORDER BY w.id ROWS 1 PRECEDING) FROM w JOIN k ON w.p = "
                    "k.p ORDER BY w.id, k.label",
    "top2_per_group": "SELECT p, f FROM (SELECT p, f, row_number() OVER "
                      "(PARTITION BY p ORDER BY f DESC) AS rn FROM w WHERE "
                      "f IS NOT NULL) sub WHERE rn <= 2 ORDER BY p, f",
    # ---- QUALIFY, named windows, windows over aggregates ---------------------
    "qualify": "SELECT g, v FROM q QUALIFY row_number() OVER (PARTITION BY g "
               "ORDER BY v DESC) = 1 ORDER BY g",
    "qualify_alias": "SELECT g, v, rank() OVER (PARTITION BY g ORDER BY v) r "
                     "FROM q QUALIFY r <= 2 ORDER BY g, v",
    "qualify_over_aggregate": "SELECT g, sum(v) s FROM q GROUP BY g QUALIFY "
                              "row_number() OVER (ORDER BY sum(v) DESC) = 1",
    "named_window": "SELECT g, v, row_number() OVER win AS rn, sum(v) OVER "
                    "win AS s FROM q WINDOW win AS (PARTITION BY g ORDER BY "
                    "v) ORDER BY g, v",
    "ratio_over_class": "SELECT item, sum(v) * 100.0 / sum(sum(v)) OVER "
                        "(PARTITION BY cls) FROM ta GROUP BY item, cls "
                        "ORDER BY item",
    "rank_over_aggregate": "SELECT cls, sum(v) AS s, rank() OVER (ORDER BY "
                           "sum(v) DESC) AS r FROM ta GROUP BY cls "
                           "ORDER BY cls",
    "avg_over_aggregate": "SELECT item, avg(sum(v)) OVER (PARTITION BY cls) "
                          "AS m FROM ta GROUP BY item, cls ORDER BY item",
    "having_before_window": "SELECT item, sum(sum(v)) OVER () AS tot FROM ta "
                            "GROUP BY item HAVING sum(v) > 15 ORDER BY item",
    # ---- the reference package's own window tests ----------------------------
    "t_row_number": "SELECT x, row_number() OVER (PARTITION BY g ORDER BY x)"
                    " FROM t ORDER BY g, x",
    "r_rank_dense_rank": "SELECT x, rank() OVER (ORDER BY x), dense_rank() "
                         "OVER (ORDER BY x) FROM r ORDER BY x, 2",
    "t_running_sum": "SELECT g, x, sum(v) OVER (PARTITION BY g ORDER BY x) "
                     "FROM t ORDER BY g, x",
    "t_partition_total": "SELECT g, x, sum(v) OVER (PARTITION BY g) FROM t "
                         "ORDER BY g, x",
    "t_lag_lead": "SELECT x, lag(x) OVER (PARTITION BY g ORDER BY x), "
                  "lead(x) OVER (PARTITION BY g ORDER BY x) FROM t "
                  "ORDER BY g, x",
    "t_first_value": "SELECT x, first_value(v) OVER (PARTITION BY g ORDER "
                     "BY x) FROM t ORDER BY g, x",
    "t_count_avg": "SELECT x, count(*) OVER (PARTITION BY g), avg(v) OVER "
                   "(PARTITION BY g) FROM t ORDER BY g, x",
    "t_rows_moving_sum": "SELECT g, x, sum(v) OVER (PARTITION BY g ORDER BY "
                         "x ROWS BETWEEN 1 PRECEDING AND CURRENT ROW) FROM t "
                         "ORDER BY g, x",
    "t_rows_centered_avg": "SELECT x, avg(v) OVER (PARTITION BY g ORDER BY x "
                           "ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) FROM t "
                           "ORDER BY g, x",
    "wr_range": "SELECT g, t, sum(v) OVER (PARTITION BY g ORDER BY t RANGE "
                "BETWEEN 2 PRECEDING AND CURRENT ROW) FROM wr ORDER BY g, t",
    "wr_range_desc": "SELECT t, sum(v) OVER (ORDER BY t DESC RANGE BETWEEN 2 "
                     "PRECEDING AND CURRENT ROW) FROM wr WHERE g='a' "
                     "ORDER BY t",
    "wr_range_count": "SELECT t, count(*) OVER (ORDER BY t RANGE BETWEEN 3 "
                      "PRECEDING AND 3 FOLLOWING) FROM wr WHERE g='a' "
                      "ORDER BY t",
    "wr_rows_shorthand": "SELECT t, sum(v) OVER (ORDER BY t ROWS 2 "
                         "PRECEDING) FROM wr WHERE g='a' ORDER BY t",
}

# an offset beyond the batch: the reference package raises on it (its
# shifted copy is built with a slice of that length); here it is NULL
PORT_ONLY = {
    "lag_past_the_batch": _w("lag(v, 500) OVER (ORDER BY id), "
                             "lead(v, 100000) OVER (ORDER BY id)"),
}

# what the reference package's tests expect of its own statements above
EXPECTED = {
    "lag_past_the_batch": [(i, None, None) for i in range(ROWS)],
    "t_row_number": [(1, 1), (2, 2), (3, 3), (10, 1), (20, 2)],
    "r_rank_dense_rank": [(10, 1, 1), (10, 1, 1), (20, 3, 2), (30, 4, 3),
                          (30, 4, 3)],
    "t_running_sum": [("a", 1, 10), ("a", 2, 30), ("a", 3, 60),
                      ("b", 10, 100), ("b", 20, 300)],
    "t_partition_total": [("a", 1, 60), ("a", 2, 60), ("a", 3, 60),
                          ("b", 10, 300), ("b", 20, 300)],
    "t_lag_lead": [(1, None, 2), (2, 1, 3), (3, 2, None), (10, None, 20),
                   (20, 10, None)],
    "t_first_value": [(1, 10), (2, 10), (3, 10), (10, 100), (20, 100)],
    "t_count_avg": [(1, 3, 20.0), (2, 3, 20.0), (3, 3, 20.0), (10, 2, 150.0),
                    (20, 2, 150.0)],
    "t_rows_moving_sum": [("a", 1, 10), ("a", 2, 30), ("a", 3, 50),
                          ("b", 10, 100), ("b", 20, 300)],
    "t_rows_centered_avg": [(1, 15.0), (2, 20.0), (3, 25.0), (10, 150.0),
                            (20, 150.0)],
    "wr_range": [("a", 1, 10), ("a", 2, 30), ("a", 4, 50), ("a", 7, 40),
                 ("b", 1, 5), ("b", 10, 6)],
    "wr_range_desc": [(1, 30), (2, 50), (4, 30), (7, 40)],
    "wr_range_count": [(1, 3), (2, 3), (4, 4), (7, 2)],
    "wr_rows_shorthand": [(1, 10), (2, 30), (4, 60), (7, 90)],
    "qualify": [("a", 3), ("b", 5)],
    "qualify_alias": [("a", 1, 1), ("a", 2, 2), ("b", 4, 1), ("b", 5, 2)],
    "qualify_over_aggregate": [("b", 9)],
    "named_window": [("a", 1, 1, 1), ("a", 2, 2, 3), ("a", 3, 3, 6),
                     ("b", 4, 1, 4), ("b", 5, 2, 9)],
    "rank_over_aggregate": [("a", 30, 2), ("b", 70, 1)],
    "having_before_window": [("i2", 90), ("i3", 90), ("i4", 90)],
    "filtered_to_nothing": [],
}


def _g(select: str, tail: str = "") -> str:
    return f"SELECT p, {select} FROM w {tail} GROUP BY p ORDER BY p"


HOLISTIC = {
    "distinct_grouped": _g("count(DISTINCT v), sum(DISTINCT v), "
                           "avg(DISTINCT o), count(DISTINCT s), count(*)"),
    "distinct_ungrouped": "SELECT count(DISTINCT v), sum(DISTINCT o), "
                          "count(DISTINCT f), count(DISTINCT d) FROM w",
    "distinct_float": _g("sum(DISTINCT f), avg(DISTINCT f)"),
    "median_grouped": _g("median(v), median(f), quantile_cont(f, 0.25), "
                         "quantile_disc(v, 0.9), quantile_disc(d, 0.5)"),
    "median_ungrouped": "SELECT median(f), quantile_cont(v, 0.1), "
                        "quantile_disc(s, 0.5) FROM w",
    "quantile_decimal": _g("quantile_cont(CAST(v AS DECIMAL(9,2)), 0.3), "
                           "quantile_disc(CAST(v AS DECIMAL(9,2)), 0.3)"),
    "mode_grouped": _g("mode(o), mode(s), mode(b)"),
    "mode_ungrouped": "SELECT mode(o), mode(s), mode(d) FROM w",
    "argext_grouped": _g("arg_min(id, f), arg_max(id, f), arg_max(s, id), "
                         "arg_min(v, id)"),
    "argext_ungrouped": "SELECT arg_min(id, f), arg_max(s, id), "
                        "arg_max(v, -id) FROM w",
    "entropy_grouped": _g("entropy(o), entropy(s)"),
    "entropy_ungrouped": "SELECT entropy(o), entropy(b) FROM w",
    "bit_grouped": _g("bit_and(v), bit_or(v), bit_xor(v), bit_or(id)"),
    "bit_ungrouped": "SELECT bit_and(o), bit_or(v), bit_xor(id) FROM w",
    "approx_grouped": _g("approx_count_distinct(v), "
                         "approx_count_distinct(s)"),
    "approx_ungrouped": "SELECT approx_count_distinct(id), "
                        "approx_count_distinct(o) FROM w",
    "all_null_group": "SELECT p, median(v), mode(v), count(DISTINCT v), "
                      "arg_max(v, id), entropy(v), bit_or(v), sum(v) FROM "
                      "(SELECT p, id, CASE WHEN p = 2 THEN NULL ELSE v END "
                      "AS v FROM w) x GROUP BY p ORDER BY p",
    "filtered_input": _g("median(f), count(DISTINCT o), mode(s), "
                         "arg_min(id, v)", "WHERE v > 0"),
    "filtered_to_nothing": "SELECT median(v), mode(v), count(DISTINCT v), "
                           "arg_max(id, v), entropy(v), bit_and(v) FROM w "
                           "WHERE v > 1000",
    "mixed_with_plain": "SELECT s, p, sum(v), median(v), count(*), "
                        "count(DISTINCT o), min(f) FROM w GROUP BY s, p "
                        "ORDER BY s, p",
    "string_group_key": "SELECT s, median(f), mode(o), last(v), product(o) "
                        "FROM w GROUP BY s ORDER BY s",
}
