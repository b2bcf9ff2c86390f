"""Joins through SQL: the same statement through ddb_tpu.connect() (JAX on
the CPU) and ddb_tpu_torch.connect(device="cpu") over small registered
tables with NULLs, duplicate keys, strings and floats.

Every join kind the executor has is reached: inner, left, right and full
outer; semi and anti, with and without a residual predicate; mark joins
from IN / NOT IN, correlated and not, with NULLs on either side; keys of
two and three columns; float keys with -0.0; range joins; asof joins in
both directions, strict and not; cross products; positional joins; outer
joins with a predicate and no keys; joins of empty inputs; UNION ALL.

Integers, strings, booleans and NULLs must match exactly, floats to 1e-12
relative.  A statement with no ORDER BY compares as a sorted multiset,
except where it has a LIMIT: then the rows' order is the join's own
(probe row, then build row) and must be the reference's."""

import math

import pytest

import ddb_tpu
import ddb_tpu_torch
from ddb_tpu_torch.plan import logical as L
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401

RTOL = 1e-12

TABLES = {
    "a": {"id": [1, 2, 3, 4, 5, 6, 7, 8],
          "k": [1, 2, 2, None, 3, 5, 2, 7],
          "v": [10, 20, 25, 40, None, 60, 5, 70],
          "s": ["x", "y", "y", "x", None, "z", "y", "x"]},
    "b": {"id": [1, 2, 3, 4, 5, 6],
          "k": [2, 2, 3, None, 4, 7],
          "w": [20, 30, 3, 50, 60, None],
          "s": ["y", "x", None, "x", "z", "x"]},
    # b without NULL keys, and a with a key b lacks: NOT IN is decided
    "bn": {"k": [2, 3, 7], "w": [20, 3, 70]},
    "fa": {"id": [1, 2, 3, 4, 5], "x": [0.0, -0.0, 1.5, None, -2.25]},
    "fb": {"id": [1, 2, 3, 4], "x": [-0.0, 1.5, 1.5, None]},
    "trades": {"sym": ["a", "a", "b", "b", "a", "c"],
               "t": [3, 7, 2, 9, 1, 4], "px": [10, 11, 20, 21, 9, 30]},
    "quotes": {"sym": ["a", "a", "b", "b", "a"],
               "qt": [2, 6, 2, 8, 6], "bid": [100, 101, 200, 201, 102]},
    "big": {"id": list(range(40)), "k": [i % 7 for i in range(40)]},
}

CORPUS = {
    "inner": "select a.id, b.id, a.v + b.w from a join b on a.k = b.k",
    "inner_ordered": """select a.id, b.id from a join b on a.k = b.k
                        order by a.id, b.id""",
    "inner_limit_keeps_join_order":
        "select a.id, b.id from a join b on a.k = b.k limit 5",
    "inner_strings": "select a.id, b.id, a.s from a join b on a.s = b.s",
    "left": "select a.id, b.id, b.w from a left join b on a.k = b.k",
    "right": "select a.id, b.id, a.v from a right join b on a.k = b.k",
    "full": "select a.id, b.id, a.s, b.s from a full join b on a.k = b.k",
    "left_residual": """select a.id, b.id from a left join b
                        on a.k = b.k and b.w > a.v""",
    "right_residual": """select a.id, b.id from a right join b
                         on a.k = b.k and b.w > a.v""",
    "full_residual": """select a.id, b.id from a full join b
                        on a.k = b.k and b.w >= a.v""",
    "inner_residual": """select a.id, b.id from a join b
                         on a.k = b.k and a.v <> b.w""",
    "group_over_join": """select a.k, count(*), sum(b.w) from a join b
                          on a.k = b.k group by a.k order by a.k""",
    "three_tables": """select a.id, b.id, big.id from a join b
                       on a.k = b.k join big on big.k = b.k""",
    "semi": "select id from a semi join b using (k)",
    "anti": "select id from a anti join b using (k)",
    "exists": """select id from a where exists
                 (select 1 from b where b.k = a.k)""",
    "exists_residual": """select id from a where exists
                          (select 1 from b where b.k = a.k and b.w > a.v)""",
    "not_exists_residual": """select id from a where not exists
                              (select 1 from b where b.k = a.k
                               and b.w > a.v)""",
    "in_mark_nulls": "select id, k in (select k from b) from a",
    "not_in_mark_nulls": "select id, k not in (select k from b) from a",
    "in_mark_no_build_nulls": "select id, k in (select k from bn) from a",
    "where_not_in_build_null": """select id from a
                                  where k not in (select k from b)""",
    "where_not_in": "select id from a where k not in (select k from bn)",
    "where_in": "select id from a where k in (select k from b)",
    "in_empty_build": """select id, k in (select k from b where w > 999)
                         from a""",
    "in_correlated": """select id, v in (select w from b where b.k = a.k)
                        from a""",
    "not_in_correlated": """select id from a where v not in
                            (select w from b where b.k = a.k)""",
    "in_correlated_two_keys": """select id, v in (select w from b
                                 where b.k = a.k and b.s = a.s) from a""",
    "two_keys": """select a.id, b.id from a join b
                   on a.k = b.k and a.s = b.s""",
    "three_keys": """select a.id, b.id from a join b
                     on a.k = b.k and a.s = b.s and a.v = b.w""",
    "two_keys_left": """select a.id, b.id from a left join b
                        on a.k = b.k and a.v = b.w""",
    "two_keys_full": """select a.id, b.id from a full join b
                        on a.s = b.s and a.k = b.k""",
    "float_keys": "select fa.id, fb.id from fa join fb on fa.x = fb.x",
    "float_keys_full": """select fa.id, fb.id, fa.x from fa full join fb
                          on fa.x = fb.x""",
    "range_lt": "select a.id, b.id from a join b on a.v < b.w",
    "range_le": "select a.id, b.id from a join b on a.v <= b.w",
    "range_gt": "select a.id, b.id from a join b on a.v > b.w",
    "range_ge": "select a.id, b.id from a join b on a.v >= b.w",
    "range_left": "select a.id, b.id from a left join b on a.v > b.w",
    "range_full": "select a.id, b.id from a full join b on a.v < b.w",
    "range_floats": "select fa.id, fb.id from fa join fb on fa.x < fb.x",
    "asof_ge": """select t, px, bid from trades asof join quotes
                  on trades.sym = quotes.sym and trades.t >= quotes.qt""",
    "asof_gt": """select t, px, bid from trades asof join quotes
                  on trades.sym = quotes.sym and trades.t > quotes.qt""",
    "asof_le": """select t, px, qt from trades asof join quotes
                  on trades.sym = quotes.sym and trades.t <= quotes.qt""",
    "asof_lt": """select t, px, qt from trades asof join quotes
                  on trades.sym = quotes.sym and trades.t < quotes.qt""",
    "asof_left": """select t, px, bid from trades asof left join quotes
                    on trades.sym = quotes.sym and trades.t >= quotes.qt""",
    "asof_no_key": """select t, qt from trades asof join quotes
                      on trades.t >= quotes.qt""",
    "cross": "select a.id, b.id from a cross join b",
    "cross_filtered": """select a.id, bn.k from a, bn
                         where a.v > 20 and bn.w < 50""",
    "positional": "select * from a positional join b",
    "positional_filtered": """select * from (select id from a where v > 20)
                              positional join (select k, w from bn) r""",
    "nl_left": "select a.id, b.id from a left join b on a.v + b.w = 80",
    "nl_right": "select a.id, b.id from a right join b on a.v + b.w = 80",
    "nl_full": """select a.id, b.id from a full join b
                  on a.v < b.w or a.k = b.k""",
    "empty_build": """select a.id, e.id from a join
                      (select * from b where w > 999) e on a.k = e.k""",
    "empty_build_left": """select a.id, e.id from a left join
                           (select * from b where w > 999) e
                           on a.k = e.k""",
    "empty_probe_right": """select e.id, b.id from
                            (select * from a where v > 999) e
                            right join b on e.k = b.k""",
    "empty_both_full": """select e.id, f.id from
                          (select * from a where v > 999) e full join
                          (select * from b where w > 999) f on e.k = f.k""",
    "empty_anti": """select id from a where not exists
                     (select 1 from b where b.k = a.k and b.w > 999)""",
    "sparse_sides_recompact": """select x.id, y.id from
                                 (select * from big where id >= 37) x join
                                 (select * from big where id < 2) y
                                 on x.k - 2 = y.k""",
    "union_all": "select k, v from a union all select k, w from b",
    "union_all_ordered": """select k from a where k is not null
                            union all select k from bn order by k""",
}

_KEEPS_ORDER = {"inner_limit_keeps_join_order"}


@pytest.fixture(scope="module")
def cons():
    ref = ddb_tpu.connect()
    port = ddb_tpu_torch.connect(device="cpu")
    for name, data in TABLES.items():
        ref.register(name, data)
        port.register(name, data)
    return ref, port


def _key(row):
    return tuple((v is None, 0 if v is None else v) for v in row)


def _same_rows(want, got):
    assert len(want) == len(got)
    for rw, rg in zip(want, got):
        assert len(rw) == len(rg)
        for w, g in zip(rw, rg):
            if isinstance(w, float):
                assert isinstance(g, float)
                assert (math.isnan(w) and math.isnan(g)) or \
                    math.isclose(w, g, rel_tol=RTOL, abs_tol=0.0), (w, g)
            else:
                assert type(w) is type(g) and w == g, (rw, rg)


@pytest.mark.parametrize("name", list(CORPUS))
def test_join_sql_matches_reference(cons, name):
    ref, port = cons
    sql = CORPUS[name]
    want = ref.execute(sql).fetchall()
    res = port.execute(sql)
    got = res.fetchall()
    assert res.column_names == ref.execute(sql).column_names
    if "order by" not in sql and name not in _KEEPS_ORDER:
        want, got = sorted(want, key=_key), sorted(got, key=_key)
    _same_rows(want, got)


def _nodes(plan):
    yield plan
    for attr in ("child", "left", "right"):
        c = getattr(plan, attr, None)
        if isinstance(c, L.LogicalNode):
            yield from _nodes(c)


def _plan(port, sql):
    port.execute(sql)
    return list(_nodes(port._plan_cache[sql][1]))


@pytest.mark.parametrize("name,want", [
    ("left", lambda n: isinstance(n, L.Join) and n.join_type == "left"),
    ("full_residual", lambda n: isinstance(n, L.Join)
     and n.join_type == "full" and n.extra is not None),
    ("exists_residual", lambda n: isinstance(n, L.Join)
     and n.join_type == "semi" and n.extra is not None),
    ("in_mark_nulls", lambda n: isinstance(n, L.Join)
     and n.join_type == "mark" and n.mark_in),
    ("in_correlated", lambda n: isinstance(n, L.Join)
     and n.join_type == "mark" and len(n.conds) == 2),
    ("three_keys", lambda n: isinstance(n, L.Join) and len(n.conds) == 3),
    ("range_lt", lambda n: isinstance(n, L.Join) and not n.conds
     and n.range_cond is not None and not n.asof),
    ("asof_lt", lambda n: isinstance(n, L.Join) and n.asof
     and n.range_cond[1] == "<"),
    ("cross", lambda n: isinstance(n, L.CrossProduct)),
    ("positional", lambda n: isinstance(n, L.Positional)),
    ("nl_full", lambda n: isinstance(n, L.Join) and not n.conds
     and n.range_cond is None and n.extra is not None),
    ("union_all", lambda n: isinstance(n, L.Union)),
])
def test_corpus_reaches_the_plan_node(cons, name, want):
    """The statements above are only worth their names while the binder
    and optimizer turn them into the plan nodes they are meant to reach."""
    _, port = cons
    assert any(want(n) for n in _plan(port, CORPUS[name])), name
