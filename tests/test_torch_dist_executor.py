"""ddb_tpu_torch.parallel.executor over eight shards on the CPU against the
reference's single-device executor.

Every statement of tests/test_dist_executor.py, over the same seeded
tables, runs through the port's `execute_distributed` on
`Mesh([cpu] * 8)` and through `ddb_tpu.connect().execute`.  The rows
compare as the reference's tests compare them: sorted, or in order where
the statement orders them.  The reference's own distributed executor is
not called here (its shard_map programs compile for minutes on the CPU).
"""

import numpy as np
import pytest
import torch

import ddb_tpu
import ddb_tpu_torch
from ddb_tpu_torch.api import QueryResult
from ddb_tpu_torch.batch import bind_device
from ddb_tpu_torch.parallel import executor as EX
from ddb_tpu_torch.parallel.mesh import Mesh
from ddb_tpu_torch.sql import parser as sqlparser
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def mesh():
    return Mesh([CPU] * 8)


def _pair(tables):
    ref, port = ddb_tpu.connect(), ddb_tpu_torch.connect(device="cpu")
    for name, cols in tables.items():
        ref.register(name, cols)
        port.register(name, cols)
    return ref, port


def _fact_dim():
    rng = np.random.default_rng(5)
    n = 5000
    return {"fact": {"k": rng.integers(0, 200, n),
                     "g": rng.integers(0, 8, n),
                     "v": rng.integers(1, 100, n)},
            "dim": {"k": np.arange(0, 150),
                    "w": rng.integers(1, 10, 150)}}


def _lf_rt():
    """Tables with NULL join keys, for the outer and mark joins."""
    rng = np.random.default_rng(11)
    n = 3000
    k = rng.integers(0, 120, n).astype(float)
    k[rng.random(n) < 0.1] = np.nan
    rk = list(range(0, 90)) + [None, None]
    return {"lf": {"k": [None if np.isnan(x) else int(x) for x in k],
                   "g": rng.integers(0, 6, n),
                   "v": rng.integers(1, 50, n)},
            "rt": {"k": rk, "w": list(rng.integers(1, 9, len(rk)))}}


@pytest.fixture(scope="module")
def con():
    return _pair(_fact_dim())


@pytest.fixture(scope="module")
def ncon():
    return _pair(_lf_rt())


def dist_plan(port, sql):
    with bind_device(port.device):
        return port._optimize(
            port._binder().bind_select(sqlparser.parse(sql)[0]))


def run_both(pair, mesh, sql):
    ref, port = pair
    schema, batch = EX.execute_distributed(dist_plan(port, sql), mesh)
    return QueryResult(schema, batch).fetchall(), ref.execute(sql).fetchall()


def _norm(rows):
    return sorted(map(repr, rows))


# (reference test name, tables, statement), compared as sorted rows
SORTED = [
    ("groupby", "con", "SELECT g, sum(v), count(*), min(v), max(v), avg(v) "
                       "FROM fact GROUP BY g"),
    ("groupby_highcard", "con", "SELECT k, sum(v) FROM fact GROUP BY k"),
    ("filter_agg", "con",
     "SELECT g, sum(v) FROM fact WHERE v > 50 GROUP BY g"),
    ("ungrouped", "con", "SELECT count(*), sum(v), min(k) FROM fact"),
    ("join", "con", "SELECT fact.k, v, w FROM fact JOIN dim "
                    "ON fact.k = dim.k WHERE v < 10"),
    ("join_agg_pipeline", "con", "SELECT g, sum(v * w) FROM fact JOIN dim "
                                 "ON fact.k = dim.k GROUP BY g"),
    ("semi_join", "con", "SELECT count(*) FROM fact WHERE k IN "
                         "(SELECT k FROM dim)"),
    ("left_join", "ncon", "SELECT lf.k, v, w FROM lf LEFT JOIN rt "
                          "ON lf.k = rt.k"),
    ("right_join", "ncon", "SELECT lf.k, v, rt.k, w FROM lf RIGHT JOIN rt "
                           "ON lf.k = rt.k"),
    ("full_join", "ncon", "SELECT lf.k, v, rt.k, w FROM lf FULL JOIN rt "
                          "ON lf.k = rt.k"),
    ("anti_join_nulls", "ncon", "SELECT count(*) FROM lf WHERE NOT EXISTS "
                                "(SELECT 1 FROM rt WHERE rt.k = lf.k)"),
    # three-valued NOT IN over a build side holding NULLs
    ("mark_join_not_in", "ncon", "SELECT count(*) FROM lf WHERE k NOT IN "
                                 "(SELECT k FROM rt WHERE k < 40)"),
    ("multi_cond_join", "con", "SELECT fact.k, v, w FROM fact JOIN dim "
                               "ON fact.k = dim.k AND fact.g = dim.w"),
    ("join_residual", "con", "SELECT fact.k, v, w FROM fact JOIN dim "
                             "ON fact.k = dim.k AND v > w * 3"),
    ("distinct", "con", "SELECT DISTINCT g FROM fact"),
    ("distinct_aggregates", "con", "SELECT g, count(DISTINCT v), "
                                   "sum(DISTINCT v) FROM fact GROUP BY g"),
    ("median_quantile", "con", "SELECT g, median(v), quantile_disc(v, 0.25) "
                               "FROM fact GROUP BY g"),
    # unique BY values (v*1000+k) make the arg extrema deterministic
    ("arg_minmax_mode", "con", "SELECT g, arg_max(k, v*1000+k), "
                               "arg_min(k, v*1000+k), mode(v) "
                               "FROM fact GROUP BY g"),
    ("mixed_plain_and_distinct", "con", "SELECT g, sum(v), "
                                        "count(DISTINCT k), avg(v) "
                                        "FROM fact GROUP BY g"),
    ("window_partitioned", "con", "SELECT k, v, row_number() OVER "
                                  "(PARTITION BY g ORDER BY v, k), "
                                  "sum(v) OVER (PARTITION BY g) FROM fact"),
    ("window_rank_lag", "con", "SELECT g, v, rank() OVER w, lag(v) OVER w "
                               "FROM fact WINDOW w AS "
                               "(PARTITION BY g ORDER BY v, k)"),
]

# compared in order
ORDERED = [
    ("order_fallback", "con", "SELECT g, sum(v) AS sv FROM fact GROUP BY g "
                              "ORDER BY sv DESC LIMIT 3"),
    ("order_distributed", "con",
     "SELECT k, g, v FROM fact ORDER BY v DESC, k, g"),
    ("order_nulls", "ncon", "SELECT k, v FROM lf ORDER BY k NULLS FIRST, v"),
    ("topn", "con", "SELECT k, v FROM fact ORDER BY v DESC, k LIMIT 7"),
    ("topn_offset", "con",
     "SELECT k, v FROM fact ORDER BY v, k LIMIT 5 OFFSET 3"),
    # above the optimizer's TOPN_MAX the plan keeps Limit(Order): each
    # shard keeps its local top, or (above 2^16) the Order gathers
    ("limit_order_local_tops", "con",
     "SELECT k, v FROM fact ORDER BY v DESC, k LIMIT 20000 OFFSET 4990"),
    ("limit_order_gathered", "con",
     "SELECT k, v FROM fact ORDER BY v, k LIMIT 70000 OFFSET 4000"),
]


@pytest.mark.parametrize("name,tables,sql", SORTED,
                         ids=[c[0] for c in SORTED])
def test_dist_statement_matches_reference(request, mesh, name, tables, sql):
    d, s = run_both(request.getfixturevalue(tables), mesh, sql)
    assert _norm(d) == _norm(s)


@pytest.mark.parametrize("name,tables,sql", ORDERED,
                         ids=[c[0] for c in ORDERED])
def test_dist_ordered_statement_matches_reference(request, mesh, name,
                                                  tables, sql):
    d, s = run_both(request.getfixturevalue(tables), mesh, sql)
    assert d == s


def test_dist_no_gather_for_joins_order(con, mesh, monkeypatch):
    """Joins and ORDER BY run without the gathered fallback."""
    calls = []
    orig = EX._exec_gathered

    def spy(node, ctx):
        calls.append(type(node).__name__)
        return orig(node, ctx)

    monkeypatch.setattr(EX, "_exec_gathered", spy)
    d, s = run_both(con, mesh, "SELECT fact.k, v, w FROM fact LEFT JOIN dim "
                               "ON fact.k = dim.k ORDER BY v, fact.k, w")
    assert "Join" not in calls and "Order" not in calls
    assert d == s


def test_exchange_overflow_retry_on_skew(mesh):
    """One dominant key overflows a shard's first exchange capacity: the
    doubling retry fires and the rows stay exact."""
    n = 4096
    g = np.where(np.arange(n) < n - 64, 7, np.arange(n) % 50)
    pair = _pair({"skew_t": {"g": g, "v": np.arange(n)}})
    sql = "select g, count(distinct v) from skew_t group by g"
    before = EX.STATS["exchange_retries"]
    d, s = run_both(pair, mesh, sql)
    assert EX.STATS["exchange_retries"] > before
    assert EX.STATS["exchange_overflow_rows"] > 0
    assert sorted(d) == sorted(s)


def test_dist_plain_limit(con, mesh):
    # LIMIT/OFFSET without ORDER BY stays sharded: a global prefix count
    # from an all_gather of the per-shard totals
    d, s = run_both(con, mesh, "SELECT k, v FROM fact LIMIT 37")
    assert len(d) == len(s) == 37
    d, s = run_both(con, mesh,
                    "SELECT k FROM fact WHERE v > 50 LIMIT 100000")
    assert len(d) == len(s)
    d, s = run_both(con, mesh, "SELECT k FROM fact LIMIT 10 OFFSET 25")
    assert len(d) == len(s) == 10
    d, s = run_both(con, mesh, "SELECT count(*) FROM (SELECT k FROM fact "
                               "LIMIT 4990 OFFSET 5)")
    assert d == s == [(4990,)]


def test_plain_limit_keeps_the_sharded_row_order(con, mesh):
    """Shard i holds rows [i*cap/8, (i+1)*cap/8) of the table, and the
    gather is shard-major: a LIMIT/OFFSET without ORDER BY takes the
    table's own rows, those the single-device executor takes."""
    for sql in ("SELECT k, v FROM fact LIMIT 37",
                "SELECT k FROM fact WHERE v > 50 LIMIT 40 OFFSET 600"):
        d, s = run_both(con, mesh, sql)
        assert d == s


def test_use_mesh_routes_every_select(con, mesh, monkeypatch):
    _, port = con
    calls = []
    orig = EX.execute_distributed

    def spy(plan, m):
        calls.append(m)
        return orig(plan, m)

    monkeypatch.setattr(EX, "execute_distributed", spy)
    want = port.execute("SELECT g, sum(v) FROM fact GROUP BY g").fetchall()
    try:
        port.use_mesh(mesh)
        got = port.execute("SELECT g, sum(v) FROM fact GROUP BY g")
        assert calls == [mesh]
        assert sorted(got.fetchall()) == sorted(want)
    finally:
        port.use_mesh(None)


def test_use_mesh_falls_back_on_not_implemented(con, mesh, monkeypatch):
    _, port = con

    def refuse(plan, m):
        raise NotImplementedError("refused")

    monkeypatch.setattr(EX, "execute_distributed", refuse)
    try:
        port.use_mesh(mesh)
        assert port.execute("SELECT count(*) FROM fact").fetchall() \
            == [(5000,)]
    finally:
        port.use_mesh(None)


def test_a_gathered_aggregate_runs_its_child_once(con, mesh, monkeypatch):
    """stddev is not a mergeable kind, so the aggregate gathers.  The
    reference executes the child distributed and then again inside its
    gathered fallback (ROADMAP fault 3.17); the port decides first and
    scans the table once."""
    scans = []
    orig = EX._exec_get
    monkeypatch.setattr(EX, "_exec_get",
                        lambda node, ctx: scans.append(node) or orig(node,
                                                                     ctx))
    d, s = run_both(con, mesh,
                    "SELECT g, stddev(v) FROM fact GROUP BY g")
    assert len(scans) == 1
    assert len(d) == len(s) == 8
    for (g, x), (h, y) in zip(sorted(d), sorted(s)):
        assert g == h and x == pytest.approx(y, rel=1e-12)


def test_an_operator_filling_a_runtime_dictionary_gathers(con, mesh,
                                                          monkeypatch):
    """A Python function returning VARCHAR fills its output dictionary
    on the host each time it is evaluated: shard by shard, every shard
    would refill it.  The operators holding one gather, and the rows are
    the single-device executor's."""
    _, port = con
    port.create_function("tag", lambda x: f"k{x % 7}", "VARCHAR")
    gathered = []
    orig = EX._exec_gathered
    monkeypatch.setattr(EX, "_exec_gathered",
                        lambda node, ctx: gathered.append(
                            type(node).__name__) or orig(node, ctx))
    rows = {}
    for sql in ("SELECT tag(v), k FROM fact WHERE g = 3",
                "SELECT g, max(tag(k)), min(tag(v)) FROM fact GROUP BY g"):
        schema, batch = EX.execute_distributed(dist_plan(port, sql), mesh)
        rows[sql] = QueryResult(schema, batch).fetchall()
        assert sorted(rows[sql]) == sorted(port.execute(sql).fetchall())
    assert gathered == ["Project", "Aggregate"]
    assert len({t for t, _ in rows["SELECT tag(v), k FROM fact WHERE g = 3"]}) \
        == 7
