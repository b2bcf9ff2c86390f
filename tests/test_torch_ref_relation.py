# Generated from tests/test_relation.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite relation); do not edit.
"""Lazy Relation (dataframe) API (reference: src/main/relation/,
src/include/duckdb/main/relation.hpp)."""
from ddb_tpu_torch.testing import refsuite
import ddb_tpu_torch


def base(con):
    con.execute("CREATE TABLE t(g VARCHAR, v INTEGER)")
    con.execute("INSERT INTO t VALUES ('a',1),('b',2),('a',3),('c',4)")


def test_table_filter_aggregate():
    con = refsuite.connect()
    base(con)
    rel = con.table("t").filter("v > 1").aggregate("g, sum(v)", "g") \
        .order("g")
    assert rel.fetchall() == [("a", 3), ("b", 2), ("c", 4)]


def test_lazy_no_execution_until_fetch():
    con = refsuite.connect()
    base(con)
    rel = con.table("t").filter("v > 1")
    con.execute("INSERT INTO t VALUES ('d', 100)")
    # lazily sees the new row
    assert ("d", 100) in rel.fetchall()


def test_project_limit_distinct():
    con = refsuite.connect()
    base(con)
    assert con.table("t").project("g").distinct().order("g") \
        .fetchall() == [("a",), ("b",), ("c",)]
    assert len(con.table("t").order("v").limit(2).fetchall()) == 2
    assert con.table("t").order("v desc").limit(1, offset=1) \
        .fetchall() == [("a", 3)]


def test_join():
    con = refsuite.connect()
    base(con)
    con.execute("CREATE TABLE u(g VARCHAR, w INTEGER)")
    con.execute("INSERT INTO u VALUES ('a', 10), ('b', 20)")
    rel = con.table("t").join(con.table("u"), "g").order("v")
    rows = rel.fetchall()
    assert ("a", 1, 10) in rows and ("b", 2, 20) in rows
    left = con.table("t").join(con.table("u"), "g", how="left")
    assert len(left.fetchall()) == 4


def test_setops_and_count():
    con = refsuite.connect()
    base(con)
    a = con.table("t").filter("v <= 2")
    b = con.table("t").filter("v >= 2")
    assert a.union(b).count().fetchall() == [(5,)]   # UNION ALL
    assert a.union(b, all_=False).count().fetchall() == [(4,)]
    assert sorted(a.intersect(b).fetchall()) == [("b", 2)]
    assert sorted(a.except_(b).fetchall()) == [("a", 1)]


def test_columns_types_sql():
    con = refsuite.connect()
    base(con)
    rel = con.table("t")
    assert rel.columns == ["g", "v"]
    assert rel.types == ["VARCHAR", "INTEGER"]
    assert "SELECT" in rel.sql_query().upper()


def test_create_and_insert():
    con = refsuite.connect()
    base(con)
    con.table("t").filter("v > 2").create("big")
    assert con.execute("SELECT count(*) FROM big").fetchall() == [(2,)]
    con.table("t").filter("v = 1").insert_into("big")
    assert con.execute("SELECT count(*) FROM big").fetchall() == [(3,)]
    v = con.table("t").aggregate("max(v)").create_view("mv")
    assert v.fetchall() == [(4,)]


def test_values_and_sql_relation():
    con = refsuite.connect()
    rel = con.values([(1, "x"), (2, "y")], columns=["n", "s"])
    assert rel.order("n").fetchall() == [(1, "x"), (2, "y")]
    assert rel.columns == ["n", "s"]
    r2 = con.sql("SELECT 41 + 1 AS answer")
    assert r2.fetchall() == [(42,)]
    assert r2.columns == ["answer"]


def test_aggregate_shorthands():
    con = refsuite.connect()
    base(con)
    t = con.table("t")
    assert t.sum("v").fetchall() == [(10,)]
    assert t.min("v").fetchall() == [(1,)]
    assert t.max("v").fetchall() == [(4,)]
    assert t.count().fetchall() == [(4,)]
    vc = dict(t.value_counts("g").fetchall())
    assert vc == {"a": 2, "b": 1, "c": 1}


def test_df_and_map():
    pd = __import__("pandas")
    con = refsuite.connect()
    base(con)
    df = con.table("t").order("v").df()
    assert list(df.columns) == ["g", "v"]
    assert df["v"].tolist() == [1, 2, 3, 4]
    rel2 = con.from_df(pd.DataFrame({"x": [5, 6]}))
    assert rel2.sum("x").fetchall() == [(11,)]
    doubled = con.table("t").map(
        lambda d: d.assign(v=d["v"] * 2))
    assert doubled.sum("v").fetchall() == [(20,)]


def test_chain_deep():
    con = refsuite.connect()
    base(con)
    out = (con.table("t")
           .filter("v >= 1")
           .project("g", "v * 10 AS v10")
           .filter("v10 < 40")
           .aggregate("g, count(*) AS n", "g")
           .order("n DESC, g")
           .limit(2)
           .fetchall())
    assert out == [("a", 2), ("b", 1)]
