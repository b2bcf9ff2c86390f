"""The generators keep their sources' rules, and hand the program the
Arrow types a user would."""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from portbench import columns
from portbench.generators import h2oai, tpch

SMALL = {"scale_factor": 0.02, "text_pool_bytes": 4096}
# TPC-H's columns (clause 1.4.1), table by table
SPEC_COLUMNS = {
    "region": 3, "nation": 4, "part": 9, "supplier": 7, "partsupp": 5,
    "customer": 8, "orders": 9, "lineitem": 16}


def test_tpch_returnflag_and_linestatus_follow_4_2_3():
    li = tpch.generate(SMALL, 42)["lineitem"]
    flag = np.array(tpch.RETURNFLAGS)[li["l_returnflag"]]
    status = np.array(tpch.LINESTATUSES)[li["l_linestatus"]]
    received = li["l_receiptdate"] <= tpch.CURRENTDATE
    assert set(flag[received]) == {"A", "R"}
    assert set(flag[~received]) == {"N"}
    shipped_after = li["l_shipdate"] > tpch.CURRENTDATE
    assert set(status[shipped_after]) == {"O"}
    assert set(status[~shipped_after]) == {"F"}
    # so Q1 sees TPC-H's four groups, not six
    assert set(zip(flag, status)) == {("A", "F"), ("N", "F"), ("N", "O"),
                                      ("R", "F")}


def test_tpch_columns_keep_their_ranges_and_key_shapes():
    t = tpch.generate(SMALL, 7)
    o, li, c = t["orders"], t["lineitem"], t["customer"]
    assert np.all((o["o_orderkey"] - 1) % 32 < 8)
    assert np.all(o["o_custkey"] % 3 != 0)
    assert o["o_custkey"].max() <= 3000
    assert len(c["c_custkey"]) == 3000 and len(o["o_orderkey"]) == 30000
    lines = np.bincount(np.searchsorted(o["o_orderkey"], li["l_orderkey"]))
    assert lines.min() == 1 and lines.max() == 7
    odate = o["o_orderdate"][np.searchsorted(o["o_orderkey"],
                                             li["l_orderkey"])]
    assert odate.min() >= tpch.days("1992-01-01")
    assert odate.max() <= tpch.days("1998-08-02")
    assert np.all((li["l_shipdate"] - odate >= 1)
                  & (li["l_shipdate"] - odate <= 121))
    assert np.all((li["l_commitdate"] - odate >= 30)
                  & (li["l_commitdate"] - odate <= 90))
    gap = li["l_receiptdate"] - li["l_shipdate"]
    assert gap.min() == 1 and gap.max() == 30
    assert li["l_quantity"].min() == 100 and li["l_quantity"].max() == 5000
    assert li["l_discount"].max() == 10 and li["l_tax"].max() == 8
    price = li["l_extendedprice"] // (li["l_quantity"] // 100)
    assert np.array_equal(li["l_extendedprice"] % (li["l_quantity"] // 100),
                          np.zeros_like(price))
    assert np.array_equal(price, t["part"]["p_retailprice"][
        li["l_partkey"] - 1])
    assert price.min() >= 90000 and price.max() <= 209900


def test_tpch_has_every_table_and_column_at_its_scale():
    t = tpch.generate(SMALL, 11)
    assert {k: len(v) for k, v in t.items()} == SPEC_COLUMNS
    assert {k: set(v) for k, v in t.items()} == {
        k: set(v) for k, v in tpch.KINDS.items()}
    rows = {k: len(next(iter(v.values()))) for k, v in t.items()}
    assert rows["part"] == 4000 and rows["supplier"] == 200
    assert rows["partsupp"] == 16000 and rows["nation"] == 25
    for name, cols in t.items():
        assert {len(v) for v in cols.values()} == {rows[name]}, name


def test_tpch_suppliers_totals_and_statuses_follow_4_2_3():
    t = tpch.generate(SMALL, 12)
    ps, li, o = t["partsupp"], t["lineitem"], t["orders"]
    pairs = set(zip(ps["ps_partkey"].tolist(), ps["ps_suppkey"].tolist()))
    assert len(pairs) == len(ps["ps_partkey"])       # four distinct a part
    assert set(zip(li["l_partkey"].tolist(),
                   li["l_suppkey"].tolist())) <= pairs
    at = np.searchsorted(o["o_orderkey"], li["l_orderkey"])
    assert np.array_equal(np.bincount(at), li["l_linenumber"][
        np.r_[np.flatnonzero(np.diff(at)), len(at) - 1]])
    charge = (li["l_extendedprice"] * (100 - li["l_discount"]) // 100
              * (100 + li["l_tax"]) // 100)
    assert np.array_equal(np.bincount(at, charge).astype(np.int64),
                          o["o_totalprice"])
    open_share = np.bincount(at, li["l_linestatus"]) / np.bincount(at)
    status = np.array(tpch.ORDERSTATUSES)[o["o_orderstatus"]]
    assert set(status[open_share == 0]) == {"F"}
    assert set(status[open_share == 1]) == {"O"}
    assert set(status[(open_share > 0) & (open_share < 1)]) == {"P"}


def test_tpch_strings_keep_the_specs_formats_and_lengths():
    t = tpch.generate(SMALL, 13)
    c, s, p = t["customer"], t["supplier"], t["part"]
    assert c["c_name"][4].as_py() == "Customer#000000005"
    assert s["s_name"][0].as_py() == "Supplier#000000001"
    assert len(pc.unique(c["c_name"].cast(pa.string()))) == 3000
    phone = c["c_phone"][7].as_py()
    assert phone[:2] == str(c["c_nationkey"][7] + 10) and len(phone) == 15
    words = [n.as_py().split() for n in p["p_name"].cast(pa.string())]
    assert all(len(set(w)) == 5 and set(w) <= set(tpch.COLORS)
               for w in words)
    pool = bytes(tpch.text_pool(tpch.seed_rng(0), 64)).decode()
    assert set(pool.split()) <= set(tpch.WORDS)
    for table in t.values():
        for name, values in table.items():
            if name not in tpch.COMMENT_LENGTHS:
                continue
            lo, hi = tpch.COMMENT_LENGTHS[name]
            size = pc.utf8_length(values.cast(pa.string()))
            assert pc.min(size).as_py() >= lo, name
            assert pc.max(size).as_py() <= hi, name
    addr = pc.utf8_length(c["c_address"].cast(pa.string()))
    assert pc.min(addr).as_py() >= 10 and pc.max(addr).as_py() <= 40


def test_tpch_comments_are_substrings_of_the_pool():
    rng = tpch.seed_rng(4)
    pool = tpch.text_pool(rng, 512)
    col = tpch.comments(rng, pool, 5000, 10, 43, chunk=64)
    ring = bytes(pool) + bytes(pool[:43])
    values = col.cast(pa.string()).to_pylist()
    assert all(v.encode() in ring for v in values)
    # the dictionary holds the drawn substrings, each once
    used = np.unique(np.asarray(col.indices))
    assert np.array_equal(used, np.arange(len(col.dictionary)))
    assert len(col.dictionary) <= 512 * 34


def test_a_seed_gives_the_same_tables_any_size_of_seed():
    for seed in (0, 2**31 + 9, 2**40, -17):
        a, b = tpch.generate(SMALL, seed), tpch.generate(SMALL, seed)
        assert all(np.array_equal(a[t][c], b[t][c])
                   for t in a for c in a[t])
    a, b = tpch.generate(SMALL, 1), tpch.generate(SMALL, 2)
    assert not np.array_equal(a["lineitem"]["l_shipdate"][:100],
                              b["lineitem"]["l_shipdate"][:100])


def test_h2oai_is_generate_scale_with_id_codes():
    cfg = {"rows": 10_000, "k": 10}
    cols = h2oai.generate(cfg, 108)["x_group"]
    raw = h2oai.generate_scale(10_000, 10, 108)
    for name in ("id1", "id2", "id3"):
        assert np.array_equal(cols[name], raw[name] - 1)
    assert raw["id1"].min() == 1 and raw["id1"].max() == 10
    assert raw["id3"].max() == 1000 and raw["id6"].max() == 1000
    assert np.array_equal(np.round(raw["v3"], 6), raw["v3"])
    labels = h2oai.kinds(cfg)["x_group"]["id3"][1]
    assert labels[0] == "id0000000001" and len(labels) == 1000


def test_arrow_types_are_a_users():
    kinds = tpch.KINDS["lineitem"]
    li = tpch.generate(SMALL, 3)["lineitem"]
    t = columns.arrow_table(li, kinds)
    assert t.schema.field("l_comment").type == pa.dictionary(
        pa.int32(), pa.string())
    assert t.schema.field("l_returnflag").type == pa.dictionary(
        pa.int32(), pa.string())
    assert t.schema.field("l_extendedprice").type == pa.decimal128(15, 2)
    assert t.schema.field("l_shipdate").type == pa.date32()
    assert t.column("l_extendedprice").to_pylist()[0] * 100 == int(
        li["l_extendedprice"][0])
    assert t.column("l_returnflag").to_pylist()[:3] == [
        tpch.RETURNFLAGS[i] for i in li["l_returnflag"][:3]]
