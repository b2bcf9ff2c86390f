"""TPC-H helpers: schema, queries, data loading/synthesis.

Real data comes from the reference's dbgen (`.tbl` pipe-separated files,
reference: extension/tpch/dbgen/); when unavailable, `synth_lineitem`
makes a distribution-faithful synthetic lineitem for throughput benches
(correctness runs always use real dbgen data + the reference answer sets
under extension/tpch/dbgen/answers/).
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional

import numpy as np

TPCH_QUERIES: Dict[int, str] = {}

TPCH_QUERIES[1] = """
select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
       sum(l_extendedprice) as sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
       avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
       avg(l_discount) as avg_disc, count(*) as count_order
from lineitem
where l_shipdate <= date '1998-09-02'
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""

TPCH_QUERIES[6] = """
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1995-01-01'
  and l_discount between 0.05 and 0.07
  and l_quantity < 24
"""

TPCH_QUERIES[3] = """
select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
       o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
  and l_orderkey = o_orderkey and o_orderdate < date '1995-03-15'
  and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10
"""

TPCH_QUERIES[4] = """
select o_orderpriority, count(*) as order_count
from orders
where o_orderdate >= date '1993-07-01'
  and o_orderdate < date '1993-10-01'
  and exists (select * from lineitem where l_orderkey = o_orderkey
              and l_commitdate < l_receiptdate)
group by o_orderpriority
order by o_orderpriority
"""

TPCH_QUERIES[5] = """
select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue
from customer, orders, lineitem, supplier, nation, region
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and l_suppkey = s_suppkey and c_nationkey = s_nationkey
  and s_nationkey = n_nationkey and n_regionkey = r_regionkey
  and r_name = 'ASIA' and o_orderdate >= date '1994-01-01'
  and o_orderdate < date '1995-01-01'
group by n_name
order by revenue desc
"""

TPCH_QUERIES[6] = TPCH_QUERIES[6]

TPCH_QUERIES[10] = """
select c_custkey, c_name, sum(l_extendedprice * (1 - l_discount)) as revenue,
       c_acctbal, n_name, c_address, c_phone, c_comment
from customer, orders, lineitem, nation
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and o_orderdate >= date '1993-10-01' and o_orderdate < date '1994-01-01'
  and l_returnflag = 'R' and c_nationkey = n_nationkey
group by c_custkey, c_name, c_acctbal, c_phone, n_name, c_address, c_comment
order by revenue desc
limit 20
"""

TPCH_QUERIES[12] = """
select l_shipmode,
       sum(case when o_orderpriority = '1-URGENT'
                  or o_orderpriority = '2-HIGH' then 1 else 0 end)
         as high_line_count,
       sum(case when o_orderpriority <> '1-URGENT'
                 and o_orderpriority <> '2-HIGH' then 1 else 0 end)
         as low_line_count
from orders, lineitem
where o_orderkey = l_orderkey and l_shipmode in ('MAIL', 'SHIP')
  and l_commitdate < l_receiptdate and l_shipdate < l_commitdate
  and l_receiptdate >= date '1994-01-01'
  and l_receiptdate < date '1995-01-01'
group by l_shipmode
order by l_shipmode
"""

TPCH_QUERIES[14] = """
select 100.00 * sum(case when p_type like 'PROMO%'
                         then l_extendedprice * (1 - l_discount)
                         else 0 end)
       / sum(l_extendedprice * (1 - l_discount)) as promo_revenue
from lineitem, part
where l_partkey = p_partkey and l_shipdate >= date '1995-09-01'
  and l_shipdate < date '1995-10-01'
"""

TPCH_QUERIES[19] = """
select sum(l_extendedprice * (1 - l_discount)) as revenue
from lineitem, part
where (p_partkey = l_partkey and p_brand = 'Brand#12'
  and p_container in ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
  and l_quantity >= 1 and l_quantity <= 1 + 10
  and p_size between 1 and 5
  and l_shipmode in ('AIR', 'AIR REG')
  and l_shipinstruct = 'DELIVER IN PERSON')
  or (p_partkey = l_partkey and p_brand = 'Brand#23'
  and p_container in ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
  and l_quantity >= 10 and l_quantity <= 10 + 10
  and p_size between 1 and 10
  and l_shipmode in ('AIR', 'AIR REG')
  and l_shipinstruct = 'DELIVER IN PERSON')
  or (p_partkey = l_partkey and p_brand = 'Brand#34'
  and p_container in ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
  and l_quantity >= 20 and l_quantity <= 20 + 10
  and p_size between 1 and 15
  and l_shipmode in ('AIR', 'AIR REG')
  and l_shipinstruct = 'DELIVER IN PERSON')
"""

_EPOCH = datetime.date(1970, 1, 1)


def _days(y, m, d):
    return (datetime.date(y, m, d) - _EPOCH).days


def synth_lineitem(n_rows: int, seed: int = 42):
    """Distribution-faithful synthetic lineitem columns (Q1/Q6 subset),
    decimals as scaled int64, dates as int32 days."""
    rng = np.random.default_rng(seed)
    quantity = rng.integers(1, 51, n_rows).astype(np.int64) * 100
    extended = rng.integers(90000, 10500000, n_rows).astype(np.int64)
    discount = rng.integers(0, 11, n_rows).astype(np.int64)
    tax = rng.integers(0, 9, n_rows).astype(np.int64)
    shipdate = rng.integers(_days(1992, 1, 2), _days(1998, 12, 1),
                            n_rows).astype(np.int32)
    returnflag = rng.integers(0, 3, n_rows).astype(np.int32)   # A N R
    linestatus = rng.integers(0, 2, n_rows).astype(np.int32)   # F O
    return dict(l_quantity=quantity, l_extendedprice=extended,
                l_discount=discount, l_tax=tax, l_shipdate=shipdate,
                l_returnflag=returnflag, l_linestatus=linestatus)


def register_synth_lineitem(con, n_rows: int, seed: int = 42):
    """Register synthetic lineitem into a connection with proper types."""
    from .. import types as T
    from ..storage.strings import StringDictionary
    from ..storage.table import TableColumn, TableData

    d = synth_lineitem(n_rows, seed)
    rf_dict = StringDictionary(np.array(["A", "N", "R"]))
    ls_dict = StringDictionary(np.array(["F", "O"]))
    cols = [
        TableColumn("l_quantity", T.DECIMAL(15, 2), d["l_quantity"]),
        TableColumn("l_extendedprice", T.DECIMAL(15, 2),
                    d["l_extendedprice"]),
        TableColumn("l_discount", T.DECIMAL(15, 2), d["l_discount"]),
        TableColumn("l_tax", T.DECIMAL(15, 2), d["l_tax"]),
        TableColumn("l_shipdate", T.DATE, d["l_shipdate"]),
        TableColumn("l_returnflag", T.VARCHAR, d["l_returnflag"],
                    strdict=rf_dict),
        TableColumn("l_linestatus", T.VARCHAR, d["l_linestatus"],
                    strdict=ls_dict),
    ]
    con.catalog.add_table(TableData("lineitem", cols), or_replace=True)
    return con


# ---------------------------------------------------------------------------
# dbgen .tbl loading (generated by the reference oracle at test time)
# ---------------------------------------------------------------------------

TPCH_SCHEMAS = {
    "lineitem": [
        ("l_orderkey", "int"), ("l_partkey", "int"), ("l_suppkey", "int"),
        ("l_linenumber", "int"), ("l_quantity", "dec2"),
        ("l_extendedprice", "dec2"), ("l_discount", "dec2"),
        ("l_tax", "dec2"), ("l_returnflag", "str"), ("l_linestatus", "str"),
        ("l_shipdate", "date"), ("l_commitdate", "date"),
        ("l_receiptdate", "date"), ("l_shipinstruct", "str"),
        ("l_shipmode", "str"), ("l_comment", "str")],
    "orders": [
        ("o_orderkey", "int"), ("o_custkey", "int"), ("o_orderstatus", "str"),
        ("o_totalprice", "dec2"), ("o_orderdate", "date"),
        ("o_orderpriority", "str"), ("o_clerk", "str"),
        ("o_shippriority", "int"), ("o_comment", "str")],
    "customer": [
        ("c_custkey", "int"), ("c_name", "str"), ("c_address", "str"),
        ("c_nationkey", "int"), ("c_phone", "str"), ("c_acctbal", "dec2"),
        ("c_mktsegment", "str"), ("c_comment", "str")],
    "part": [
        ("p_partkey", "int"), ("p_name", "str"), ("p_mfgr", "str"),
        ("p_brand", "str"), ("p_type", "str"), ("p_size", "int"),
        ("p_container", "str"), ("p_retailprice", "dec2"),
        ("p_comment", "str")],
    "partsupp": [
        ("ps_partkey", "int"), ("ps_suppkey", "int"), ("ps_availqty", "int"),
        ("ps_supplycost", "dec2"), ("ps_comment", "str")],
    "supplier": [
        ("s_suppkey", "int"), ("s_name", "str"), ("s_address", "str"),
        ("s_nationkey", "int"), ("s_phone", "str"), ("s_acctbal", "dec2"),
        ("s_comment", "str")],
    "nation": [
        ("n_nationkey", "int"), ("n_name", "str"), ("n_regionkey", "int"),
        ("n_comment", "str")],
    "region": [
        ("r_regionkey", "int"), ("r_name", "str"), ("r_comment", "str")],
}


def load_tbl(con, table: str, path: str):
    """Load a dbgen-produced pipe-separated file (.tbl or exported .csv)
    with exact types (decimals parsed as decimal128, no float round trip)."""
    import pyarrow as pa
    import pyarrow.csv as pcsv

    from ..storage import table as storage

    schema = TPCH_SCHEMAS[table]
    names = [n for n, _ in schema]
    kindmap = {"int": pa.int32(), "dec2": pa.decimal128(15, 2),
               "date": pa.date32(), "str": pa.string()}
    column_types = {n: kindmap[k] for n, k in schema}
    at = pcsv.read_csv(
        path,
        read_options=pcsv.ReadOptions(column_names=names),
        parse_options=pcsv.ParseOptions(delimiter="|"),
        convert_options=pcsv.ConvertOptions(
            column_types=column_types,
            strings_can_be_null=True,       # unquoted empty = NULL,
            quoted_strings_can_be_null=False))  # "" = empty string
    con.catalog.add_table(storage.from_arrow(table, at), or_replace=True)
    return con


def load_tpch(con, directory: str, tables=None):
    for t in (tables or TPCH_SCHEMAS):
        for ext in (".tbl", ".csv"):
            p = os.path.join(directory, f"{t}{ext}")
            if os.path.exists(p):
                load_tbl(con, t, p)
                break
    return con


# ---------------------------------------------------------------------------
# synthetic customer / orders / lineitem for the join queries Q3 and Q4
# ---------------------------------------------------------------------------

SF10_CUSTOMERS = 1_500_000
SF10_ORDERS = 15_000_000

MKTSEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD",
               "MACHINERY")
ORDERPRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
                   "5-LOW")


def synth_join_tables(n_customers: int, n_orders: int, seed: int = 42):
    """The columns TPC-H Q3 and Q4 read from customer, orders and
    lineitem, with the key shapes of the TPC-H specification (4.2.3):
    o_orderkey sparse (the first 8 of every 32 values), o_custkey never a
    multiple of 3, o_orderdate in [1992-01-01, 1998-08-02], 1 to 7 lines
    an order, l_shipdate = o_orderdate + [1, 121], l_commitdate =
    o_orderdate + [30, 90], l_receiptdate = l_shipdate + [1, 30].
    Strings are dictionary codes into MKTSEGMENTS / ORDERPRIORITIES,
    decimals scaled int64 (cents), dates int32 days.  Returns a dict of
    three dicts of numpy columns; lineitem rows follow their orders."""
    rng = np.random.default_rng(seed)
    customer = dict(
        c_custkey=np.arange(1, n_customers + 1, dtype=np.int32),
        c_mktsegment=rng.integers(0, len(MKTSEGMENTS), n_customers)
        .astype(np.int32))

    i = np.arange(n_orders, dtype=np.int64)
    o_orderkey = ((i // 8) * 32 + i % 8 + 1).astype(np.int32)
    # two thirds of the customer keys are not multiples of 3: draw an
    # index among those and map it to its key
    m = n_customers - n_customers // 3
    j = rng.integers(0, m, n_orders)
    o_custkey = (j // 2 * 3 + j % 2 + 1).astype(np.int32)
    o_orderdate = rng.integers(_days(1992, 1, 1), _days(1998, 8, 2) + 1,
                               n_orders).astype(np.int32)
    orders = dict(
        o_orderkey=o_orderkey, o_custkey=o_custkey, o_orderdate=o_orderdate,
        o_orderpriority=rng.integers(0, len(ORDERPRIORITIES), n_orders)
        .astype(np.int32),
        o_shippriority=np.zeros(n_orders, dtype=np.int32))

    lines = rng.integers(1, 8, n_orders)
    n = int(lines.sum())
    odate = np.repeat(o_orderdate, lines)
    shipdate = odate + rng.integers(1, 122, n).astype(np.int32)
    quantity = rng.integers(1, 51, n)
    lineitem = dict(
        l_orderkey=np.repeat(o_orderkey, lines),
        l_extendedprice=quantity * rng.integers(90000, 210000, n),
        l_discount=rng.integers(0, 11, n),
        l_shipdate=shipdate,
        l_commitdate=odate + rng.integers(30, 91, n).astype(np.int32),
        l_receiptdate=shipdate + rng.integers(1, 31, n).astype(np.int32))
    return dict(customer=customer, orders=orders, lineitem=lineitem)


def register_synth_join_tables(con, n_customers: int, n_orders: int,
                               seed: int = 42):
    """Register synth_join_tables' three tables with TPC-H's types;
    returns the numpy columns, for an oracle to read."""
    d = synth_join_tables(n_customers, n_orders, seed)
    register_synth_tables(con, d)
    return d


def register_synth_tables(con, tables):
    """Register {table name: numpy columns} shaped as synth_join_tables'
    with TPC-H's types (VARCHAR from the codes, DECIMAL(15,2) prices,
    DATE days, INTEGER keys)."""
    from .. import types as T
    from ..storage.strings import StringDictionary
    from ..storage.table import TableColumn, TableData

    types = {"l_extendedprice": T.DECIMAL(15, 2),
             "l_discount": T.DECIMAL(15, 2)}
    dicts = {"c_mktsegment": MKTSEGMENTS, "o_orderpriority": ORDERPRIORITIES}
    for table, cols in tables.items():
        tcs = []
        for name, data in cols.items():
            if name in dicts:
                tcs.append(TableColumn(
                    name, T.VARCHAR, data,
                    strdict=StringDictionary(np.array(dicts[name]))))
            else:
                dt = types.get(name) or (T.DATE if name.endswith("date")
                                         else T.INTEGER)
                tcs.append(TableColumn(name, dt, data))
        con.catalog.add_table(TableData(table, tcs), or_replace=True)


def q3_oracle(d, segment="BUILDING", date=None):
    """TPC-H Q3 over synth_join_tables' columns with boolean lookup
    arrays and np.add.at (no join code).  Returns every group as rows
    (l_orderkey, revenue in 1e-4 units, o_orderdate days,
    o_shippriority), ordered by revenue descending, then date."""
    date = _days(1995, 3, 15) if date is None else date
    c, o, li = d["customer"], d["orders"], d["lineitem"]
    cust_ok = np.zeros(int(c["c_custkey"].max()) + 1, dtype=bool)
    cust_ok[c["c_custkey"]] = c["c_mktsegment"] == MKTSEGMENTS.index(segment)
    o_ok = cust_ok[o["o_custkey"]] & (o["o_orderdate"] < date)
    nkeys = int(o["o_orderkey"].max()) + 1
    slot = np.full(nkeys, -1, dtype=np.int64)      # order row by orderkey
    slot[o["o_orderkey"]] = np.arange(len(o_ok))
    order_ok = np.zeros(nkeys, dtype=bool)
    order_ok[o["o_orderkey"]] = o_ok
    m = order_ok[li["l_orderkey"]] & (li["l_shipdate"] > date)
    revenue = np.zeros(len(o_ok), dtype=np.int64)
    np.add.at(revenue, slot[li["l_orderkey"][m]],
              li["l_extendedprice"][m] * (100 - li["l_discount"][m]))
    hit = np.zeros(len(o_ok), dtype=bool)
    hit[slot[li["l_orderkey"][m]]] = True
    rows = np.flatnonzero(hit)
    order = np.lexsort((o["o_orderdate"][rows], -revenue[rows]))
    rows = rows[order]
    return list(zip(o["o_orderkey"][rows].tolist(), revenue[rows].tolist(),
                    o["o_orderdate"][rows].tolist(),
                    o["o_shippriority"][rows].tolist()))


def q4_oracle(d, lo=None, hi=None):
    """TPC-H Q4 over synth_join_tables' columns: [(priority, count)] in
    priority order, from a boolean lookup array and a bincount."""
    lo = _days(1993, 7, 1) if lo is None else lo
    hi = _days(1993, 10, 1) if hi is None else hi
    o, li = d["orders"], d["lineitem"]
    late = np.zeros(int(o["o_orderkey"].max()) + 1, dtype=bool)
    late[li["l_orderkey"][li["l_commitdate"] < li["l_receiptdate"]]] = True
    m = (o["o_orderdate"] >= lo) & (o["o_orderdate"] < hi) \
        & late[o["o_orderkey"]]
    counts = np.bincount(o["o_orderpriority"][m],
                         minlength=len(ORDERPRIORITIES))
    return [(p, int(n)) for p, n in zip(ORDERPRIORITIES, counts) if n]


# ---------------------------------------------------------------------------
# dbgen file loading with numpy and the standard library.  These two
# definitions replace load_tbl and load_tpch above, which stay as the
# reference package has them and read through the Arrow csv reader.
# ---------------------------------------------------------------------------

def _split_fields(line: str):
    """One pipe-separated line -> [(text, was_quoted)].  A field may be
    wrapped in double quotes, inside which a pipe is text and a doubled
    quote is one quote."""
    if '"' not in line:
        return [(f, False) for f in line.split("|")]
    fields, buf, quoted, in_quotes, i = [], [], False, False, 0
    while i < len(line):
        c = line[i]
        if in_quotes:
            if c == '"' and line[i + 1:i + 2] == '"':
                buf.append('"')
                i += 1
            elif c == '"':
                in_quotes = False
            else:
                buf.append(c)
        elif c == '"' and not buf:
            in_quotes = quoted = True
        elif c == "|":
            fields.append(("".join(buf), quoted))
            buf, quoted = [], False
        else:
            buf.append(c)
        i += 1
    fields.append(("".join(buf), quoted))
    return fields


def _dec2(text: str) -> int:
    """A decimal literal as an integer count of hundredths, exactly."""
    neg = text.startswith("-")
    whole, _, frac = text.lstrip("+-").partition(".")
    if len(frac) > 2 and frac[2:].strip("0"):
        raise ValueError(f"more than two decimals: {text!r}")
    v = int(whole or "0") * 100 + int((frac + "00")[:2])
    return -v if neg else v


def load_tbl(con, table: str, path: str):
    """Load a dbgen-produced pipe-separated file (.tbl or exported .csv,
    plain or gzipped) with exact types: int as INTEGER, dec2 as
    DECIMAL(15,2) in scaled int64 (no float round trip), date as days,
    str dictionary-encoded.  An empty unquoted field is NULL; "" is the
    empty string."""
    import gzip

    from .. import types as T
    from ..storage.strings import StringDictionary
    from ..storage.table import TableColumn, TableData

    schema = TPCH_SCHEMAS[table]
    opener = gzip.open if path.endswith(".gz") else open
    raw = [[] for _ in schema]
    with opener(path, "rt", encoding="utf-8", newline="") as f:
        for lineno, line in enumerate(f, 1):
            line = line.rstrip("\r\n")
            if not line:
                continue
            fields = _split_fields(line)
            if len(fields) == len(schema) + 1 and fields[-1] == ("", False):
                fields.pop()                  # dbgen ends a line with '|'
            if len(fields) != len(schema):
                raise ValueError(f"{path}:{lineno}: {len(fields)} fields, "
                                 f"{table} has {len(schema)} columns")
            for col, (text, quoted) in zip(raw, fields):
                col.append(None if text == "" and not quoted else text)

    cols = []
    for (name, kind), vals in zip(schema, raw):
        nulls = np.array([v is None for v in vals], dtype=bool)
        nulls_or_none = nulls if nulls.any() else None
        if kind == "str":
            sd, codes, _ = StringDictionary.encode(vals)
            cols.append(TableColumn(name, T.VARCHAR, codes, nulls_or_none,
                                    strdict=sd))
            continue
        live = [v for v in vals if v is not None]
        if kind == "int":
            dt, conv = T.INTEGER, np.array(live, dtype=np.int64)
        elif kind == "dec2":
            dt = T.DECIMAL(15, 2)
            conv = np.array([_dec2(v) for v in live], dtype=np.int64)
        else:
            dt = T.DATE
            conv = np.array(live, dtype="datetime64[D]").astype(np.int64)
        data = np.zeros(len(vals), dtype=dt.np_dtype)
        data[~nulls] = conv
        cols.append(TableColumn(name, dt, data, nulls_or_none))
    con.catalog.add_table(TableData(table, cols), or_replace=True)
    return con


def load_tpch(con, directory: str, tables=None):
    """Load every table of TPCH_SCHEMAS (or `tables`) found in
    `directory` as <table>.tbl or .csv, plain or gzipped."""
    for t in (tables or TPCH_SCHEMAS):
        for ext in (".tbl", ".csv", ".tbl.gz", ".csv.gz"):
            p = os.path.join(directory, f"{t}{ext}")
            if os.path.exists(p):
                load_tbl(con, t, p)
                break
    return con


# ---------------------------------------------------------------------------
# TPC-H's refresh functions over synth_join_tables' columns (clause 2.5):
# RF1 inserts SF x 1,500 new orders with 1 to 7 lines each, RF2 deletes
# SF x 1,500 existing orders and their lines.  The ACID transaction of
# clause 3.1.6 changes one order's lines; reduced to these columns it
# adds a delta to l_extendedprice (there is no o_totalprice, l_tax or
# l_linenumber here).
# ---------------------------------------------------------------------------

def synth_refresh(d, sf: float, seed: int = 7, acid: int = 10):
    """RF1's rows, RF2's keys and the ACID transactions' (key, delta)
    for tables made by synth_join_tables.

    RF1's order keys lie in the gaps the base data leaves: dbgen's sparse
    keys (clause 4.2.3) put the base orders at values 1 to 8 of every 32
    and update set u at values 8u+1 to 8u+8; these are update set 1's.
    Their columns are drawn as synth_join_tables draws its own.  RF2's
    keys and the ACID keys are distinct base orders, drawn with the
    seed; an ACID delta is a price in cents, 1 to 10,000.  Returns a dict
    with "orders" and "lineitem" (numpy columns), "delete_keys" (int32)
    and "acid" [(orderkey, delta)]."""
    rng = np.random.default_rng(seed)
    n = int(round(sf * 1500))
    base = d["orders"]["o_orderkey"]
    n_customers = len(d["customer"]["c_custkey"])
    i = np.arange(n, dtype=np.int64)
    o_orderkey = ((i // 8) * 32 + 8 + i % 8 + 1).astype(np.int32)
    m = n_customers - n_customers // 3
    j = rng.integers(0, m, n)
    o_orderdate = rng.integers(_days(1992, 1, 1), _days(1998, 8, 2) + 1,
                               n).astype(np.int32)
    orders = dict(
        o_orderkey=o_orderkey,
        o_custkey=(j // 2 * 3 + j % 2 + 1).astype(np.int32),
        o_orderdate=o_orderdate,
        o_orderpriority=rng.integers(0, len(ORDERPRIORITIES), n)
        .astype(np.int32),
        o_shippriority=np.zeros(n, dtype=np.int32))
    lines = rng.integers(1, 8, n)
    nl = int(lines.sum())
    odate = np.repeat(o_orderdate, lines)
    shipdate = odate + rng.integers(1, 122, nl).astype(np.int32)
    quantity = rng.integers(1, 51, nl)
    lineitem = dict(
        l_orderkey=np.repeat(o_orderkey, lines),
        l_extendedprice=quantity * rng.integers(90000, 210000, nl),
        l_discount=rng.integers(0, 11, nl),
        l_shipdate=shipdate,
        l_commitdate=odate + rng.integers(30, 91, nl).astype(np.int32),
        l_receiptdate=shipdate + rng.integers(1, 31, nl).astype(np.int32))
    picked = rng.choice(len(base), n + acid, replace=False)
    delete_keys = np.sort(base[picked[:n]])
    acid_keys = base[picked[n:]].tolist()
    deltas = rng.integers(1, 10_001, acid).tolist()
    return dict(orders=orders, lineitem=lineitem, delete_keys=delete_keys,
                acid=list(zip(acid_keys, deltas)))


def apply_refresh_numpy(d, rf1, delete_keys, updates):
    """synth_join_tables' columns after RF1's inserts, RF2's deletes and
    the ACID updates [(orderkey, delta)], in that order, as the database
    holds them: appended rows last, deleted rows gone, deltas added to
    l_extendedprice.  The oracles q3_oracle and q4_oracle read the
    result."""
    out = {"customer": d["customer"]}
    for t, key in (("orders", "o_orderkey"), ("lineitem", "l_orderkey")):
        cols = {c: np.concatenate([d[t][c], rf1[t][c]]) for c in d[t]}
        keep = ~np.isin(cols[key], delete_keys)
        out[t] = {c: v[keep] for c, v in cols.items()}
    li = out["lineitem"]
    li["l_extendedprice"] = li["l_extendedprice"].copy()
    for k, delta in updates:
        li["l_extendedprice"][li["l_orderkey"] == k] += delta
    return out
