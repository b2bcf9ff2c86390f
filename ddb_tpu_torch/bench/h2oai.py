"""h2oai db-benchmark groupby suite (reference: benchmark/h2oai/group/).

PyTorch port of ddb_tpu/bench/h2oai.py.  The suite's G1_* files are
generated locally to the published spec — N rows, K id-cardinality
groups, the NA variant — from a seed, in the same order of draws as the
reference package, so both packages see the same table.  The string ids
are never formatted per row: `generate` returns them as numbers and
`register` stores them as dictionary codes.
"""

from __future__ import annotations

import numpy as np

# the 10 groupby queries (reference: benchmark/h2oai/group/queries/q*.sql,
# minus the TEMP TABLE wrapper)
QUERIES = {
    1: "SELECT id1, sum(v1) AS v1 FROM x_group GROUP BY id1",
    2: "SELECT id1, id2, sum(v1) AS v1 FROM x_group GROUP BY id1, id2",
    3: "SELECT id3, sum(v1) AS v1, avg(v3) AS v3 FROM x_group GROUP BY id3",
    4: "SELECT id4, avg(v1) AS v1, avg(v2) AS v2, avg(v3) AS v3 "
       "FROM x_group GROUP BY id4",
    5: "SELECT id6, sum(v1) AS v1, sum(v2) AS v2, sum(v3) AS v3 "
       "FROM x_group GROUP BY id6",
    6: "SELECT id4, id5, quantile_cont(v3, 0.5) AS median_v3, "
       "stddev(v3) AS sd_v3 FROM x_group GROUP BY id4, id5",
    7: "SELECT id3, max(v1)-min(v2) AS range_v1_v2 FROM x_group "
       "GROUP BY id3",
    8: "SELECT id6, v3 AS largest2_v3 FROM (SELECT id6, v3, "
       "row_number() OVER (PARTITION BY id6 ORDER BY v3 DESC) AS "
       "order_v3 FROM x_group WHERE v3 IS NOT NULL) sub_query "
       "WHERE order_v3 <= 2",
    9: "SELECT id2, id4, pow(corr(v1, v2), 2) AS r2 FROM x_group "
       "GROUP BY id2, id4",
    10: "SELECT id1, id2, id3, id4, id5, id6, sum(v3) AS v3, "
        "count(*) AS count FROM x_group "
        "GROUP BY id1, id2, id3, id4, id5, id6",
}

# digits of the zero-padded number in an id column's labels
ID_DIGITS = {"id1": 3, "id2": 3, "id3": 10}


def generate(n: int, k: int = 100, na_pct: int = 0, seed: int = 108):
    """Generate h2oai G1-style columns (spec: id1-3 strings 'id###' with K
    (or N/K) cardinality, id4-6 ints, v1-2 small ints, v3 double).

    id1-id3 come back as the numbers inside their labels (`id_labels`
    formats them); with na_pct, v1 is a masked array whose masked rows
    are NULL."""
    rng = np.random.default_rng(seed)
    big = max(n // k, 1)
    cols = {
        "id1": rng.integers(1, k + 1, n).astype(np.int32),
        "id2": rng.integers(1, k + 1, n).astype(np.int32),
        "id3": rng.integers(1, big + 1, n).astype(np.int32),
        "id4": rng.integers(1, k + 1, n).astype(np.int32),
        "id5": rng.integers(1, k + 1, n).astype(np.int32),
        "id6": rng.integers(1, big + 1, n).astype(np.int32),
        "v1": rng.integers(1, 6, n).astype(np.int32),
        "v2": rng.integers(1, 16, n).astype(np.int32),
        "v3": np.round(rng.uniform(0, 100, n), 6),
    }
    if na_pct:
        cols["v1"] = np.ma.masked_array(
            cols["v1"], mask=rng.random(n) < na_pct / 100.0)
    return cols


def id_labels(name: str, count: int) -> np.ndarray:
    """The labels 'id001'.. of the numbers 1..count of an id column;
    zero-padded, so label order is number order."""
    return np.array([f"id{v:0{ID_DIGITS[name]}d}"
                     for v in range(1, count + 1)])


def write_csv(cols, path: str, device="cuda"):
    """Write generate()'s columns to `path` with the bytes the reference's
    write_csv gives for the same table: a quoted header, the id labels
    quoted, NULL empty (storage/csvwrite.py, formatted on `device`: the
    card unless the caller names another)."""
    from .. import types as T
    from ..storage import csvwrite
    from ..storage.strings import StringDictionary

    out = []
    for name, data in cols.items():
        nulls = None
        if isinstance(data, np.ma.MaskedArray):
            nulls = np.ma.getmaskarray(data)
            data = np.where(nulls, 0, data.data)
        if name in ID_DIGITS:
            sd = StringDictionary(id_labels(name, int(data.max())))
            out.append((name, T.VARCHAR, (data - 1).astype(np.int32), None,
                        sd))
        else:
            dt = T.DOUBLE if data.dtype.kind == "f" else T.BIGINT
            out.append((name, dt, data.astype(dt.np_dtype), nulls, None))
    csvwrite.write_host(out, path, device=device)
    return path


def register(con, cols):
    """Register generate()'s columns as table x_group: id1-id3 VARCHAR
    (int32 codes into a dictionary of every label up to the column's
    largest number), id4-id6, v1, v2 INTEGER, v3 DOUBLE."""
    from .. import types as T
    from ..storage.strings import StringDictionary
    from ..storage.table import TableColumn, TableData

    tcs = []
    for name, data in cols.items():
        nulls = None
        if isinstance(data, np.ma.MaskedArray):
            nulls = np.ma.getmaskarray(data)
            data = np.where(nulls, 0, data.data)
        if name in ID_DIGITS:
            sd = StringDictionary(id_labels(name, int(data.max())))
            tcs.append(TableColumn(name, T.VARCHAR, data - 1, strdict=sd))
        else:
            dt = T.DOUBLE if data.dtype.kind == "f" else T.INTEGER
            tcs.append(TableColumn(name, dt, data.astype(dt.np_dtype),
                                   nulls))
    con.catalog.add_table(TableData("x_group", tcs), or_replace=True)
    return con


# ---------------------------------------------------------------------------
# numpy oracles over generate()'s columns (no group-by or window code of
# the package)
# ---------------------------------------------------------------------------

def _group_index(*keys):
    """(inverse, first row of each group): groups in ascending key order."""
    order = np.lexsort(keys[::-1])
    change = np.zeros(len(order), dtype=bool)
    change[:1] = True
    for k in keys:
        ks = k[order]
        change[1:] |= ks[1:] != ks[:-1]
    inverse = np.empty(len(order), dtype=np.int64)
    inverse[order] = np.cumsum(change) - 1
    return inverse, order[change]


def q3_oracle(cols):
    """q3 as (id3 numbers, sum(v1), avg(v3)) arrays in id3 order."""
    inv, first = _group_index(cols["id3"])
    cnt = np.bincount(inv)
    v1 = np.bincount(inv, weights=np.ma.filled(cols["v1"], 0)
                     ).astype(np.int64)
    return cols["id3"][first], v1, np.bincount(inv, weights=cols["v3"]) / cnt


def q6_oracle(cols):
    """q6 as (id4, id5, median(v3), stddev_samp(v3)) arrays in (id4, id5)
    order; the median interpolates like quantile_cont, the deviation is
    the two-pass one."""
    id4, id5, v3 = cols["id4"], cols["id5"], cols["v3"]
    order = np.lexsort((v3, id5, id4))
    inv, first = _group_index(id4, id5)
    cnt = np.bincount(inv)
    start = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    vs = v3[order]
    frac = 0.5 * (cnt - 1)
    lo, hi = np.floor(frac).astype(np.int64), np.ceil(frac).astype(np.int64)
    w = frac - np.floor(frac)
    median = vs[start + lo] * (1 - w) + vs[start + hi] * w
    mean = np.bincount(inv, weights=v3) / cnt
    dev = np.bincount(inv, weights=(v3 - mean[inv]) ** 2)
    sd = np.sqrt(dev / np.maximum(cnt - 1, 1))
    return id4[first], id5[first], median, np.where(cnt > 1, sd, np.nan)


def q8_oracle(cols):
    """q8 as (id6, v3) arrays: the two largest v3 of every id6, ordered
    by id6 and then v3 descending."""
    id6, v3 = cols["id6"], cols["v3"]
    order = np.lexsort((-v3, id6))
    ks = id6[order]
    start = np.zeros(len(ks), dtype=bool)
    start[:1] = True
    start[1:] = ks[1:] != ks[:-1]
    rank = np.arange(len(ks)) - np.maximum.accumulate(
        np.where(start, np.arange(len(ks)), 0))
    keep = order[rank < 2]
    return id6[keep], v3[keep]
