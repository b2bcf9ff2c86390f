"""A ClickBench-shaped `hits` table and statements of ClickBench's shapes
(reference: benchmark/clickbench/; PyTorch port of
ddb_tpu/bench/clickbench.py).

The suite's hits.parquet is not in the repository, and neither are its 43
official query texts: the reference package reads them from a directory
outside the repository.  So `SHAPES` holds statements written here *in
the shape of* the ClickBench queries their names cite (a LIKE count, a
group-by over extract(minute ...), REGEXP_REPLACE through the
dictionary, CASE over strings, DATE_TRUNC with an OFFSET), plus four
statements that run the executors the suite does not reach (a CTE read
twice, a recursive CTE, SAMPLE, the host aggregates with UNNEST).  They
are not the official texts and their times are not ClickBench results.

`generate` makes the table with the reference package's draws, in its
order, so both packages see the same rows.  A string column is never
formatted per row: it comes back as int32 codes into a small sorted
dictionary (`Coded`), and `register` stores it so.
"""

from __future__ import annotations

import datetime
from typing import NamedTuple

import numpy as np


class Coded(NamedTuple):
    """A string column: values[codes], values sorted and unique."""
    codes: np.ndarray        # int32 [n]
    values: np.ndarray       # str [cardinality]

    def decode(self) -> np.ndarray:
        return self.values[self.codes]


def _labels():
    """The five string columns' populations, as the reference lists them
    (with the repeated empty strings that weight the empty value)."""
    return {
        "SearchPhrase": [""] * 5 + [f"search phrase {i}" for i in range(200)],
        "MobilePhoneModel": [""] * 3 + [f"Phone-{i}" for i in range(20)],
        "URL": [""] * 2
        + [f"http://example{i}.com/page" for i in range(300)]
        + [f"http://google.com/q{i}" for i in range(30)]
        + [f"http://sub.google.com/r{i}" for i in range(10)],
        "Title": [""] * 3 + [f"Title {i}" for i in range(150)]
        + [f"Google result {i}" for i in range(20)],
        "Referer": [""] * 4
        + [f"https://www.ref{i}.org/p/{i}" for i in range(120)]
        + [f"http://site{i}.net/x" for i in range(40)],
    }


def generate(n: int, seed: int = 11):
    """Synthetic hits columns, the reference generator's 25.  Numeric
    columns are numpy arrays (EventDate in days and EventTime in seconds
    since 1970); string columns are `Coded`."""
    rng = np.random.default_rng(seed)
    labels = _labels()

    def choice(name):
        # Generator.choice(population, n) draws integers(0, len, n) and
        # indexes the population; here the index goes to the sorted
        # dictionary instead of to n strings
        pop = np.array(labels[name])
        values = np.unique(pop)
        remap = np.searchsorted(values, pop).astype(np.int32)
        return Coded(remap[rng.integers(0, len(pop), n)], values)

    def where(share, then, lo, hi):
        hit = rng.random(n) < share
        return np.where(hit, then, rng.integers(lo, hi, n)).astype(np.int32)

    def flag(share):
        return (rng.random(n) < share).astype(np.int32)

    def i32(lo, hi):
        return rng.integers(lo, hi, n).astype(np.int32)

    # EventDate: days around 2013-07 (2013-07-01 is day 15887)
    event_date = i32(15860, 15950)
    base = 1373760000   # 2013-07-14 00:00:00 UTC
    event_time = base + rng.integers(-40 * 86400, 3 * 86400, n)
    urlhash = rng.integers(0, 1 << 40, n)
    urlhash[rng.random(n) < 0.02] = 2868770270353813622
    refhash = rng.integers(0, 1 << 40, n)
    refhash[rng.random(n) < 0.02] = 3594120000172545465
    return {
        "WatchID": rng.integers(0, n, n),
        "CounterID": where(0.15, 62, 1, 200),
        "ClientIP": rng.integers(0, 1 << 31, n),
        "AdvEngineID": where(0.8, 0, 1, 20),
        "ResolutionWidth": i32(800, 2560),
        "WindowClientWidth": i32(300, 2000),
        "WindowClientHeight": i32(200, 1200),
        "UserID": rng.integers(0, n // 3 + 1, n),
        "RegionID": i32(0, 100),
        "SearchEngineID": i32(0, 10),
        "TraficSourceID": i32(-1, 10),
        "IsRefresh": flag(0.1),
        "IsLink": flag(0.3),
        "IsDownload": flag(0.05),
        "DontCountHits": flag(0.1),
        "SearchPhrase": choice("SearchPhrase"),
        "MobilePhone": i32(0, 6),
        "MobilePhoneModel": choice("MobilePhoneModel"),
        "URL": choice("URL"),
        "Title": choice("Title"),
        "Referer": choice("Referer"),
        "URLHash": urlhash,
        "RefererHash": refhash,
        "EventDate": event_date,
        "EventTime": event_time,
    }


def register(con, cols):
    """Register generate()'s columns as table hits: EventDate DATE,
    EventTime TIMESTAMP, the strings VARCHAR, the rest INTEGER or BIGINT
    by their width."""
    from .. import types as T
    from ..storage.strings import StringDictionary
    from ..storage.table import TableColumn, TableData

    tcs = []
    for name, data in cols.items():
        if isinstance(data, Coded):
            tcs.append(TableColumn(name, T.VARCHAR, data.codes,
                                   strdict=StringDictionary(data.values)))
        elif name == "EventDate":
            tcs.append(TableColumn(name, T.DATE, data.astype(np.int32)))
        elif name == "EventTime":
            tcs.append(TableColumn(name, T.TIMESTAMP,
                                   data.astype(np.int64) * 1_000_000))
        else:
            dt = T.BIGINT if data.dtype.itemsize == 8 else T.INTEGER
            tcs.append(TableColumn(name, dt, data))
    con.catalog.add_table(TableData("hits", tcs), or_replace=True)
    return con


def write_csv(cols, path: str, device="cuda"):
    """Write generate()'s columns to `path` with the bytes the reference's
    write_csv gives for the same table (Python's csv.writer: fields quoted
    only where needed, '' as an empty field, CRLF; EventDate and
    EventTime in ISO form), formatted on `device`, the card unless the
    caller names another (storage/csvwrite.py, its "csv" dialect).  A
    string column is formatted once per dictionary entry."""
    from .. import types as T
    from ..storage import csvwrite
    from ..storage.strings import StringDictionary

    out = []
    for name, data in cols.items():
        if isinstance(data, Coded):
            out.append((name, T.VARCHAR, data.codes, None,
                        StringDictionary(data.values)))
        elif name == "EventDate":
            out.append((name, T.DATE, data.astype(np.int32), None, None))
        elif name == "EventTime":
            out.append((name, T.TIMESTAMP,
                        data.astype(np.int64) * 1_000_000, None, None))
        else:
            out.append((name, T.BIGINT, data.astype(np.int64), None, None))
    csvwrite.write_host(out, path, device=device, dialect="csv")
    return path


_DISTINCT_MODELS = ("(SELECT DISTINCT RegionID, MobilePhoneModel AS m FROM "
                    "hits WHERE MobilePhoneModel <> '')")


def shapes(min_count: int = 100_000, offset: int = 1000):
    """{name: SQL}.  `min_count` is the HAVING threshold and `offset` the
    OFFSET of cb_trunc_minute; the defaults suit 1e8 rows (a small table
    leaves nothing above them).  Every ORDER BY breaks its ties, so the
    rows are determined."""
    return {
        # q21
        "cb_like_count":
            "SELECT COUNT(*) FROM hits WHERE URL LIKE '%google%'",
        # q22
        "cb_phrase_like":
            "SELECT SearchPhrase, MIN(URL), COUNT(*) AS c FROM hits WHERE "
            "URL LIKE '%google%' AND SearchPhrase <> '' GROUP BY "
            "SearchPhrase ORDER BY c DESC, SearchPhrase LIMIT 10",
        # q19
        "cb_minute":
            "SELECT UserID, extract(minute FROM EventTime) AS m, "
            "SearchPhrase, COUNT(*) AS c FROM hits GROUP BY UserID, m, "
            "SearchPhrase ORDER BY c DESC, UserID, m, SearchPhrase LIMIT 10",
        # q28
        "cb_len":
            "SELECT CounterID, AVG(length(URL)) AS l, COUNT(*) AS c FROM "
            "hits WHERE URL <> '' GROUP BY CounterID HAVING COUNT(*) > "
            f"{min_count} ORDER BY l DESC, CounterID LIMIT 25",
        # q29
        "cb_regexp":
            "SELECT REGEXP_REPLACE(Referer, "
            "'^https?://(?:www\\.)?([^/]+)/.*$', '\\1') AS k, "
            "AVG(length(Referer)) AS l, COUNT(*) AS c, MIN(Referer) FROM "
            "hits WHERE Referer <> '' GROUP BY k HAVING COUNT(*) > "
            f"{min_count} ORDER BY l DESC, k LIMIT 25",
        # q40
        "cb_case":
            "SELECT TraficSourceID, SearchEngineID, AdvEngineID, CASE WHEN "
            "SearchEngineID = 0 AND AdvEngineID = 0 THEN Referer ELSE '' "
            "END AS src, URL AS dst, COUNT(*) AS c FROM hits WHERE "
            "CounterID = 62 AND IsRefresh = 0 GROUP BY 1, 2, 3, 4, 5 "
            "ORDER BY c DESC, 1, 2, 3, 4, 5 LIMIT 10",
        # q43
        "cb_trunc_minute":
            "SELECT DATE_TRUNC('minute', EventTime) AS M, COUNT(*) FROM "
            "hits WHERE CounterID = 62 AND EventDate >= '2013-07-14' AND "
            "EventDate <= '2013-07-15' AND IsRefresh = 0 AND DontCountHits "
            f"= 0 GROUP BY M ORDER BY M LIMIT 10 OFFSET {offset}",
        # TPC-H Q15's shape: a CTE read twice
        "sel_cte_twice":
            "WITH r AS (SELECT RegionID, SUM(ResolutionWidth) AS s FROM "
            "hits GROUP BY RegionID) SELECT RegionID, s FROM r WHERE s = "
            "(SELECT MAX(s) FROM r)",
        "sel_day_spine":
            "WITH RECURSIVE d(x) AS (SELECT DATE '2013-06-04' UNION ALL "
            "SELECT x + 1 FROM d WHERE x < DATE '2013-09-01') SELECT d.x, "
            "COUNT(h.EventDate) FROM d LEFT JOIN hits h ON h.EventDate = "
            "d.x GROUP BY d.x ORDER BY d.x",
        "sel_sample":
            "SELECT COUNT(*), SUM(ResolutionWidth) FROM hits USING SAMPLE "
            "1 PERCENT REPEATABLE (42)",
        # the device makes the distinct (region, model) rows, the host
        # aggregate folds them
        "sel_models":
            "SELECT RegionID, list(m ORDER BY m), string_agg(m, ',') FROM "
            f"{_DISTINCT_MODELS} GROUP BY RegionID ORDER BY RegionID",
        # ... and unnest gives the rows back
        "sel_models_unnest":
            "SELECT RegionID, unnest(l) AS m FROM (SELECT RegionID, "
            f"list(m ORDER BY m) AS l FROM {_DISTINCT_MODELS} GROUP BY "
            "RegionID) ORDER BY RegionID, m",
    }


SHAPES = shapes()

# the draws of SAMPLE differ between the packages and between devices:
# it is held by properties, not row by row
DRAWS = ("sel_sample",)


# ---------------------------------------------------------------------------
# numpy oracles over generate()'s columns, from the codes and the
# dictionaries (no code of the package)
# ---------------------------------------------------------------------------

def like_count_oracle(cols):
    """cb_like_count's rows."""
    url = cols["URL"]
    hit = np.array(["google" in v for v in url.values])
    return [(int(hit[url.codes].sum()),)]


def len_oracle(cols, min_count: int = 100_000):
    """cb_len's rows."""
    url = cols["URL"]
    lens = np.array([len(v) for v in url.values], dtype=np.int64)
    live = np.flatnonzero(lens[url.codes] > 0)
    cid = cols["CounterID"][live]
    cnt = np.bincount(cid)
    tot = np.bincount(cid, weights=lens[url.codes[live]])
    rows = [(int(c), float(tot[c] / cnt[c]), int(cnt[c]))
            for c in np.flatnonzero(cnt > min_count)]
    rows.sort(key=lambda r: (-r[1], r[0]))
    return rows[:25]


def trunc_minute_oracle(cols, offset: int = 1000):
    """cb_trunc_minute's rows."""
    d = cols["EventDate"]
    keep = (cols["CounterID"] == 62) & (d >= 15900) & (d <= 15901) \
        & (cols["IsRefresh"] == 0) & (cols["DontCountHits"] == 0)
    minutes, cnt = np.unique(cols["EventTime"][keep] // 60,
                             return_counts=True)
    epoch = datetime.datetime(1970, 1, 1)
    return [(epoch + datetime.timedelta(minutes=int(m)), int(c))
            for m, c in zip(minutes[offset:offset + 10],
                            cnt[offset:offset + 10])]

