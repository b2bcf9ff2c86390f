"""A materialised result's host columns (api._result_to_table, through
batch.to_pinned_numpy): CREATE TABLE AS keeps the statement's rows, on the
CPU as plain arrays and from the card in page-locked memory, with the
statistics the host arrays give, taken from the result's tensors.  The
tests that take `cuda_device` skip without a card:

    python3 -m pytest tests/test_torch_ctas_host.py -q      # on the card
"""

import numpy as np
import pytest
import torch

import ddb_tpu_torch
from ddb_tpu_torch.batch import to_numpy, to_pinned_numpy
from ddb_tpu_torch.storage import table as storage

ROWS = 5000
CTAS = ("CREATE TEMP TABLE ans AS SELECT k, sum(v) AS v, count(*) AS n, "
        "max(w) AS w, CASE WHEN k % 5 = 0 THEN NULL ELSE k END AS z, "
        "min(s) AS s, bool_or(v > 40) AS b FROM t GROUP BY k")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run this file on the card")
    return torch.device("cuda", 0)


def _connect(device):
    rng = np.random.default_rng(11)
    con = ddb_tpu_torch.connect(device)
    w = rng.random(ROWS)
    con.register("t", {"k": rng.integers(0, 700, ROWS).tolist(),
                       "v": rng.integers(-50, 50, ROWS).tolist(),
                       "w": [None if x < 0.1 else x for x in w],
                       "s": [f"s{x:03d}" for x in
                             rng.integers(0, 300, ROWS)]})
    return con


def _columns(con):
    td = con.catalog.get_table("ans")
    return {c.name: (c.data, c.nulls, c.stats) for c in td.columns}


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float64,
                                   torch.bool])
def test_to_pinned_numpy_of_a_host_tensor_is_to_numpy(dtype):
    t = (torch.arange(-3, 9) % 4).to(dtype)
    got = to_pinned_numpy(t)
    assert got.dtype == to_numpy(t).dtype
    assert np.array_equal(got, to_numpy(t))


def test_ctas_keeps_the_statements_rows_and_host_statistics():
    con = _connect("cpu")
    want = con.execute(CTAS.split(" AS ", 1)[1] + " ORDER BY k").fetchall()
    con.execute(CTAS)
    assert con.execute("SELECT * FROM ans ORDER BY k").fetchall() == want
    td = con.catalog.get_table("ans")
    assert len(td.columns[0].data) == len(want) == 700
    # the statistics taken from the result's tensors are those of the
    # host arrays, numpy scalars of the column's dtype
    for c in td.columns:
        host = storage.TableColumn(c.name, c.dtype, c.data, c.nulls,
                                   strdict=c.strdict)
        host.compute_stats()
        assert type(c.stats.min) is type(host.stats.min), c.name
        assert (c.stats.min, c.stats.max, c.stats.has_nulls,
                c.stats.distinct_hint) == (host.stats.min, host.stats.max,
                                           host.stats.has_nulls,
                                           host.stats.distinct_hint)
    assert td.columns[4].stats.has_nulls and td.columns[4].stats.min == 1
    con.execute("DROP TABLE ans")
    con.execute("CREATE TEMP TABLE e AS SELECT k FROM t WHERE k < 0")
    assert con.catalog.get_table("e").columns[0].stats.min is None


def test_ctas_from_the_card_lands_in_page_locked_memory(cuda_device):
    con = _connect("cuda")
    con.execute(CTAS)
    got = _columns(con)
    for data, nulls, _ in got.values():
        assert torch.from_numpy(data).is_pinned()
        assert nulls is None or torch.from_numpy(nulls).is_pinned()
    ref = _connect("cpu")
    ref.execute(CTAS)
    for name, (_, _, stats) in _columns(ref).items():
        assert stats == got[name][2], name
    sql = "SELECT k, v, n, w FROM ans ORDER BY k"
    assert con.execute(sql).fetchall() == ref.execute(sql).fetchall()
    # the table is scanned again from its pinned columns, and a second
    # CTAS after the DROP takes blocks from the allocator's cache
    con.execute("DROP TABLE ans")
    con.execute(CTAS)
    assert con.execute(sql).fetchall() == ref.execute(sql).fetchall()


STREAM_SQL = ("SELECT k, sum(i) AS s, count(*) AS n, max(i) AS m "
              "FROM big GROUP BY k ORDER BY k")


@pytest.mark.parametrize("where", ["cpu", "cuda"])
def test_an_aggregate_streams_a_materialised_table(where, request):
    # a CTAS result above external_threshold_rows streams through the
    # tiled aggregate.  On the card its int64 columns (128 MiB, over
    # tiled.REGISTER_MIN_BYTES) are page-locked already, so the tile
    # feed reads them in place and registers nothing a second time
    from ddb_tpu_torch.plan import tiled
    if where == "cuda":
        request.getfixturevalue("cuda_device")
    rows = 1 << (24 if where == "cuda" else 20)
    con = ddb_tpu_torch.connect(where)
    con.execute(f"CREATE TEMP TABLE big AS SELECT range AS i, "
                f"range % 7 AS k FROM range({rows})")
    con.execute(f"SET external_threshold_rows = {rows // 4}")
    con.execute(f"SET tile_rows = {rows // 4}")
    for k in tiled.STREAM_STATS:
        tiled.STREAM_STATS[k] = 0
    got = con.execute(STREAM_SQL).fetchall()
    assert tiled.STREAM_STATS["tiles"] == 4
    i = np.arange(rows, dtype=np.int64)
    want = [(k, int(i[i % 7 == k].sum()), int((i % 7 == k).sum()),
             int(i[i % 7 == k].max())) for k in range(7)]
    assert got == want
    data = con.catalog.get_table("big").columns[0].data
    if where == "cuda":
        assert torch.from_numpy(data).is_pinned()
        assert id(data) not in tiled._REGISTERED
        ref = ddb_tpu_torch.connect("cpu")
        ref.execute(f"CREATE TEMP TABLE big AS SELECT range AS i, "
                    f"range % 7 AS k FROM range({rows})")
        assert ref.execute(STREAM_SQL).fetchall() == got
