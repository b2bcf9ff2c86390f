"""The h2oai db-benchmark group-by suite (q1-q10) through
ddb_tpu.connect() and ddb_tpu_torch.connect(device="cpu") over the same
generated table, the NA and skewed-key variants of tests/test_h2oai.py,
the two packages' generators column for column, and the port's numpy
oracles against its SQL.

Integers and strings must match exactly; floats (avg, stddev, median,
corr, float sums) to 1e-12 relative, since the packages add in different
orders."""

import math
import os

import numpy as np
import pytest

import ddb_tpu
import ddb_tpu_torch
from ddb_tpu.bench import h2oai as ref_h2oai
from ddb_tpu_torch.bench import h2oai
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401

RTOL = 1e-12
N, K, SEED = 2000, 10, 7
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ordered(sql):
    if "GROUP BY" in sql:
        order_cols = sql.split("GROUP BY")[1].strip()
    else:
        order_cols = "id6, largest2_v3"       # q8 window top-2
    return f"SELECT * FROM ({sql}) t ORDER BY {order_cols}"


def _same_rows(want, got):
    assert len(want) == len(got) and len(want) > 0
    for rw, rg in zip(want, got):
        assert len(rw) == len(rg)
        for w, g in zip(rw, rg):
            if isinstance(w, float):
                assert isinstance(g, float)
                assert (math.isnan(w) and math.isnan(g)) or \
                    math.isclose(w, g, rel_tol=RTOL, abs_tol=0.0), (rw, rg)
            else:
                assert type(w) is type(g) and w == g, (rw, rg)


def _connections(ref_cols, port_cols):
    ref = ref_h2oai.register(ddb_tpu.connect(), ref_cols)
    port = h2oai.register(ddb_tpu_torch.connect(device="cpu"), port_cols)
    return ref, port


@pytest.fixture(scope="module")
def setup():
    port_cols = h2oai.generate(N, k=K, seed=SEED)
    ref, port = _connections(ref_h2oai.generate(N, k=K, seed=SEED),
                             port_cols)
    return ref, port, port_cols


@pytest.mark.parametrize("n,k,na_pct,seed", [(2000, 10, 0, 7),
                                             (3000, 50, 5, 12),
                                             (50, 100, 0, 108)])
def test_generate_equals_the_reference_column_for_column(n, k, na_pct, seed):
    want = ref_h2oai.generate(n, k=k, na_pct=na_pct, seed=seed)
    got = h2oai.generate(n, k=k, na_pct=na_pct, seed=seed)
    assert list(got) == list(want)
    for name in ("id1", "id2", "id3"):
        labels = h2oai.id_labels(name, int(got[name].max()))
        assert list(labels) == sorted(labels)
        assert (labels[got[name] - 1] == want[name]).all()
    for name in ("id4", "id5", "id6", "v2", "v3"):
        assert got[name].dtype == want[name].dtype
        assert (got[name] == want[name]).all()
    if na_pct:
        mask = np.array([v is None for v in want["v1"]])
        assert mask.any() and (np.ma.getmaskarray(got["v1"]) == mask).all()
        assert (got["v1"].data[~mask] == want["v1"][~mask]).all()
    else:
        assert (got["v1"] == want["v1"]).all()


def test_register_builds_dictionary_codes_not_strings(setup):
    _, port, cols = setup
    t = port.catalog.get_table("x_group")
    assert [c.name for c in t.columns] == list(cols)
    for c in t.columns[:3]:
        assert c.data.dtype == np.int32 and c.dtype.id.name == "VARCHAR"
        assert len(c.strdict) == cols[c.name].max()
    assert t.columns[2].strdict.decode_one(0) == "id0000000001"
    assert [c.dtype.id.name for c in t.columns[3:]] \
        == ["INTEGER"] * 5 + ["DOUBLE"]


@pytest.mark.parametrize("q", sorted(h2oai.QUERIES))
def test_h2oai_query_matches_reference(setup, q):
    ref, port, _ = setup
    sql = _ordered(h2oai.QUERIES[q])
    want = ref.execute(sql)
    got = port.execute(sql)
    assert got.batch.sel.device.type == "cpu"
    assert got.column_names == want.column_names
    _same_rows(want.fetchall(), got.fetchall())


def test_h2oai_na_variant():
    """NA variant: 5% NULL v1 (h2oai G1 na_pct spec)."""
    ref, port = _connections(
        ref_h2oai.generate(3000, k=50, na_pct=5, seed=12),
        h2oai.generate(3000, k=50, na_pct=5, seed=12))
    for sql in ("SELECT id1, sum(v1) AS v1, count(v1) AS n, count(*) AS c "
                "FROM x_group GROUP BY id1 ORDER BY id1",
                "SELECT id4, median(v1), count(DISTINCT v1), max(v1) "
                "FROM x_group GROUP BY id4 ORDER BY id4"):
        want = ref.execute(sql).fetchall()
        assert any(r[2] != r[3] for r in want) or "median" in sql
        _same_rows(want, port.execute(sql).fetchall())


def test_h2oai_skewed_keys():
    """Skewed variant: 90% of rows in one group (BASELINE config 4)."""
    n = 5000
    skew = np.random.default_rng(1).random(n) < 0.9
    ref_cols = ref_h2oai.generate(n, k=10, seed=9)
    ref_cols["id1"] = np.where(skew, "id001", ref_cols["id1"])
    port_cols = h2oai.generate(n, k=10, seed=9)
    port_cols["id1"] = np.where(skew, 1, port_cols["id1"]).astype(np.int32)
    ref, port = _connections(ref_cols, port_cols)
    for sql in ("SELECT id1, sum(v1) AS v1, count(*) AS n FROM x_group "
                "GROUP BY id1 ORDER BY id1",
                "SELECT id1, v3 FROM (SELECT id1, v3, row_number() OVER "
                "(PARTITION BY id1 ORDER BY v3 DESC) AS rn FROM x_group) s "
                "WHERE rn <= 2 ORDER BY id1, v3"):
        want = ref.execute(sql).fetchall()
        _same_rows(want, port.execute(sql).fetchall())
    assert want[0][0] == "id001"


def test_oracles_equal_the_sql(setup):
    _, port, cols = setup

    def run(q):
        return port.execute(_ordered(h2oai.QUERIES[q])).fetchall()

    id3, v1, v3 = h2oai.q3_oracle(cols)
    rows = run(3)
    assert [r[0] for r in rows] == list(h2oai.id_labels("id3", K * 100)[
        id3 - 1]) and [r[1] for r in rows] == v1.tolist()
    np.testing.assert_allclose([r[2] for r in rows], v3, rtol=RTOL)

    id4, id5, median, sd = h2oai.q6_oracle(cols)
    rows = run(6)
    assert [(r[0], r[1]) for r in rows] == list(zip(id4.tolist(),
                                                    id5.tolist()))
    np.testing.assert_allclose([r[2] for r in rows], median, rtol=RTOL)
    # the engine's deviation is one-pass (sum x, sum x^2), the oracle's
    # two-pass: they differ by the cancellation in sum x^2 - n mean^2,
    # about 1e-16 * mean^2 / variance relative; 1e-9 covers v3's range
    got_sd = np.array([np.nan if r[3] is None else r[3] for r in rows])
    np.testing.assert_allclose(got_sd, sd, rtol=1e-9, equal_nan=True)

    id6, top = h2oai.q8_oracle(cols)
    rows = run(8)
    assert sorted(rows) == sorted(zip(id6.tolist(), top.tolist()))

