# Generated from tests/test_sketch.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite sketch); do not edit.
"""HyperLogLog + quantile digest sketches (reference:
third_party/hyperloglog behind approx_count.cpp; third_party/tdigest
behind approx_quantile)."""
from ddb_tpu_torch.testing import refsuite
import numpy as np
import pytest

import ddb_tpu_torch


def test_hll_accuracy_and_merge():
    from ddb_tpu_torch.testing.refsuite import arrays as jnp
    from ddb_tpu_torch.ops import sketch
    rng = np.random.default_rng(0)
    for true_n in (1000, 50_000, 300_000):
        vals = rng.integers(0, true_n, 400_000).astype(np.int64)
        sel = np.ones(400_000, dtype=bool)
        est = int(sketch.hll_count_distinct(jnp.asarray(vals),
                                            jnp.asarray(sel)))
        err = abs(est - len(np.unique(vals))) / len(np.unique(vals))
        assert err < 0.05, (true_n, est, err)
    # mergeability: sketch(A) merge sketch(B) == sketch(A union B)
    a = rng.integers(0, 100_000, 200_000).astype(np.int64)
    b = rng.integers(50_000, 150_000, 200_000).astype(np.int64)
    ones = jnp.asarray(np.ones(200_000, dtype=bool))
    ra = sketch.hll_registers(jnp.asarray(a), ones)
    rb = sketch.hll_registers(jnp.asarray(b), ones)
    merged = int(sketch.hll_estimate(sketch.hll_merge(ra, rb)))
    true = len(np.unique(np.concatenate([a, b])))
    assert abs(merged - true) / true < 0.05


def test_digest_quantiles_and_merge():
    from ddb_tpu_torch.testing.refsuite import arrays as jnp
    from ddb_tpu_torch.ops import sketch
    rng = np.random.default_rng(1)
    vals = rng.standard_normal(200_000)
    ones = jnp.asarray(np.ones(200_000, dtype=bool))
    c, w = sketch.quantile_digest(jnp.asarray(vals), ones)
    for q in (0.1, 0.5, 0.9):
        est = float(sketch.digest_quantile(c, w, q))
        true = float(np.quantile(vals, q))
        assert abs(est - true) < 0.05, (q, est, true)
    # merge two halves == digest of the whole (approximately)
    h1, h2 = vals[:100_000], vals[100_000:]
    half = jnp.asarray(np.ones(100_000, dtype=bool))
    c1, w1 = sketch.quantile_digest(jnp.asarray(h1), half)
    c2, w2 = sketch.quantile_digest(jnp.asarray(h2), half)
    cm, wm = sketch.digest_merge(c1, w1, c2, w2)
    for q in (0.25, 0.75):
        est = float(sketch.digest_quantile(cm, wm, q))
        true = float(np.quantile(vals, q))
        assert abs(est - true) < 0.05, (q, est, true)


def test_approx_count_distinct_sql():
    con = refsuite.connect()
    con.execute("CREATE TABLE s(v INTEGER)")
    con.execute("INSERT INTO s SELECT range % 500 FROM range(5000)")
    # small inputs: exact (like the reference's sparse representation)
    assert con.execute("SELECT approx_count_distinct(v) FROM s") \
        .fetchall() == [(500,)]
    rng = np.random.default_rng(2)
    con.register("big", {"v": rng.integers(0, 80_000, 300_000)})
    est = con.execute("SELECT approx_count_distinct(v) FROM big") \
        .fetchall()[0][0]
    true = con.execute("SELECT count(DISTINCT v) FROM big") \
        .fetchall()[0][0]
    assert abs(est - true) / true < 0.05
    # grouped stays exact
    rows = con.execute("SELECT v % 3, approx_count_distinct(v) FROM s "
                       "GROUP BY 1 ORDER BY 1").fetchall()
    assert [r[1] for r in rows] == [167, 167, 166]
