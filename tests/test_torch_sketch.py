"""ddb_tpu_torch.ops.sketch against ddb_tpu.ops.sketch on the same
numpy-seeded inputs.  HyperLogLog registers are integers and must match
exactly; estimates and digests are float64 sums taken in another order,
so they are held to 1e-12 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddb_tpu.ops import sketch as ref
from test_torch_reference_jit import (fast_reference_compiles,  # noqa: F401
                                      jitted_module)
from ddb_tpu_torch.ops import sketch as port

# the reference's operators under jax.jit (test_torch_reference_jit.py)
ref = jitted_module(ref)

RTOL = 1e-12


def _inputs(n, distinct, seed, null_share=0.1, dead_share=0.2):
    rng = np.random.default_rng(seed)
    values = rng.integers(-distinct, distinct, n)
    sel = rng.random(n) >= dead_share
    nulls = rng.random(n) < null_share
    return values, sel, nulls


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("n,distinct,with_nulls", [
    (4096, 40, True), (4096, 3000, True), (4096, 10**9, False),
    (4096, 1, False)])
def test_hll_registers_exact(n, distinct, with_nulls):
    values, sel, nulls = _inputs(n, distinct, seed=n + distinct % 97)
    nulls = nulls if with_nulls else None
    want = np.asarray(ref.hll_registers(
        jnp.asarray(values), jnp.asarray(sel),
        None if nulls is None else jnp.asarray(nulls)))
    got = port.hll_registers(_t(values), _t(sel),
                             None if nulls is None else _t(nulls))
    assert got.dtype == torch.int32 and got.shape == (port.HLL_M,)
    assert np.array_equal(got.numpy(), want)


def test_hll_registers_of_no_live_row_are_zero():
    values, sel, _ = _inputs(256, 10, seed=3)
    got = port.hll_registers(_t(values), _t(np.zeros_like(sel)))
    assert int(got.sum()) == 0
    assert int(port.hll_estimate(got)) == \
        int(ref.hll_estimate(jnp.zeros(ref.HLL_M, jnp.int32))) == 0


@pytest.mark.parametrize("n,distinct", [(4096, 40), (4096, 1500),
                                        (4096, 10**9)])
def test_hll_estimate_and_merge(n, distinct):
    a = _inputs(n, distinct, seed=1)
    b = _inputs(n, distinct, seed=2)
    regs = [port.hll_registers(_t(v), _t(s), _t(m)) for v, s, m in (a, b)]
    rregs = [ref.hll_registers(jnp.asarray(v), jnp.asarray(s),
                               jnp.asarray(m)) for v, s, m in (a, b)]
    merged = port.hll_merge(*regs)
    assert np.array_equal(merged.numpy(), np.asarray(ref.hll_merge(*rregs)))
    for got, want in ((port.hll_estimate(regs[0]),
                       ref.hll_estimate(rregs[0])),
                      (port.hll_estimate(merged),
                       ref.hll_estimate(ref.hll_merge(*rregs))),
                      (port.hll_count_distinct(*map(_t, b)),
                       ref.hll_count_distinct(*map(jnp.asarray, b)))):
        assert got.dtype == torch.int64
        assert abs(int(got) - int(want)) <= RTOL * int(want)
    live = a[0][a[1] & ~a[2]]
    exact = len(np.unique(live))
    assert abs(int(port.hll_estimate(regs[0])) - exact) <= 0.05 * exact


def test_clz_of_every_leading_zero_count():
    x = np.array([1 << k for k in range(63)] + [-1, -2**63, 3 << 61,
                                                  (1 << 40) + 12345],
                 dtype=np.int64)
    want = [64 - (int(v) & (2**64 - 1)).bit_length() for v in x]
    assert port._clz64(_t(x)).tolist() == want


def _float_inputs(n, seed):
    rng = np.random.default_rng(seed)
    values = rng.normal(50, 20, n)
    values[rng.integers(0, n, n // 10)] = 7.5         # ties
    return values, rng.random(n) >= 0.25, rng.random(n) < 0.1


@pytest.mark.parametrize("n,k", [(1000, 256), (300, 16), (128, 256)])
def test_quantile_digest_matches(n, k):
    v, s, m = _float_inputs(n, seed=n)
    want = ref.quantile_digest(jnp.asarray(v), jnp.asarray(s),
                               jnp.asarray(m), k)
    got = port.quantile_digest(_t(v), _t(s), _t(m), k)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=0)
    assert float(got[1].sum()) == float((s & ~m).sum())


@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.99, 1.0])
def test_digest_merge_and_quantile_match(q):
    a, b = _float_inputs(1500, seed=5), _float_inputs(700, seed=6)
    pd = [port.quantile_digest(*map(_t, x)) for x in (a, b)]
    rd = [ref.quantile_digest(*map(jnp.asarray, x)) for x in (a, b)]
    pm = port.digest_merge(*pd[0], *pd[1])
    rm = ref.digest_merge(*rd[0], *rd[1])
    for g, w in zip(pm, rm):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=0)
    for (pc, pw), (rc, rw) in ((pd[0], rd[0]), (pm, rm)):
        np.testing.assert_allclose(
            float(port.digest_quantile(pc, pw, q)),
            float(ref.digest_quantile(rc, rw, q)), rtol=RTOL, atol=0)
    if 0.05 <= q <= 0.95:      # a centroid averages the tails away
        live = a[0][a[1] & ~a[2]]
        assert abs(float(port.digest_quantile(*pd[0], q))
                   - np.quantile(live, q)) < 2.0


def test_digest_of_no_live_row():
    v, s, m = _float_inputs(200, seed=9)
    dead = np.zeros_like(s)
    c, w = port.quantile_digest(_t(v), _t(dead), _t(m))
    rc, rw = ref.quantile_digest(jnp.asarray(v), jnp.asarray(dead),
                                 jnp.asarray(m))
    assert np.array_equal(c.numpy(), np.asarray(rc))
    assert np.array_equal(w.numpy(), np.asarray(rw)) and float(w.sum()) == 0
