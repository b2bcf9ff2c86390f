"""ddb_tpu_torch.ops.tpu_sort against ddb_tpu.ops.tpu_sort on the CPU.

The same operands, made from a numpy seed, go through both `sort_ops`:
below MIN_TWO_PHASE (one flat sort), at a whole number of runs, padded
to one, and over an odd number of runs (the cascade's padded row); with
one and two keys of int32, int64 and float64, payload operands, and
`is_stable=True`.  Keys must be equal exactly, and so must every operand
of a stable sort; where equal keys leave the order of ties to the
network, each key's payloads are compared as a multiset.
"""

import collections

import numpy as np
import pytest
import torch

from ddb_tpu.ops import tpu_sort as ref
from ddb_tpu_torch.ops import tpu_sort as port
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401
from test_torch_reference_jit import reference_jit

RUN, MIN = port.RUN, port.MIN_TWO_PHASE

SIZES = {
    "flat": 1000,
    "whole_runs": MIN,                 # 64 runs
    "padded": MIN + 77,                # 65 runs, the last one padded
    "odd_runs": RUN * 67,              # 67 runs: odd at the first level
}


def _keys(rng, dtype, n):
    if dtype == "float64":
        # few distinct values, so ties are common
        return np.round(rng.standard_normal(n), 2)
    hi = 50 if dtype == "int32" else 1 << 40
    return rng.integers(-hi, hi, n).astype(dtype)


def _operands(seed, n, key_dtypes, payloads):
    rng = np.random.default_rng(seed)
    ops = [_keys(rng, d, n) for d in key_dtypes]
    ops += [rng.integers(-2**31, 2**31, n).astype(np.int32)
            for _ in range(payloads)]
    return ops


def _both(ops, num_keys, is_stable):
    import jax.numpy as jnp
    # one compiled program: eager, each stage's shapes compile anew
    want = [np.asarray(v) for v in reference_jit(ref.sort_ops)(
        [jnp.asarray(v) for v in ops], num_keys=num_keys,
        is_stable=is_stable)]
    got = [v.numpy() for v in port.sort_ops(
        [torch.from_numpy(v) for v in ops], num_keys=num_keys,
        is_stable=is_stable)]
    return want, got


def _by_key(out, num_keys):
    """{key tuple: Counter of payload tuples}."""
    groups = collections.defaultdict(collections.Counter)
    for row in zip(*[v.tolist() for v in out]):
        groups[row[:num_keys]][row[num_keys:]] += 1
    return groups


CASES = [
    # (key dtypes, payload operands, is_stable)
    (("int64",), 0, False),
    (("int32",), 1, False),
    (("float64",), 1, False),
    (("int32", "int64"), 1, False),
    (("int32", "float64"), 2, True),
    (("int64",), 1, True),
]


# every case below MIN_TWO_PHASE; above it, each case at one size or more
# and each size with ties, payloads and a stable sort (each reference
# program compiles for seconds)
_MATRIX = [("flat", c) for c in CASES] + [
    ("whole_runs", CASES[0]), ("whole_runs", CASES[2]),
    ("whole_runs", CASES[5]),
    ("padded", CASES[1]), ("padded", CASES[3]), ("padded", CASES[4]),
    ("odd_runs", CASES[1]), ("odd_runs", CASES[2]), ("odd_runs", CASES[4])]


@pytest.mark.parametrize("size, keys, payloads, stable",
                         [(s, *c) for s, c in _MATRIX],
                         ids=lambda c: str(c))
def test_sort_ops_equals_the_reference(size, keys, payloads, stable):
    n = SIZES[size]
    ops = _operands(7 + n, n, keys, payloads)
    want, got = _both(ops, len(keys), stable)
    assert [v.dtype for v in got] == [v.dtype for v in ops]
    assert [len(v) for v in got] == [n] * len(ops)
    for w, g in zip(want[:len(keys)], got[:len(keys)]):
        np.testing.assert_array_equal(g, w)
    # sorted lexicographically, as numpy's lexsort orders the input
    order = np.lexsort(ops[:len(keys)][::-1])
    for v, g in zip(ops[:len(keys)], got[:len(keys)]):
        np.testing.assert_array_equal(g, v[order])
    if stable:
        for v, w, g in zip(ops, want, got):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, v[order])
    elif payloads:
        assert _by_key(got, len(keys)) == _by_key(want, len(keys))


def test_unique_keys_sort_as_torch_sort():
    """The probe's keys: unique by their low bits, so every operand of
    the result is fixed (bench/sort_probe.py holds the card to this)."""
    from ddb_tpu_torch.bench import sort_probe
    keys = sort_probe.make_keys(RUN * 65 + 3, seed=0, device="cpu")
    (out,) = port.sort_ops([keys])
    torch.testing.assert_close(out, torch.sort(keys).values, rtol=0, atol=0)
    out, pay = port.sort_ops([keys, sort_probe.payload(keys)])
    torch.testing.assert_close(out, torch.sort(keys).values, rtol=0, atol=0)
    torch.testing.assert_close(pay, sort_probe.payload(out), rtol=0, atol=0)


def test_constants_are_the_reference_s():
    assert (port.RUN, port.MIN_TWO_PHASE) == (ref.RUN, ref.MIN_TWO_PHASE)


def test_the_probe_s_check_holds_on_the_cpu():
    from ddb_tpu_torch.bench import sort_probe
    keys = sort_probe.make_keys(MIN + 5, seed=3, device="cpu")
    assert sort_probe.check(keys) == {"mismatched_operands": 0,
                                      "max_abs_err": 0}
    with pytest.raises(RuntimeError, match="CUDA device"):
        sort_probe.run(64, device="cpu")
