"""ddb_tpu_torch.ops.hashing against ddb_tpu.ops.hashing, bit for bit.

The reference hashes in uint64; the port holds the same bit patterns in
int64 tensors, so the reference's results are viewed as int64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddb_tpu.ops import hashing as ref
from ddb_tpu_torch.ops import hashing as port
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401

EDGES = [0, 1, -1, 2**62, -2**62, 2**63 - 1, -2**63, 123456789]


def _values(dtype):
    rng = np.random.default_rng(11)
    info = np.iinfo(dtype)
    rand = rng.integers(info.min, info.max, 4096, dtype=dtype, endpoint=True)
    edges = [e for e in EDGES if info.min <= e <= info.max]
    return np.concatenate([np.array(edges, dtype=dtype), rand])


def _bits(x):
    return np.asarray(x).view(np.int64)


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.int16])
def test_hash64_bit_exact(dtype):
    x = _values(dtype)
    got = port.hash64(torch.from_numpy(x))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), _bits(ref.hash64(jnp.asarray(x))))


def test_hash64_edge_values_one_by_one():
    for e in EDGES:
        want = _bits(ref.hash64(jnp.asarray([e], dtype=jnp.int64)))[0]
        assert int(port.hash64(torch.tensor([e]))[0]) == int(want), e


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_hash_combine_bit_exact(dtype):
    x, y = _values(np.int64), _values(dtype)[:len(_values(np.int64))]
    x = x[:len(y)]
    h_ref = ref.hash64(jnp.asarray(x))
    h_port = port.hash64(torch.from_numpy(x))
    got = port.hash_combine(h_port, torch.from_numpy(y))
    assert np.array_equal(got.numpy(),
                          _bits(ref.hash_combine(h_ref, jnp.asarray(y))))


@pytest.mark.parametrize("parts", [1, 2, 7, 64, 1000])
def test_partition_of_matches(parts):
    x = _values(np.int64)
    got = port.partition_of(port.hash64(torch.from_numpy(x)), parts)
    want = np.asarray(ref.partition_of(ref.hash64(jnp.asarray(x)), parts))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() < parts


@pytest.mark.parametrize("k", [1, 2, 27, 33, 63])
def test_logical_shift_matches_uint64(k):
    x = _values(np.int64)
    want = (x.view(np.uint64) >> np.uint64(k)).view(np.int64)
    assert np.array_equal(port.lshr(torch.from_numpy(x), k).numpy(), want)
