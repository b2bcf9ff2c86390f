"""How the port's tests run the reference package on the CPU, and checks
that it gives the same results so.

Most of the CPU time of the port's tests is the reference compiling: its
SQL plans compile through XLA, and an operator called outside `jax.jit`
compiles each primitive on its own, at each shape.  Two helpers cut that:

* `fast_reference_compiles`, an autouse fixture that a port test module
  imports: XLA's optimizations are off while the module's tests run (and
  back as they were after it).  Optimizations change no integer and no
  rounding the tests can see: integers compare exactly, floats to 1e-12.
* `reference_jit(fn)`: the reference operator under one `jax.jit`, its
  array arguments traced and everything else static, cached by the
  static parts and the arrays' shapes.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

_CACHE = {}


@pytest.fixture(scope="module", autouse=True)
def fast_reference_compiles():
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def reference_jit(fn):
    """fn(*args, **kw) under jax.jit: the arrays among the arguments'
    leaves are traced, the other leaves (strings, numbers, types) are
    static.  An operator that reads a value on the host while it runs, or
    returns something that is not an array, cannot be traced: it runs
    eagerly, as it would without the helper."""
    def call(*args, **kw):
        leaves, tree = jax.tree_util.tree_flatten((args, kw))
        traced = [isinstance(x, (jax.Array, np.ndarray)) for x in leaves]
        static = tuple(None if t else x for x, t in zip(leaves, traced))
        key = (fn, tree, static, tuple(traced))
        jitted = _CACHE.get(key)
        if jitted is None:
            def run(*arrays):
                it = iter(arrays)
                full = [next(it) if t else x for x, t in zip(leaves, traced)]
                a, k = jax.tree_util.tree_unflatten(tree, full)
                return fn(*a, **k)
            jitted = _CACHE[key] = jax.jit(run)
        if jitted is not _EAGER:
            try:
                return jitted(*[x for x, t in zip(leaves, traced) if t])
            except TypeError:
                _CACHE[key] = _EAGER
        return fn(*args, **kw)
    return call


class jitted_module:
    """A reference module whose functions run under `reference_jit`, but
    for those named `eager` (called with many static values, each of which
    would compile anew)."""

    def __init__(self, mod, eager=()):
        self._mod = mod
        self._eager = set(eager)

    def __getattr__(self, name):
        v = getattr(self._mod, name)
        if isinstance(v, types.FunctionType) and name not in self._eager:
            return reference_jit(v)
        return v


_EAGER = object()


def test_reference_jit_matches_eager():
    from ddb_tpu.ops import hashing
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.integers(-2**62, 2**62, 512))

    def parts(x, n):
        return hashing.partition_of(hashing.hash64(x), n)
    assert np.array_equal(np.asarray(parts(x, 7)),
                          np.asarray(reference_jit(parts)(x, 7)))


def test_reference_jit_caches_by_static_parts_and_shapes():
    f = reference_jit(lambda x, scale: x * scale)
    before = len(_CACHE)
    assert float(f(jnp.ones(4), 2.0)[0]) == 2.0
    assert float(f(jnp.full(4, 3.0), 2.0)[0]) == 6.0
    assert len(_CACHE) == before + 1
    assert float(f(jnp.ones(4), 5.0)[0]) == 5.0
    assert len(_CACHE) == before + 2


def test_optimizations_are_off_inside_the_module():
    assert jax.config.read("jax_disable_most_optimizations")
