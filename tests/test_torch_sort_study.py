"""The sort probes bench/sort_study.py, bench/sort_phase1.py and
bench/sort_merge.py (ports of scripts/bench_sort_study.py,
scripts/exp_sort_phase1.py and scripts/exp_sort_merge.py) on the CPU:
every case against numpy, exactly, at a power of two and at a size that
is not one; the plain vpu_chain against a numpy chain; the result keys
against the scripts' own names; the numpy checks the modules run on the
card against wrong answers.  The scripts run JAX on a TPU and are read
here as text only.
"""

import os
import re

import numpy as np
import pytest
import torch

from ddb_tpu_torch.bench import sort_merge, sort_phase1, sort_study
from ddb_tpu_torch.ops import vpu_chain

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SIZES = [1 << 16, 3 << 15]      # 98,304: not a power of two


def _np(x):
    return x.numpy()


def _script(name):
    with open(os.path.join(_ROOT, "scripts", name)) as f:
        return f.read()


@pytest.mark.parametrize("n", SIZES)
def test_sort_study_cases_equal_numpy(n):
    k64, rid, k32 = sort_study.inputs(n)
    fns = sort_study.case_fns(*map(torch.from_numpy, (k64, rid, k32)))
    stable = np.argsort(k64, kind="stable")
    sk, srid = fns["twoop"]()
    assert np.array_equal(_np(sk), np.sort(k64))
    assert np.array_equal(_np(srid), stable)
    packed = (k64 << sort_study.RID_BITS) | rid.astype(np.int64)
    assert np.array_equal(_np(fns["packed"]()), np.sort(packed))
    # below 2^23 rows the packed word's low bits are the stable order
    assert np.array_equal(_np(fns["packed"]()) & ((1 << 23) - 1), stable)
    assert np.array_equal(_np(fns["engine_adaptive"]()), stable)
    assert np.array_equal(_np(fns["int32_1op"]()), np.sort(k32))
    rows = k64[:48 * (n // 48)].reshape(48, -1)
    assert np.array_equal(_np(fns["batched_48x128k"]()),
                          np.sort(rows, axis=1))


@pytest.mark.parametrize("n", SIZES)
def test_sort_phase1_cases_equal_numpy(n):
    k, pay = sort_phase1.inputs(n)
    hi, lo = sort_phase1.limbs(k)
    fns = sort_phase1.case_fns(*map(torch.from_numpy, (k, pay, hi, lo)))
    sk, sp = fns["flat"]()
    assert np.array_equal(_np(sk), np.sort(k))
    assert np.array_equal(_np(sp), np.argsort(k, kind="stable"))
    for s in sort_phase1.ROWS:
        t = n // s
        kb = k[:t * s].reshape(t, s)
        sk, sp = fns[f"b{s}"]()
        assert np.array_equal(_np(sk), np.sort(kb, axis=1)), s
        want = np.argsort(kb, axis=1, kind="stable") + s * np.arange(t)[
            :, None]
        assert np.array_equal(_np(sp), want), s
    h, l_, p = fns["b2048_i32"]()
    t = n // 2048
    hb, lb = hi[:t * 2048].reshape(t, 2048), lo[:t * 2048].reshape(t, 2048)
    perm = np.lexsort((lb, hb), axis=-1)
    assert np.array_equal(_np(p), perm + 2048 * np.arange(t)[:, None])
    assert np.array_equal(_np(h), np.take_along_axis(hb, perm, 1))
    assert np.array_equal(_np(l_), np.take_along_axis(lb, perm, 1))


def test_flat_i32_is_the_lexsort_of_the_signed_limbs():
    """The limb pair with lo signed orders as np.lexsort((lo, hi)), not as
    the int64 keys: a lo at or above 2^31 reads negative."""
    k, pay = sort_phase1.inputs(1 << 14)
    hi, lo = sort_phase1.limbs(k)
    assert (lo < 0).any() and (lo > 0).any()
    h, l_, p = sort_phase1.case_fns(*map(torch.from_numpy,
                                         (k, pay, hi, lo)))["flat_i32"]()
    want = np.lexsort((lo, hi))
    assert np.array_equal(_np(p), want)
    assert np.array_equal(_np(h), hi[want]) and np.array_equal(_np(l_),
                                                               lo[want])
    assert not np.array_equal(want, np.argsort(k, kind="stable"))


@pytest.mark.parametrize("n", SIZES + [sort_merge.CHECK_N])
def test_sort_merge_cases_equal_numpy(n):
    k = sort_merge.inputs(n)
    assert len(np.unique(k)) == n
    for name, fn in sort_merge.FNS.items():
        assert np.array_equal(_np(fn(torch.from_numpy(k))), np.sort(k)), name


def test_merge_cascade_pads_odd_rows_and_hand_full_any_length():
    rng = np.random.default_rng(3)
    # 3 rows of 512: the cascade pads a row of int64's maximum twice
    k = rng.integers(-(1 << 62), 1 << 62, 3 * 512)
    k[:4] = [np.iinfo(np.int64).max, np.iinfo(np.int64).min, 0, 0]
    assert np.array_equal(_np(sort_merge.b512_merge(torch.from_numpy(k))),
                          np.sort(k))
    for n in (1, 2, 5, 1000):
        x = rng.integers(-50, 50, n)
        assert np.array_equal(_np(sort_merge.hand_full(torch.from_numpy(x))),
                              np.sort(x)), n
    with pytest.raises(ValueError, match="whole rows"):
        sort_merge.b512_merge(torch.zeros(1000, dtype=torch.int64))


def _numpy_chain(x, bounds, add):
    y = (x.astype(np.int64) + add).astype(np.int32)    # wraps
    for c in range(len(bounds) // 2):
        y = np.minimum(np.maximum(y, bounds[2 * c]), bounds[2 * c + 1])
    return y


@pytest.mark.parametrize("which", ["reference", "random"])
def test_plain_vpu_chain_equals_a_numpy_chain(which):
    rng = np.random.default_rng(4)
    x = rng.integers(-2**31, 2**31, 5000).astype(np.int32)
    x[:2] = [2**31 - 1, -2**31]
    if which == "reference":
        bounds = vpu_chain.reference_bounds()
        c = np.arange(48)
        assert np.array_equal(bounds[0::2], -c)
        assert np.array_equal(bounds[1::2], 1 << (c % 24))
    else:
        bounds = np.sort(rng.integers(-2**31, 2**31, 96)).astype(np.int32)
        bounds = rng.permutation(bounds)
    for add in (0, 1, 2**31 - 1):
        want = _numpy_chain(x, bounds, add)
        got = vpu_chain.vpu_chain(torch.from_numpy(x), bounds, add)
        assert got.dtype == torch.int32
        assert np.array_equal(_np(got), want), add
        assert np.array_equal(_np(vpu_chain.vpu_chain_plain(
            torch.from_numpy(x), bounds, add)), want), add
    assert vpu_chain.LAUNCHES["vpu_chain"] == 0      # plain on the CPU
    with pytest.raises(ValueError, match="96"):
        vpu_chain.vpu_chain(torch.from_numpy(x), bounds[:95])
    with pytest.raises(ValueError, match="int32"):
        vpu_chain.vpu_chain(torch.from_numpy(x).long(), bounds)


def test_result_keys_are_the_scripts_names():
    study = _script("bench_sort_study.py")
    phase1 = _script("exp_sort_phase1.py")
    merge = _script("exp_sort_merge.py")
    assert set(re.findall(r'run\("(\w+)"', study)) | {"vpu_chain"} == \
        set(sort_study.CASES)
    assert 'out["vpu_chain"]' in study
    assert set(re.findall(r'report\("([\w+]+)"', phase1)) | {
        f"b{s}" for s in sort_phase1.ROWS} == set(sort_phase1.CASES)
    assert f"for S in {sort_phase1.ROWS}" in phase1
    assert set(re.findall(r'report\("([\w+]+)"', merge)) == set(
        sort_merge.CASES)
    n = 3 << 15
    # One intra-op thread: the studies' many small ops wait on the thread
    # pool's barriers while other processes hold the cores (0.4 s alone,
    # 54 s beside seven busy processes, 0.8 s beside them on one thread).
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for mod in (sort_study, sort_phase1, sort_merge):
            rec = mod.run(n, device="cpu", runs=1)
            assert list(rec["results"]) == list(mod.CASES)
            assert rec["rows"] == n and rec["chip"] == "cpu (host)"
            assert all(r["ms"] > 0 for r in rec["results"].values())
        one = sort_phase1.run(n, device="cpu", cases=["b512"], runs=1)
    finally:
        torch.set_num_threads(threads)
    assert list(one["results"]) == ["b512"]


def test_the_modules_checks_catch_wrong_answers():
    k = np.array([5, 3, 5, 1, 3], dtype=np.int64)
    good = np.argsort(k, kind="stable")
    sort_study.check_lexsort("good", [k], good)
    for bad, what in ((np.array([3, 4, 1, 0, 2]), "tied rows"),
                      (np.array([1, 3, 4, 0, 2]), "out of order"),
                      (np.array([3, 1, 1, 0, 2]), "permutation"),
                      (np.array([3, 1, 4, 0, 5]), "permutation")):
        with pytest.raises(AssertionError, match=what):
            sort_study.check_lexsort("bad", [k], bad)
    hi = np.array([0, 0, 1, 0], dtype=np.int32)
    lo = np.array([2, -1, 0, 2], dtype=np.int32)
    sort_study.check_lexsort("pair", [hi, lo], np.lexsort((lo, hi)))
    with pytest.raises(AssertionError):
        sort_study.check_lexsort("pair", [hi, lo], np.array([1, 3, 0, 2]))
    rows = np.array([[3, 1, 3], [0, 0, -1]])
    sort_study.check_rows_lexsort("rows", [rows],
                                  np.argsort(rows, axis=1, kind="stable"))
    with pytest.raises(AssertionError):
        sort_study.check_rows_lexsort("rows", [rows],
                                      np.array([[1, 2, 0], [2, 0, 1]]))
    with pytest.raises(AssertionError, match="differ"):
        sort_study.same("x", np.array([1, 2]), np.array([1, 3]))


def test_the_probes_need_the_card_unless_told():
    import inspect
    for mod in (sort_study, sort_phase1, sort_merge):
        assert inspect.signature(mod.run).parameters[
            "device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        sort_study.run(1000)
