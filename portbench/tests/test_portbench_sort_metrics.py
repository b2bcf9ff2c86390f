"""The two sort metrics (metrics/sort_passes_per_query.py,
metrics/sort_busy_pct.py) on synthetic traces."""

import pytest

from portbench import trace
from portbench.harness import reader

SORT = "ddb.exec.sort"
ONESWEEP = "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<...>"
HISTOGRAM = "void at_cuda_detail::cub::DeviceRadixSortHistogramKernel<...>"


def _trace(kernels=(), copies=(), spans=(), queries=2):
    return trace.Trace(window=(0.0, 1000.0), kernels=list(kernels),
                       copies=list(copies), spans=list(spans),
                       queries=queries)


def test_sort_passes_count_the_windows_spans_over_its_requests():
    t = _trace(kernels=[(0.0, 1.0, "k")],
               spans=[(-50.0, -10.0, SORT),          # before the window
                      (10.0, 900.0, "ddb.exec.Aggregate"),
                      (20.0, 30.0, SORT), (40.0, 60.0, SORT),
                      (950.0, 1010.0, SORT),         # ends after it
                      (1100.0, 1200.0, SORT),        # after the window
                      (200.0, 300.0, "ddb.exec.Window"),
                      (210.0, 220.0, "ddb.exec.sorted")])
    assert reader("sort_passes_per_query")(t) == pytest.approx(3 / 2)
    t.queries = 3
    assert reader("sort_passes_per_query")(t) == pytest.approx(1.0)


def test_sort_passes_find_nothing_without_sort_spans_or_requests():
    # the parent program records no ddb.exec.sort span
    t = _trace(kernels=[(0.0, 1.0, "k")],
               spans=[(10.0, 900.0, "ddb.exec.Aggregate")])
    assert reader("sort_passes_per_query")(t) is None
    t = _trace(spans=[(10.0, 20.0, SORT)], queries=0)
    assert reader("sort_passes_per_query")(t) is None


def test_sort_busy_counts_overlapping_sort_kernels_once():
    # busy: [100, 400) and the copy [600, 700): 400 us; sorts [100, 250)
    # and [200, 300) overlap: 200 us of it
    t = _trace(kernels=[(100.0, 250.0, ONESWEEP), (200.0, 300.0, HISTOGRAM),
                        (250.0, 400.0, "void gather_kernel<...>"),
                        (1200.0, 1300.0, ONESWEEP)],   # outside the window
               copies=[(600.0, 700.0, "Memcpy HtoD")])
    assert reader("sort_busy_pct")(t) == pytest.approx(50.0)


@pytest.mark.parametrize("name", [
    "void cub::DeviceSegmentedRadixSortKernel<...>",
    "void cub::DeviceMergeSortBlockSortKernel<...>",
    "void cub::DeviceSegmentedSortKernelSmall<...>",
    "void at::native::radixSortKVInPlace<...>",
    "void at::native::warpMergeSortKVInPlace<...>",
    "void at::native::bitonicSortKVInPlace<...>",
])
def test_every_sort_kernel_counts(name):
    t = _trace(kernels=[(0.0, 100.0, name), (100.0, 400.0, "k")])
    assert reader("sort_busy_pct")(t) == pytest.approx(25.0)


def test_sort_busy_ignores_other_kernels_and_needs_kernels():
    t = _trace(kernels=[(0.0, 100.0, "void at::native::index_add<...>"),
                        (100.0, 200.0, "void searchsorted_cuda_kernel")])
    assert reader("sort_busy_pct")(t) == 0.0
    t = _trace(copies=[(0.0, 100.0, "Memcpy HtoD")])
    assert reader("sort_busy_pct")(t) is None
