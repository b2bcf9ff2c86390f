"""Operators and kernels layer: the share (%) of the card's busy time in
the traced window that sort kernels take: the union of the intervals of
kernels named as a sort (cub's DeviceRadixSort, DeviceSegmentedRadixSort,
DeviceMergeSort and DeviceSegmentedSort; torch's in-place sorts of short
rows, radixSortKVInPlace, warpMergeSortKVInPlace, bitonicSortKVInPlace)
over the union of every kernel, copy and memset interval.  None without
kernels.  Moves queries_per_s."""

import re

from portbench.trace import Trace, covered_us, device_busy_us

SORT_KERNEL = re.compile(r"radixsort|mergesort|segmentedsort|bitonicsort",
                         re.IGNORECASE)


def read(t: Trace):
    busy = device_busy_us(t)
    if not t.kernels or not busy:
        return None
    sorts = [k for k in t.inside(t.kernels) if SORT_KERNEL.search(k[2])]
    return 100.0 * covered_us(sorts) / busy
