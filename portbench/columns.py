"""Column kinds of the generated tables: how each goes to Arrow, and how
many bytes a row of it takes resident on the device.

A kind is a tuple: ("int32",), ("float64",), ("date",) for int32 days
since 1970-01-01, ("decimal", precision, scale) for an int64 scaled by
10**scale, ("dict", labels) for int32 codes into the tuple of labels,
("text",) for a pyarrow DictionaryArray that the generator made.
The program holds a string as int32 codes, a DECIMAL(15, 2) as an int64,
a DATE as int32 days: the widths below are of those forms, and the
roofline counts the same bytes whatever implements a query.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

WIDTH = {"int32": 4, "float64": 8, "date": 4, "decimal": 8, "dict": 4,
         "text": 4}


def width(kind) -> int:
    return WIDTH[kind[0]]


def seed_rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one stream of draws of a seed: any whole number,
    negative or above 64 bits too."""
    return np.random.default_rng([seed % 2**64, *stream]) if stream \
        else np.random.default_rng(seed % 2**64)


def to_arrow(values: np.ndarray, kind) -> pa.Array:
    """One column as the Arrow array a user would register: dictionary
    strings, decimal128, date32, int32, float64."""
    n = len(values)
    if kind[0] == "text":
        return values
    if kind[0] == "int32":
        return pa.array(np.ascontiguousarray(values, dtype=np.int32))
    if kind[0] == "float64":
        return pa.array(np.ascontiguousarray(values, dtype=np.float64))
    if kind[0] == "date":
        buf = np.ascontiguousarray(values, dtype=np.int32)
        return pa.Array.from_buffers(pa.date32(), n, [None, pa.py_buffer(buf)])
    if kind[0] == "decimal":
        words = np.empty((n, 2), dtype=np.int64)
        words[:, 0] = values
        words[:, 1] = words[:, 0] >> 63
        return pa.Array.from_buffers(pa.decimal128(kind[1], kind[2]), n,
                                     [None, pa.py_buffer(words)])
    if kind[0] == "dict":
        return pa.DictionaryArray.from_arrays(
            pa.array(np.ascontiguousarray(values, dtype=np.int32)),
            pa.array(list(kind[1]), type=pa.string()))
    raise ValueError(f"unknown column kind {kind!r}")


def arrow_table(columns: dict, kinds: dict) -> pa.Table:
    return pa.table({name: to_arrow(values, kinds[name])
                     for name, values in columns.items()})
