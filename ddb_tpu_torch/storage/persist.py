"""Database persistence: save/load via the native dtbfile library.

Python side of the single-file storage engine (C++ core in
native/dtbfile.cpp; reference counterpart src/storage/ checkpoint path,
SURVEY.md section 2.7).  The catalog (tables, column types, dictionaries'
layout, blob offsets/checksums) serializes to JSON; column data, null
masks and dictionary UTF-8 serialize as raw blobs.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
from typing import List, Optional

import numpy as np

from .. import types as T
from ..types import DataType, TypeId
from .strings import StringDictionary
from .table import TableColumn, TableData

_LIB = None


def _native_dir():
    return os.path.join(os.path.dirname(__file__), "..", "..", "native")


def _lib_path():
    # the port's own build directory: native/ is the reference's
    return os.path.join(os.path.dirname(__file__), "..", "_build",
                        "libdtbfile.so")


def build_native(force: bool = False) -> str:
    """Compile the C++ storage library (g++, baked into the image).  The
    compiler writes a name of its own, which then replaces the library
    whole, so processes that build at once never load a partial file."""
    src = os.path.join(_native_dir(), "dtbfile.cpp")
    out = _lib_path()
    if not force and os.path.exists(out) and \
            os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    import tempfile
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=os.path.dirname(out))
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, src, "-lz"],
            check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _load_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    path = build_native()
    lib = ctypes.CDLL(path)
    lib.dtb_write.restype = ctypes.c_int
    lib.dtb_write.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint64]
    lib.dtb_read_catalog.restype = ctypes.c_void_p
    lib.dtb_read_catalog.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64)]
    lib.dtb_read_blob.restype = ctypes.c_int
    lib.dtb_read_blob.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_void_p]
    lib.dtb_checksum.restype = ctypes.c_uint64
    lib.dtb_checksum.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.dtb_free.argtypes = [ctypes.c_void_p]
    for fn in ("dtb_rle_compress", "dtb_zlib_compress"):
        f = getattr(lib, fn)
        f.restype = ctypes.c_int64
        f.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
                      ctypes.c_uint64]
    for fn in ("dtb_rle_decompress", "dtb_zlib_decompress"):
        f = getattr(lib, fn)
        f.restype = ctypes.c_int64
        f.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
                      ctypes.c_uint64]
    lib.dtb_delta_compress.restype = ctypes.c_int64
    lib.dtb_delta_compress.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.c_uint64]
    lib.dtb_delta_decompress.restype = ctypes.c_int64
    lib.dtb_delta_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.c_uint64]
    for fn in ("dtb_fsst_compress", "dtb_fsst_decompress"):
        f = getattr(lib, fn)
        f.restype = ctypes.c_int64
        f.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
                      ctypes.c_uint64]
    for fn in ("dtb_xorf_compress", "dtb_xorf_decompress",
               "dtb_bitpack_compress", "dtb_bitpack_decompress",
               "dtb_alp_compress", "dtb_alp_decompress"):
        f = getattr(lib, fn)
        f.restype = ctypes.c_int64
        f.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32,
                      ctypes.c_char_p, ctypes.c_uint64]
    for fn in ("dtb_roaring_compress", "dtb_roaring_decompress"):
        f = getattr(lib, fn)
        f.restype = ctypes.c_int64
        f.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
                      ctypes.c_uint64]
    _LIB = lib
    return lib


# blob codecs (native/dtbfile.cpp; reference: src/storage/compression/ —
# codec ids: 0 raw, 1 byte-RLE, 2 delta-varint, 3 zlib, 4 FSST-style
# digram, 5 Chimp-class XOR-float, 6 frame-of-reference bitpacking,
# 7 ALP-class decimal-scaled floats, 8 roaring-class validity)
_RAW, _RLE, _DELTA, _ZLIB, _FSST, _XORF = 0, 1, 2, 3, 4, 5
_BITPACK, _ALP, _ROARING = 6, 7, 8


def _compress_blob(lib, data: bytes, kind: str, elem: int = 0):
    """Analyze the candidate codecs for the payload kind and keep the
    smallest (the reference's analyze-all-then-pick-best per segment,
    table/column_data_checkpointer.cpp:157).  Returns (codec, payload)."""
    if len(data) < 64:
        return _RAW, data
    cap = len(data) - 1        # only accept a strict win
    best = (_RAW, data)

    def consider(codec, n, buf):
        nonlocal best
        if n > 0 and n < len(best[1]):
            best = (codec, buf.raw[:n])

    if kind == "mask":
        buf = ctypes.create_string_buffer(cap)
        consider(_RLE, lib.dtb_rle_compress(data, len(data), buf, cap),
                 buf)
        buf = ctypes.create_string_buffer(cap)
        consider(_ROARING, lib.dtb_roaring_compress(data, len(data),
                                                    buf, cap), buf)
    elif kind == "ints" and elem in (4, 8):
        buf = ctypes.create_string_buffer(cap)
        consider(_DELTA, lib.dtb_delta_compress(data, len(data), elem,
                                                buf, cap), buf)
        buf = ctypes.create_string_buffer(cap)
        consider(_BITPACK, lib.dtb_bitpack_compress(
            data, len(data), elem, buf, cap), buf)
    elif kind == "floats" and elem in (4, 8):
        buf = ctypes.create_string_buffer(cap)
        consider(_XORF, lib.dtb_xorf_compress(data, len(data), elem,
                                              buf, cap), buf)
        buf = ctypes.create_string_buffer(cap)
        consider(_ALP, lib.dtb_alp_compress(data, len(data), elem,
                                            buf, cap), buf)
    elif kind == "text":
        buf = ctypes.create_string_buffer(cap)
        consider(_FSST, lib.dtb_fsst_compress(data, len(data), buf,
                                              cap), buf)
    buf = ctypes.create_string_buffer(cap)
    consider(_ZLIB, lib.dtb_zlib_compress(data, len(data), buf, cap),
             buf)
    return best


def _decompress_blob(lib, codec: int, data: bytes, raw_len: int,
                     elem: int = 0) -> bytes:
    if codec == _RAW:
        return data
    buf = ctypes.create_string_buffer(raw_len)
    if codec == _RLE:
        n = lib.dtb_rle_decompress(data, len(data), buf, raw_len)
    elif codec == _DELTA:
        n = lib.dtb_delta_decompress(data, len(data), elem, buf, raw_len)
    elif codec == _ZLIB:
        n = lib.dtb_zlib_decompress(data, len(data), buf, raw_len)
    elif codec == _FSST:
        n = lib.dtb_fsst_decompress(data, len(data), buf, raw_len)
    elif codec == _XORF:
        n = lib.dtb_xorf_decompress(data, len(data), elem, buf, raw_len)
    elif codec == _BITPACK:
        n = lib.dtb_bitpack_decompress(data, len(data), elem, buf,
                                       raw_len)
    elif codec == _ALP:
        n = lib.dtb_alp_decompress(data, len(data), elem, buf, raw_len)
    elif codec == _ROARING:
        n = lib.dtb_roaring_decompress(data, len(data), buf, raw_len)
    else:
        raise IOError(f"unknown blob codec {codec}")
    if n != raw_len:
        raise IOError("blob decompression failed (corrupt file)")
    return buf.raw


def _dict_blob(sd: StringDictionary) -> bytes:
    parts = []
    for s in sd.values:
        b = str(s).encode("utf-8")
        parts.append(len(b).to_bytes(4, "little"))
        parts.append(b)
    return b"".join(parts)


def _dict_from_blob(b: bytes, count: int) -> StringDictionary:
    out = []
    pos = 0
    for _ in range(count):
        ln = int.from_bytes(b[pos:pos + 4], "little")
        pos += 4
        out.append(b[pos:pos + ln].decode("utf-8"))
        pos += ln
    return StringDictionary(np.asarray(out, dtype=object).astype(str)
                            if out else np.array([], dtype=object)
                            .astype(str))


def save_database(catalog, path: str) -> None:
    lib = _load_lib()
    blobs: List[bytes] = []
    meta = {"tables": []}
    offset = [0]

    def add_blob(data: bytes, kind: str = "raw", elem: int = 0):
        raw_len = len(data)
        codec, payload = _compress_blob(lib, data, kind, elem)
        off = offset[0]
        blobs.append(payload)
        offset[0] += len(payload)
        csum = lib.dtb_checksum(payload, len(payload)) if payload else 0
        m = {"offset": off, "length": len(payload), "checksum": csum}
        if codec != _RAW:
            m["codec"] = codec
            m["raw_len"] = raw_len
            if codec in (_DELTA, _XORF, _BITPACK, _ALP):
                m["elem"] = elem
        return m

    for name, td in sorted(catalog.tables.items()):
        tmeta = {"name": name, "num_rows": td.num_rows, "columns": []}
        if getattr(td, "constraints", None):
            tmeta["constraints"] = [[k, list(c)]
                                    for k, c in td.constraints]
        if getattr(td, "foreign_keys", None):
            tmeta["foreign_keys"] = [[list(c), pt, list(pc)]
                                     for c, pt, pc in td.foreign_keys]
        if getattr(td, "not_null", None):
            tmeta["not_null"] = sorted(td.not_null)
        if getattr(td, "enum_domains", None):
            tmeta["enum_domains"] = {k: [v[0], sorted(v[1])]
                                     for k, v in td.enum_domains.items()}
        if getattr(td, "bit_columns", None):
            tmeta["bit_columns"] = sorted(td.bit_columns)
        if getattr(td, "collate_columns", None):
            tmeta["collate_columns"] = dict(td.collate_columns)
        if getattr(td, "defaults", None):
            tmeta["defaults"] = dict(td.defaults)
        user_ix = [ix for ix in getattr(td, "indexes", {}).values()
                   if not ix.name.startswith("__")]
        if user_ix:
            # definitions only: sorted-key state rebuilds lazily on first
            # probe (reference persists ART pages; our build is one
            # vectorized lexsort, cheap relative to load)
            tmeta["indexes"] = [[ix.name, list(ix.columns), ix.unique]
                                for ix in user_ix]
        for c in td.columns:
            cm = {
                "name": c.name,
                "type": c.dtype.id.name,
                "width": c.dtype.width,
                "scale": c.dtype.scale,
                "dtype": str(c.data.dtype),
            }
            kind = "ints" if c.data.dtype.kind in "iu" else (
                "floats" if c.data.dtype.kind == "f" else "raw")
            cm["data"] = add_blob(np.ascontiguousarray(c.data).tobytes(),
                                  kind, c.data.dtype.itemsize)
            if c.nulls is not None:
                cm["nulls"] = add_blob(
                    np.ascontiguousarray(c.nulls).tobytes(), "mask")
            if c.strdict is not None:
                cm["dict_count"] = len(c.strdict)
                cm["dict"] = add_blob(_dict_blob(c.strdict), "text")
            tmeta["columns"].append(cm)
        meta["tables"].append(tmeta)
    meta["views"] = {n: list(v) for n, v in catalog.views.items()}
    meta["enums"] = {n: list(v) for n, v in
                     getattr(catalog, "enums", {}).items()}
    meta["sequences"] = {n: dict(s) for n, s in
                         getattr(catalog, "sequences", {}).items()}
    meta["macros"] = {n: dict(m) for n, m in
                      getattr(catalog, "macros", {}).items()}
    meta["schemas"] = sorted(getattr(catalog, "schemas", ("main",)))

    cat_json = json.dumps(meta).encode("utf-8")
    n = len(blobs)
    arr_p = (ctypes.c_void_p * n)()
    arr_s = (ctypes.c_uint64 * n)()
    keepalive = []
    for i, b in enumerate(blobs):
        buf = ctypes.create_string_buffer(b, len(b))
        keepalive.append(buf)
        arr_p[i] = ctypes.cast(buf, ctypes.c_void_p)
        arr_s[i] = len(b)
    rc = lib.dtb_write(path.encode(), cat_json, len(cat_json), arr_p,
                       arr_s, n)
    if rc != 0:
        raise IOError(f"dtb_write failed with code {rc}")


def load_database(catalog, path: str, prefix: str = "") -> None:
    """Load a .dtb file into `catalog`; `prefix` ("db.") namespaces the
    loaded entries for ATTACH (reference: src/main/attached_database.cpp)."""
    lib = _load_lib()
    clen = ctypes.c_uint64()
    doff = ctypes.c_uint64()
    p = lib.dtb_read_catalog(path.encode(), ctypes.byref(clen),
                             ctypes.byref(doff))
    if not p:
        raise IOError(f"cannot read database file {path}")
    try:
        meta = json.loads(ctypes.string_at(p, clen.value))
    finally:
        lib.dtb_free(p)
    base = doff.value

    def read_blob(bm) -> bytes:
        buf = ctypes.create_string_buffer(bm["length"])
        rc = lib.dtb_read_blob(path.encode(), base + bm["offset"],
                               bm["length"], buf)
        if rc != 0:
            raise IOError(f"blob read failed ({rc})")
        data = buf.raw
        if lib.dtb_checksum(data, len(data)) != bm["checksum"] \
                and bm["length"]:
            raise IOError("blob checksum mismatch (corrupt file)")
        codec = bm.get("codec", _RAW)
        if codec != _RAW:
            data = _decompress_blob(lib, codec, data, bm["raw_len"],
                                    bm.get("elem", 0))
        return data

    for tmeta in meta["tables"]:
        cols = []
        for cm in tmeta["columns"]:
            dt = DataType(TypeId[cm["type"]], cm["width"], cm["scale"])
            data = np.frombuffer(read_blob(cm["data"]),
                                 dtype=np.dtype(cm["dtype"])).copy()
            nulls = None
            if "nulls" in cm:
                nulls = np.frombuffer(read_blob(cm["nulls"]),
                                      dtype=np.bool_).copy()
            sd = None
            if "dict" in cm:
                sd = _dict_from_blob(read_blob(cm["dict"]),
                                     cm["dict_count"])
            cols.append(TableColumn(cm["name"], dt, data, nulls, sd))
        td = TableData(prefix + tmeta["name"], cols)
        if tmeta.get("constraints"):
            td.constraints = [(k, list(c))
                              for k, c in tmeta["constraints"]]
        if tmeta.get("foreign_keys"):
            td.foreign_keys = [(list(c), pt, list(pc))
                               for c, pt, pc in tmeta["foreign_keys"]]
        if tmeta.get("not_null"):
            td.not_null = set(tmeta["not_null"])
        if tmeta.get("enum_domains"):
            td.enum_domains = {k: (v[0], frozenset(v[1]))
                               for k, v in tmeta["enum_domains"].items()}
        if tmeta.get("bit_columns"):
            td.bit_columns = set(tmeta["bit_columns"])
        if tmeta.get("collate_columns"):
            td.collate_columns = dict(tmeta["collate_columns"])
        if tmeta.get("defaults"):
            td.defaults = dict(tmeta["defaults"])
        if tmeta.get("indexes"):
            from .index import SortedIndex
            for nm, ixcols, uniq in tmeta["indexes"]:
                td.indexes[nm] = SortedIndex(nm, list(ixcols), uniq)
        catalog.add_table(td, or_replace=True)
    for name, v in meta.get("enums", {}).items():
        catalog.enums[prefix + name] = list(v)
    for name, v in meta.get("views", {}).items():
        catalog.add_view(prefix + name, v[0], or_replace=True,
                         column_aliases=v[1])
    for name, s in meta.get("sequences", {}).items():
        catalog.sequences[prefix + name] = dict(s)
    for name, m in meta.get("macros", {}).items():
        catalog.macros[prefix + name] = dict(m)
    for name in meta.get("schemas", ()):
        if name != "main":
            catalog.schemas.add(prefix + name)
