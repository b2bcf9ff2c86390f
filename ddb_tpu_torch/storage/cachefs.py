"""Caching filesystem for remote file reads (reference:
src/storage/caching_file_system.cpp — remote reads cache locally and
revalidate; tools/pythonpkg register_filesystem for fsspec handlers).

Zero-egress environment: no transport ships in-tree, but the SEAM is
the same as the reference's — any fsspec-style object with `open(path,
"rb")` (and optionally `info(path)` / `modified(path)`) registers for a
scheme, and every engine path of the form `scheme://...` routes through
a local block cache.  An http/s3 fsspec filesystem drops straight in.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
import threading
from typing import Dict, Optional

_LOCK = threading.Lock()
_FILESYSTEMS: Dict[str, object] = {}
_CACHE_DIR: Optional[str] = None
STATS = {"hits": 0, "misses": 0, "revalidations": 0}


def register_filesystem(scheme: str, fs) -> None:
    """Register an fsspec-style filesystem for `scheme://` paths.
    `fs` needs `open(path, 'rb')`; `modified(path)` or
    `info(path)['mtime'|'ETag']` enables cache revalidation."""
    with _LOCK:
        _FILESYSTEMS[scheme.lower().rstrip(":/")] = fs


def unregister_filesystem(scheme: str) -> None:
    with _LOCK:
        _FILESYSTEMS.pop(scheme.lower().rstrip(":/"), None)


def _cache_dir() -> str:
    global _CACHE_DIR
    with _LOCK:
        if _CACHE_DIR is None:
            _CACHE_DIR = tempfile.mkdtemp(prefix="ddb_tpu_filecache_")
        return _CACHE_DIR


def _split(path: str):
    if "://" not in path:
        return None, path
    scheme, rest = path.split("://", 1)
    return scheme.lower(), rest


def _version_of(fs, path) -> str:
    for probe in ("modified", "checksum"):
        m = getattr(fs, probe, None)
        if m is not None:
            try:
                return str(m(path))
            except Exception:
                pass
    info = getattr(fs, "info", None)
    if info is not None:
        try:
            d = info(path)
            for k in ("ETag", "etag", "mtime", "LastModified", "size"):
                if k in d:
                    return str(d[k])
        except Exception:
            pass
    return ""


def resolve(path: str) -> str:
    """Translate a `scheme://` path to a local cached copy (downloading
    through the registered filesystem on miss or version change);
    local paths pass through untouched."""
    scheme, rest = _split(path)
    if scheme is None or scheme == "file":
        return rest if scheme == "file" else path
    with _LOCK:
        fs = _FILESYSTEMS.get(scheme)
    if fs is None:
        raise IOError(
            f"no filesystem registered for scheme '{scheme}://' "
            f"(Connection.register_filesystem)")
    key = hashlib.sha256(path.encode()).hexdigest()[:24]
    base = os.path.join(_cache_dir(), key)
    data_path = base + ".data"
    ver_path = base + ".ver"
    version = _version_of(fs, rest if hasattr(fs, "_strip_scheme")
                          else path if getattr(
                              fs, "full_paths", False) else rest)
    if os.path.exists(data_path):
        cached_ver = ""
        if os.path.exists(ver_path):
            with open(ver_path) as f:
                cached_ver = f.read()
        if version and cached_ver == version:
            STATS["hits"] += 1
            return data_path
        if not version:
            STATS["hits"] += 1
            return data_path
        STATS["revalidations"] += 1
    STATS["misses"] += 1
    src = fs.open(rest if not getattr(fs, "full_paths", False)
                  else path, "rb")
    try:
        with open(data_path + ".tmp", "wb") as out:
            shutil.copyfileobj(src, out)
    finally:
        src.close()
    os.replace(data_path + ".tmp", data_path)
    with open(ver_path, "w") as f:
        f.write(version)
    return data_path


def clear_cache() -> None:
    global _CACHE_DIR
    with _LOCK:
        d, _CACHE_DIR = _CACHE_DIR, None
    if d is not None:
        shutil.rmtree(d, ignore_errors=True)
