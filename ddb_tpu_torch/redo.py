"""Redo-log transport + follower replay — the analog of the fork's
kafkaredo extension (reference: extension/kafkaredo/kafkafs.cpp:38-41 —
a VFS that produces WAL writes to a Kafka topic and consumes them on
the replica).  Zero-egress here, so the transport is a local
append-only stream file (same framed format as the WAL) that any
tailing consumer can follow; a socket or Kafka producer drops into the
same seam.

Leader:   SET redo_transport='file:///path/stream'   (or
          Connection.attach_redo_transport(path))
Follower: ddb_tpu.redo.Follower('/path/stream').poll() replays all new
          records into its own database; .start() tails continuously.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from typing import Iterator, Optional

from .storage import wal as walmod

_MAGIC = b"DTBREDO1"
_HDR = struct.Struct("<II")      # payload length, crc32


class RedoWriter:
    """Append-only framed record stream (leader side)."""

    def __init__(self, path: str):
        self.path = path
        fresh = not os.path.exists(path) or os.path.getsize(path) == 0
        self._f = open(path, "ab")
        if fresh:
            self._f.write(_MAGIC)
            self._f.flush()

    def append(self, rec: dict) -> None:
        payload = json.dumps(rec, separators=(",", ":"),
                             default=walmod.encode_value).encode("utf-8")
        self._f.write(_HDR.pack(len(payload), zlib.crc32(payload)))
        self._f.write(payload)

    def flush(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:
            pass


class RedoReader:
    """Tailing consumer: yields records appended since the last poll,
    tolerating a torn tail (retried on the next poll)."""

    def __init__(self, path: str):
        self.path = path
        self._offset = 0

    def poll_records(self) -> Iterator[dict]:
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            if self._offset == 0:
                if f.read(len(_MAGIC)) != _MAGIC:
                    return
                self._offset = len(_MAGIC)
            f.seek(self._offset)
            while True:
                hdr = f.read(_HDR.size)
                if len(hdr) < _HDR.size:
                    return
                length, crc = _HDR.unpack(hdr)
                payload = f.read(length)
                if len(payload) < length or zlib.crc32(payload) != crc:
                    return               # torn tail: re-read next poll
                self._offset += _HDR.size + length
                yield json.loads(payload.decode("utf-8"))


class Follower:
    """A read replica: replays the leader's redo stream into its own
    database (reference: the replica consumes the Kafka redo topic and
    re-applies WAL records)."""

    def __init__(self, stream_path: str, database: str = ":memory:", *,
                 device="cuda"):
        from . import connect
        self.con = connect(device=device, database=database)
        self.reader = RedoReader(stream_path)
        self.records_applied = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def poll(self) -> int:
        """Apply all newly available records; returns how many."""
        n = 0
        self.con._replaying = True
        try:
            for rec in self.reader.poll_records():
                walmod.apply_record(self.con, rec)
                n += 1
        finally:
            self.con._replaying = False
        if n:
            self.records_applied += n
            self.con.catalog.bump()
        return n

    def start(self, interval: float = 0.1) -> "Follower":
        def run():
            while not self._stop.is_set():
                try:
                    self.poll()
                except Exception:
                    pass
                self._stop.wait(interval)

        self._stop.clear()
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def wait_caught_up(self, leader_path: str, timeout: float = 10.0
                       ) -> bool:
        """Block until the follower has consumed the whole stream file
        (test helper)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            size = os.path.getsize(leader_path) \
                if os.path.exists(leader_path) else 0
            if self.reader._offset >= size and size > 0:
                return True
            self.poll()
            time.sleep(0.02)
        return False
