"""Structured logging subsystem.

Analog of the reference's LogManager/Logger with queryable storage
(reference: src/logging/log_manager.hpp:23, duckdb_logs table function).
Entries go to an in-memory ring buffer exposed via `duckdb_logs()`;
a stdout sink can be enabled via SET logging_to_stdout = true.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Optional

LEVELS = ("trace", "debug", "info", "warn", "error")


@dataclass
class LogEntry:
    ts: float
    level: str
    type: str          # e.g. query, bind, execute, cdc
    message: str


class LogManager:
    def __init__(self, capacity: int = 4096):
        self.entries: Deque[LogEntry] = deque(maxlen=capacity)
        self.level = "info"
        self.to_stdout = False

    def log(self, level: str, type_: str, message: str):
        if LEVELS.index(level) < LEVELS.index(self.level):
            return
        e = LogEntry(time.time(), level, type_, message)
        self.entries.append(e)
        if self.to_stdout:
            print(f"[{e.level}] {e.type}: {e.message}")

    def info(self, type_, message):
        self.log("info", type_, message)

    def debug(self, type_, message):
        self.log("debug", type_, message)

    def warn(self, type_, message):
        self.log("warn", type_, message)

    def clear(self):
        self.entries.clear()
