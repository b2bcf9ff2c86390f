"""The traced run's records, read from torch.profiler's Chrome trace.

Kernels, copies and the harness's own spans (record_function ranges
around each call into the program) come out of one trace, on one clock.
The per-layer metrics (metrics/<name>.py) read a Trace; nothing else of
the trace is kept.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field

WINDOW = "portbench.window"


@dataclass
class Trace:
    """Intervals in microseconds: (start, end, name)."""
    window: tuple                       # (start, end) of the traced window
    kernels: list = field(default_factory=list)
    copies: list = field(default_factory=list)     # memcpy and memset
    spans: list = field(default_factory=list)      # the harness's spans
    queries: int = 0                    # requests completed in the window
    min_bytes: int = 0                  # bytes those requests must move
    peak_bytes_per_s: float | None = None

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def inside(self, intervals):
        lo, hi = self.window
        return [(max(s, lo), min(e, hi), n) for s, e, n in intervals
                if e > lo and s < hi]


def union(intervals) -> list:
    """Merged (start, end) of overlapping intervals, in order."""
    out = []
    for s, e, *_ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def covered_us(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


def device_busy_us(t: Trace) -> float:
    return covered_us(t.inside(t.kernels + t.copies))


def idle_gaps(t: Trace) -> list:
    """(start, end) of each stretch of the window with nothing on the
    device."""
    lo, hi = t.window
    gaps, at = [], lo
    for s, e in union(t.inside(t.kernels + t.copies)):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


class SpanIndex:
    """The innermost harness span around a moment.  Spans nest (a
    request holds its steps) and siblings do not overlap, so the
    innermost one around t is the latest to start among those that hold
    t."""

    def __init__(self, spans):
        # of two spans that start together the inner one ends first:
        # it sorts after the outer one
        self.spans = sorted(spans, key=lambda sp: (sp[0], -sp[1]))
        self.starts = [s for s, _, _ in self.spans]

    def at(self, when: float) -> str:
        i = bisect.bisect_right(self.starts, when) - 1
        while i >= 0:
            s, e, name = self.spans[i]
            if e >= when:
                return name
            i -= 1
        return "outside"


def breakdown(t: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the harness span it fell in."""
    by_name = {}
    for s, e, name in t.inside(t.kernels + t.copies):
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(t), key=lambda g: g[0] - g[1])[:top]
    index = SpanIndex(t.spans)
    return {"device_ops": [[n[:160], v] for n, v in ops],
            "idle_gaps": [[index.at((s + e) / 2), (e - s) / 1e6]
                          for s, e in gaps]}


def idle_by_span(t: Trace) -> dict:
    """Seconds of idle device by the span the host was in."""
    out, index = {}, SpanIndex(t.spans)
    for s, e in idle_gaps(t):
        name = index.at((s + e) / 2)
        out[name] = out.get(name, 0.0) + (e - s) / 1e6
    return out


def from_chrome(events: list) -> Trace:
    """A Trace from the "traceEvents" of an exported profile."""
    kernels, copies, spans, window = [], [], [], None
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, s = ev.get("cat", ""), float(ev["ts"])
        iv = (s, s + float(ev["dur"]), ev.get("name", ""))
        if cat == "kernel":
            kernels.append(iv)
        elif cat in ("gpu_memcpy", "gpu_memset"):
            copies.append(iv)
        elif cat == "user_annotation":
            if iv[2] == WINDOW:
                window = iv[:2]
            else:
                spans.append(iv)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    return Trace(window, kernels, copies, spans)


class Profiler:
    """torch.profiler over the window, CPU and CUDA activity; `trace`
    holds the records once it has stopped."""

    def __init__(self, cuda: bool):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self.trace = None

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                self.trace = from_chrome(json.load(f)["traceEvents"])
        finally:
            os.unlink(path)
        return False
