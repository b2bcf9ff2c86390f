"""The program's own spans in a traced run.

The program names each span ddb.<layer>.<what> (api, frontend, exec,
storage) and records it with record_function only while a profiler
records, so its spans come out of the trace beside the harness's own.
These functions read them for the per-layer metrics; a program that
records no such span gives them nothing to read.
"""

from __future__ import annotations

from portbench.trace import Trace, idle_gaps

PREFIX = "ddb."


def innermost(spans) -> list:
    """(start, end, name) stretches in order, each named by the innermost
    span open over it; stretches with no span open are left out.  Spans
    nest, so a span that runs past its parent's end is cut there."""
    out, stack, at = [], [], 0.0

    def close(until):
        nonlocal at
        while stack and stack[-1][0] <= until:
            end, name = stack.pop()
            if end > at:
                out.append((at, end, name))
                at = end
        if stack and until > at:
            out.append((at, until, stack[-1][1]))
        at = until

    for s, e, name in sorted(spans, key=lambda sp: (sp[0], -sp[1])):
        if stack:
            close(s)
        at = s
        stack.append((min(e, stack[-1][0]) if stack else e, name))
    close(float("inf"))
    return out


def idle_pct(t: Trace, layer: str):
    """Share of the window (%) in which nothing runs on the device and
    the innermost open span is one of ddb.<layer>.*; None without kernels
    or without any of the program's spans."""
    if not t.kernels or not any(n.startswith(PREFIX) for *_, n in t.spans):
        return None
    segs, want = innermost(t.inside(t.spans)), f"{PREFIX}{layer}."
    us, i = 0.0, 0
    for a, b in idle_gaps(t):
        while i < len(segs) and segs[i][1] <= a:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < b:
            s, e, name = segs[j]
            if name.startswith(want):
                us += min(e, b) - max(s, a)
            j += 1
    return 100.0 * us / (t.window[1] - t.window[0])


def plan_cache_hit_pct(t: Trace):
    """Share (%) of the window's ddb.frontend.plan spans that hold no
    ddb.frontend.bind: plans the cache gave back.  None without plan
    spans."""
    plans = sorted((s, e) for s, e, n in t.inside(t.spans)
                   if n == "ddb.frontend.plan")
    if not plans:
        return None
    binds = sorted((s, e) for s, e, n in t.inside(t.spans)
                   if n == "ddb.frontend.bind")
    missed, j = 0, 0
    for s, e in plans:
        while j < len(binds) and binds[j][0] < s:
            j += 1
        if j < len(binds) and binds[j][1] <= e:
            missed += 1
    return 100.0 * (len(plans) - missed) / len(plans)
