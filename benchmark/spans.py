"""The program's own spans in the traced window, for the per-layer metrics
that read them.

rrrmc_tpu_torch records a named span (torch.profiler.record_function) at
each layer boundary of a sampler call while a profiler records; each is a
CPU event of the trace, on the clock of the device's operations. The names
(a frozen copy of the program's, as trace.py keeps the runtime calls'):

* ``rrrmc.call.<sampler>``: a public sampler call, the other spans inside;
* ``rrrmc.prep.*``, ``rrrmc.post.*``: the host's work before and after the
  launches (resident state, tables, checkpoint fill, the closing aux);
* ``rrrmc.chunk``: one pass of the race kernel's chunk loop;
* ``rrrmc.sync.*``: the program's own waits for the card;
* ``rrrmc.op.<kernel>``: a kernel wrapper, from its entry to the launch's
  return.

A program without these spans gives no interval here, and each reader then
gives no value.
"""

from __future__ import annotations

import numpy as np

from .trace import Interval, merged

#: the prefix of every span of the program
PROGRAM = "rrrmc."
CALL = "rrrmc.call."
OP = "rrrmc.op."
PREP = ("rrrmc.prep.", "rrrmc.post.")
SYNC = "rrrmc.sync."


def program(ctx) -> list:
    """The window's spans of the program, clipped to the window, by start
    (the outer of two spans that start together first)."""
    lo, hi = ctx["trace"].window
    out = [Interval(h.name, max(h.start, lo), min(h.end, hi))
           for h in ctx["trace"].host
           if h.name.startswith(PROGRAM) and h.end > lo and h.start < hi]
    return sorted(out, key=lambda h: (h.start, -h.end))


def named(spans: list, prefix) -> list:
    """The spans whose name starts with `prefix` (a string or a tuple)."""
    return [h for h in spans if h.name.startswith(prefix)]


def union(spans: list) -> list:
    """The union of the spans as sorted disjoint [start, end] pairs: a
    span nested in another of the list is counted once."""
    return merged([(h.start, h.end) for h in spans])


def length(pairs: list) -> float:
    return sum(e - s for s, e in pairs)


def overlap(a: list, b: list) -> float:
    """The length of the intersection of two lists of sorted disjoint
    [start, end] pairs."""
    t, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        t += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return t


class Gaps:
    """The window's idle gaps (trace.gaps(): sorted, disjoint), and the
    idle seconds that fall inside any interval."""

    def __init__(self, gaps: list):
        self.start = np.array([g[0] for g in gaps], dtype=np.float64)
        self.end = np.array([g[1] for g in gaps], dtype=np.float64)
        self.cum = np.concatenate(([0.0], np.cumsum(self.end - self.start)))

    def within(self, s: float, e: float) -> float:
        """Idle seconds inside [s, e]."""
        i = int(np.searchsorted(self.end, s, side="right"))
        j = int(np.searchsorted(self.start, e, side="left"))
        if j <= i:
            return 0.0
        t = self.cum[j] - self.cum[i]
        t -= max(0.0, s - self.start[i])
        t -= max(0.0, self.end[j - 1] - e)
        return float(t)

    def over(self, pairs: list) -> float:
        """Idle seconds inside the union of disjoint [start, end] pairs."""
        return sum(self.within(s, e) for s, e in pairs)


def idle_by_span(ctx, spans: list) -> dict:
    """Idle seconds by the name of the innermost program span over them:
    each span's idle less its child spans' (spans of one thread nest)."""
    gaps = Gaps(ctx["trace"].gaps())
    out: dict = {}
    stack: list = []          # [span, its idle] of the open ancestors
    for h in spans:
        while stack and stack[-1][0].end <= h.start:
            stack.pop()
        idle = gaps.within(h.start, h.end)
        out[h.name] = out.get(h.name, 0.0) + idle
        if stack:
            parent = stack[-1][0].name
            out[parent] -= idle
        stack.append((h, idle))
    return out
