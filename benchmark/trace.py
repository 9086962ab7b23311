"""Reduce a torch.profiler trace of the measured window to what the
per-layer metrics read: device time by kernel name, the device's busy
seconds (the union of its operations' intervals), kernel launch calls and
host syncs, and the breakdown (the device operations that took most time,
and the idle gaps by what the host was doing).

The runtime call names are a frozen copy of
`rrrmc_tpu_torch/utils/profiling.py`'s (LAUNCH_CALLS, SYNC_CALLS), kept here
because a later change may change the program's.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

#: the runtime calls that launch a kernel, and those that wait for the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")

#: the span that the harness records around the measured window; its spans
#: all start with "benchmark."
WINDOW = "benchmark.window"
#: host events of the profiler itself, which say nothing of the program
PROFILER_EVENTS = ("Activity Buffer Request",)
#: entries of each list of the breakdown
TOP = 10
#: the longest idle gaps whose host activity is looked up
GAPS_LABELLED = 500


@dataclass
class Interval:
    name: str
    start: float   # s, on the profiler's clock
    end: float


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    launches: int
    syncs: int
    device: list = field(default_factory=list)    # [Interval] in the window
    host: list = field(default_factory=list)      # [Interval] CPU events
    window: tuple = (0.0, 0.0)                     # (start, end), s

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the operations whose name matches the regular
        expression `pattern` (searched anywhere in the name)."""
        rx = re.compile(pattern)
        return sum(e.end - e.start for e in self.device if rx.search(e.name))

    def kernel_count(self, pattern: str) -> int:
        rx = re.compile(pattern)
        return sum(1 for e in self.device if rx.search(e.name))

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self) -> dict:
        by_name: dict = {}
        for e in self.device:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.end - e.start)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[short(n), s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in self.idle_by_host()]}

    def gaps(self) -> list:
        """(start, end) of each stretch of the window with no device
        operation."""
        lo, hi = self.window
        out, t = [], lo
        for s, e in merged([(d.start, d.end) for d in self.device]):
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if hi > t:
            out.append((t, hi))
        return out

    def idle_by_host(self) -> list:
        """Idle seconds summed by what the host was doing at each gap's
        midpoint, over the GAPS_LABELLED longest gaps, the most first: the
        innermost call of the program that covers it, else "python before"
        the next call that starts after it (the host in Python between
        calls, the benchmark's spans left out)."""
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:GAPS_LABELLED]
        host = [h for h in self.host if not h.name.startswith("benchmark.")]
        if not gaps:
            return []
        hs = np.array([h.start for h in host])
        he = np.array([h.end for h in host])
        out: dict = {}
        for s, e in gaps:
            mid = 0.5 * (s + e)
            cover = np.nonzero((hs <= mid) & (he >= mid))[0]
            later = np.nonzero(hs > mid)[0]
            if len(cover):
                name = host[int(cover[np.argmin((he - hs)[cover])])].name
            elif len(later):
                name = ("python before "
                        + host[int(later[np.argmin(hs[later])])].name)
            else:
                name = "python after the last call"
            out[name] = out.get(name, 0.0) + (e - s)
        return sorted(out.items(), key=lambda kv: -kv[1])[:TOP]

def short(name: str, n: int = 160) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def merged(spans):
    """The union of (start, end) spans, as sorted disjoint spans."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof) -> TraceSummary:
    """The summary of the window span in profiler `prof`'s events."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    win, dev, host = None, [], []
    launches = syncs = 0
    for e in prof.events():
        iv = Interval(e.name, e.time_range.start * 1e-6,
                      e.time_range.end * 1e-6)
        if e.device_type == cuda:
            # the device's copies of the host's spans are no operations
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith("benchmark.")):
                dev.append(iv)
        elif e.name == WINDOW:
            win = iv
        elif e.name not in PROFILER_EVENTS:
            host.append(iv)
    if win is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    lo, hi = win.start, win.end
    dev = [Interval(d.name, max(d.start, lo), min(d.end, hi)) for d in dev
           if d.end > lo and d.start < hi]
    host = [h for h in host if h.end > lo and h.start < hi]
    for h in host:
        if h.name in LAUNCH_CALLS:
            launches += 1
        elif h.name in SYNC_CALLS:
            syncs += 1
    busy = sum(e - s for s, e in merged([(d.start, d.end) for d in dev]))
    return TraceSummary(window_s=hi - lo, busy_s=busy, launches=launches,
                        syncs=syncs, device=dev, host=host, window=(lo, hi))
