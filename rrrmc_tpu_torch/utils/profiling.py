"""Tracing and profiling (the JAX package's rrrmc_tpu/utils/profiling.py).

Three layers, all free unless used:

1. ``trace(logdir)``: torch.profiler over the block (CPU and, where there
   is a card, CUDA activities), written to ``logdir/trace.json`` (Chrome
   trace format) at its end; it yields the profiler, whose events
   `device_summary` reads: kernels, their device time, launch calls and
   host syncs.
2. ``annotate(name)``: a named span (torch.profiler.record_function, and
   an NVTX range when CUDA is present) that groups the block's launches
   in a trace.
3. ``DispatchCounters``: per-label counts and synchronized times of host
   calls: wall time on the host clock, and on the card the device time
   between CUDA events recorded around the call.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict

import torch

from ..parallel.mesh import leaves

__all__ = ["trace", "annotate", "DispatchCounters", "dispatch_counters",
           "sync", "device_summary"]

#: the runtime calls that launch a kernel, and those that wait for the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def sync(x=None) -> None:
    """Wait for the card: synchronize the device of the first tensor of
    `x` (every CUDA device when x is None); nothing on the CPU."""
    t = next(leaves(x), None)
    if t is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    elif t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with torch.profiler (CPU activities, and CUDA ones
    where a card is present) and write ``logdir/trace.json``; yields the
    profiler (its ``events()`` and ``key_averages()``)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_summary(prof) -> dict:
    """What a `trace` saw on the card: kernels, their summed device time
    (µs), kernel launch calls and host syncs (each a count)."""
    kernels, device_us, launches, syncs = 0, 0.0, 0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels += 1
            device_us += e.time_range.elapsed_us()
        elif e.name in LAUNCH_CALLS:
            launches += 1
        elif e.name in SYNC_CALLS:
            syncs += 1
    return {"kernels": kernels, "device_us": device_us,
            "launch_calls": launches, "host_syncs": syncs}


def annotate(name: str):
    """A named span over the block: record_function, plus an NVTX range
    when CUDA is present."""
    stack = contextlib.ExitStack()
    stack.enter_context(torch.profiler.record_function(name))
    if torch.cuda.is_available():
        stack.enter_context(torch.cuda.nvtx.range(name))
    return stack


@dataclass
class _Stat:
    count: int = 0
    wall_s: float = 0.0
    device_s: float = 0.0
    synced: int = 0


class _Timer:
    """Host clock, and CUDA events on the current device where a card is
    present, around a block."""

    def __init__(self):
        self.events = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter()

    def stop(self, value) -> tuple:
        """(wall s, device s) once `value`'s device is synchronized."""
        if self.events is not None:
            self.events[1].record()
        sync(value)
        wall = time.perf_counter() - self.t0
        if self.events is None:
            return wall, 0.0
        self.events[1].synchronize()
        return wall, self.events[0].elapsed_time(self.events[1]) / 1e3


@dataclass
class DispatchCounters:
    """Per-label dispatch counters with optional synchronized timing.

    `timed(label, fn, *a, sync_out=True, **kw)` calls fn, syncs on its
    output where sync_out (true end-to-end latency: use it only to
    measure, it stops the host from running ahead) and adds the call's
    wall time and, on the card, its CUDA-event time; `measure(label,
    sync_value=...)` does the same for a with-block; `tick` counts
    without timing."""

    stats: Dict[str, _Stat] = field(
        default_factory=lambda: defaultdict(_Stat))

    def tick(self, label: str, n: int = 1) -> None:
        self.stats[label].count += n

    def _add(self, label, timer, value, synced: bool) -> None:
        s = self.stats[label]
        s.count += 1
        if synced:
            wall, dev = timer.stop(value)
            s.device_s += dev
        else:
            wall = time.perf_counter() - timer.t0
        s.wall_s += wall
        s.synced += int(synced)

    def timed(self, label: str, fn, *args, sync_out: bool = True, **kw):
        timer = _Timer()
        out = fn(*args, **kw)
        self._add(label, timer, out, sync_out)
        return out

    @contextlib.contextmanager
    def measure(self, label: str, *, sync_value=None):
        """Times the with-block; with sync_value, syncs on it at the end so
        that the time covers the card's work."""
        timer = _Timer()
        yield
        self._add(label, timer, sync_value, sync_value is not None)

    def summary(self) -> Dict[str, Dict]:
        return {k: {"count": v.count, "wall_s": v.wall_s,
                    "device_s": v.device_s, "synced": v.synced,
                    "mean_s": (v.wall_s / v.count if v.count else 0.0)}
                for k, v in sorted(self.stats.items())}

    def reset(self) -> None:
        self.stats.clear()


#: process-global default registry
dispatch_counters = DispatchCounters()
