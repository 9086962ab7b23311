"""Tracing and profiling (the JAX package's rrrmc_tpu/utils/profiling.py).

Two pieces, both free unless used:

1. ``trace(logdir)``: torch.profiler over the block (CPU and, where there
   is a card, CUDA activities), written to ``logdir/trace.json`` (Chrome
   trace format) at its end; it yields the profiler, whose events
   `device_summary` reads: kernels, their device time, launch calls and
   host syncs.
2. ``annotate(name)``: a named span, torch.profiler.record_function
   while a profiler records (under ``torch.autograd.profiler.emit_nvtx()``
   that also pushes an NVTX range), else one shared null context. The
   profiler is the span store: a span is one of its CPU events, on the
   clock of its CUDA activity. ``spanned(name)`` decorates a function so
   that each call runs inside ``annotate(name)``.

The program's spans all start with ``rrrmc.`` and nest, one layer inside
the next: ``rrrmc.call.<sampler>`` (a public sampler call: the spans of
one call are the events nested in its span, the profiler's
``cpu_parent``), ``rrrmc.prep.*`` and ``rrrmc.post.*`` (the host
work before and after the launches), ``rrrmc.chunk`` (a pass of the race
kernel's chunk loop), ``rrrmc.sync.*`` (the program's own waits for the
card) and ``rrrmc.op.<kernel>`` (a kernel wrapper, from its entry to the
launch's return, or its plain version on the CPU). No span lies inside a
per-move loop.
"""

from __future__ import annotations

import contextlib
import functools
import os

import torch

__all__ = ["trace", "annotate", "spanned", "sync", "device_summary"]

#: the runtime calls that launch a kernel, and those that wait for the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def sync(x=None) -> None:
    """Wait for the card: synchronize the device of the first tensor of
    `x` (every CUDA device when x is None); nothing on the CPU."""
    from ..parallel.mesh import leaves   # mesh imports the samplers

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


#: the span `annotate` gives while no profiler records: built once
_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A named span over the block: torch.profiler.record_function(name)
    while a profiler records, else the one shared null context (a check of
    a flag: nothing is built)."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def spanned(name: str):
    """Decorator: every call of the function, from its entry to its return,
    runs inside ``annotate(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return call
    return wrap
