"""A kernel's share of its roofline, from the traced window.

The least time of the window's work is the larger of its operations over
the peak rate of operations and its bytes over the peak bandwidth
(peaks.json: the published H100 SXM figures at 700 W); the work counts
are the floors of `work/<kernel>.py`, which no correct implementation of
the same chain on these inputs can undercut. The share is that least time
over the kernel's device time in the trace, in per cent; a kernel that did
not run in the window gives none.
"""

from __future__ import annotations


def _least(ctx, floor: dict):
    pk = ctx["peaks"]
    t_ops = floor["ops"] / pk["ops_per_s"]
    t_bytes = floor["bytes"] / pk["bytes_per_s"]
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def share(ctx, kernel: str):
    """`kernel`'s roofline share in %, or None where it did not run."""
    w = ctx["manifest"].work(kernel)
    t = ctx["trace"].kernel_s(w.KERNELS)
    floor = w.floor(ctx)
    if t <= 0 or floor is None:
        return None
    least, by = _least(ctx, floor)
    pct = 100.0 * least / t
    dev = ctx["device"]
    ctx["log"](f"{kernel}_roofline {pct} % by {by}: {floor['ops']} "
               f"operations, {floor['bytes']} bytes, {t} s in "
               f"{ctx['trace'].kernel_count(w.KERNELS)} launches "
               f"({dev['kind']}, power limit {dev.get('power_limit')})")
    return pct

