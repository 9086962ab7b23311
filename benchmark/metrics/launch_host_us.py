"""launch_host_us: the mean host time of one kernel wrapper call in the
traced window, in microseconds: the program's `rrrmc.op.<kernel>` spans
(argument checks, the library, the launch plan, the launch), the wrapper
layer's own time."""

from benchmark import spans


def read(ctx):
    ops = spans.named(spans.program(ctx), spans.OP)
    if not ops:
        return None
    return 1e6 * sum(h.end - h.start for h in ops) / len(ops)
