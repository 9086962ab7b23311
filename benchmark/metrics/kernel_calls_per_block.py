"""kernel_calls_per_block: the program's kernel wrapper calls (its
`rrrmc.op.<kernel>` spans) in the traced window over its blocks; beside
launches_per_block, which counts every launch, torch's own included."""

from benchmark import spans


def read(ctx):
    got = spans.program(ctx)
    if not spans.named(got, spans.CALL):
        return None
    return len(spans.named(got, spans.OP)) / ctx["blocks"]
