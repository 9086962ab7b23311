"""launches_per_block: kernel-launch runtime calls (trace.LAUNCH_CALLS)
in the traced window over its blocks."""


def read(ctx):
    return ctx["trace"].launches / ctx["blocks"]
