"""host_syncs_per_block: stream, device and event synchronise calls
(trace.SYNC_CALLS) in the traced window over its blocks, the benchmark's
own synchronise at each block's end included."""


def read(ctx):
    return ctx["trace"].syncs / ctx["blocks"]
