"""sync_wait_ms_per_block: host milliseconds a block that the program
waits for the card, the union of its `rrrmc.sync.*` spans in the traced
window (kernel seeds, field bounds, the checkpoint step's copy, the chunk
loop's test); the benchmark's own synchronise at each block's end is not
among them."""

from benchmark import spans


def read(ctx):
    got = spans.program(ctx)
    if not spans.named(got, spans.CALL):
        return None
    sync = spans.union(spans.named(got, spans.SYNC))
    return 1e3 * spans.length(sync) / ctx["blocks"]
