"""prep_host_ms_per_block: host milliseconds a block of the program's own
work before and after its launches: the union of its `rrrmc.prep.*` and
`rrrmc.post.*` spans in the traced window (resident state, tables,
samplers and rank tables built, checkpoint fill, the closing aux; a
nested span counted once), less the waits for the card inside them (its
`rrrmc.sync.*` spans, which sync_wait_ms_per_block counts)."""

from benchmark import spans


def read(ctx):
    got = spans.program(ctx)
    if not spans.named(got, spans.CALL):
        return None
    prep = spans.union(spans.named(got, spans.PREP))
    sync = spans.union(spans.named(got, spans.SYNC))
    return 1e3 * (spans.length(prep) - spans.overlap(prep, sync)) \
        / ctx["blocks"]
