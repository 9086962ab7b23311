"""idle_in_program_pct: the share of the traced window in which no
operation ran on the device while the host was inside a sampler call
(its `rrrmc.call.*` span), 100 x those idle seconds / the window;
device_idle_pct less this is the idle of the benchmark's loop between
calls. The log line gives the idle by innermost program span, and how
much of it lies under a call's span alone, outside every span inside it."""

from benchmark import spans


def read(ctx):
    got = spans.program(ctx)
    calls = spans.named(got, spans.CALL)
    if not calls:
        return None
    summ = ctx["trace"]
    idle = spans.Gaps(summ.gaps()).over(spans.union(calls))
    by_span = spans.idle_by_span(ctx, got)
    alone = sum(v for k, v in by_span.items() if k.startswith(spans.CALL))
    top = sorted(by_span.items(), key=lambda kv: -kv[1])
    ctx["log"](f"idle_in_program {idle} s of {summ.window_s} s; under a "
               f"call's span alone {alone} s; by innermost span: "
               + ", ".join(f"{k} {v}" for k, v in top))
    return 100.0 * idle / summ.window_s
