"""The readers of the program's spans (spans.py and the five metrics that
read them) on a made-up trace whose every number is known: spans clipped
to the window, nested spans counted once, idle split by innermost span,
and no value from a program that records no span."""

import pytest

from benchmark import spans
from benchmark.manifest import Manifest
from benchmark.trace import Interval, TraceSummary

READERS = ("launch_host_us", "kernel_calls_per_block",
           "prep_host_ms_per_block", "sync_wait_ms_per_block",
           "idle_in_program_pct")

#: the device's operations: idle gaps [0, 1], [3, 4], [6, 8], [9.5, 10]
DEVICE = [(1.0, 3.0), (4.0, 6.0), (8.0, 9.5)]
#: two calls a block of two blocks; the second call runs past the window's
#: end, and one launch lies before its start
HOST = [
    ("benchmark.block", 0.0, 5.0), ("benchmark.block", 5.0, 10.0),
    ("rrrmc.op.rejfree_sparse", -1.0, -0.5),
    ("rrrmc.call.bklMC", 0.5, 4.5),
    ("rrrmc.sync.kernel_seed", 0.5, 0.8),
    ("rrrmc.prep.resident_state", 0.8, 1.2),
    ("rrrmc.sync.field_bound", 0.9, 1.0),
    ("rrrmc.op.rejfree_sparse", 1.2, 1.3),
    ("aten::zeros", 1.5, 1.6),
    ("rrrmc.sync.chunk_test", 3.0, 3.5),
    ("rrrmc.post.init_aux", 3.5, 3.9),
    ("rrrmc.prep.inner", 3.6, 3.7),
    ("rrrmc.call.bklMC", 6.5, 10.5),
    ("rrrmc.op.rejfree_sparse", 6.6, 6.8),
    ("rrrmc.op.rejfree_sparse", 7.0, 7.4),
    ("rrrmc.sync.chunk_test", 9.8, 10.4),
]


def ctx_of(host, device=DEVICE, blocks=2):
    dev = [Interval("kernel", s, e) for s, e in device]
    summ = TraceSummary(window_s=10.0, busy_s=sum(e - s for s, e in device),
                        launches=0, syncs=0, device=dev,
                        host=[Interval(n, s, e) for n, s, e in host],
                        window=(0.0, 10.0))
    lines = []
    return {"trace": summ, "blocks": blocks, "window_s": 10.0,
            "log": lines.append, "lines": lines}


def read(name, ctx):
    return Manifest().reader(name).read(ctx)


def test_program_spans_are_clipped_to_the_window():
    got = spans.program(ctx_of(HOST))
    assert all(h.name.startswith("rrrmc.") for h in got)
    assert len(got) == 12                  # the launch before it is out
    assert (got[-1].name, got[-1].end) == ("rrrmc.sync.chunk_test", 10.0)
    assert [h.start for h in got] == sorted(h.start for h in got)


@pytest.mark.parametrize("name,value", [
    ("launch_host_us", 1e6 * (0.1 + 0.2 + 0.4) / 3),
    ("kernel_calls_per_block", 3 / 2),
    # [0.8, 1.2] and [3.5, 3.9], the prep span inside the post once, less
    # the wait inside the first
    ("prep_host_ms_per_block", 1e3 * (0.8 - 0.1) / 2),
    # 0.3 + 0.1 + 0.5 + the clipped 0.2
    ("sync_wait_ms_per_block", 1e3 * 1.1 / 2),
    # the gaps under [0.5, 4.5] and [6.5, 10]: 0.5 + 1 + 1.5 + 0.5
    ("idle_in_program_pct", 100 * 3.5 / 10),
])
def test_reader_values(name, value):
    assert read(name, ctx_of(HOST)) == pytest.approx(value)


def test_idle_split_by_innermost_span():
    ctx = ctx_of(HOST)
    by = spans.idle_by_span(ctx, spans.program(ctx))
    assert by["rrrmc.call.bklMC"] == pytest.approx(0.1 + 1.2)
    assert by["rrrmc.sync.kernel_seed"] == pytest.approx(0.3)
    assert by["rrrmc.prep.resident_state"] == pytest.approx(0.1)
    assert by["rrrmc.sync.field_bound"] == pytest.approx(0.1)
    assert by["rrrmc.sync.chunk_test"] == pytest.approx(0.5 + 0.2)
    assert by["rrrmc.post.init_aux"] == pytest.approx(0.3)
    assert by["rrrmc.prep.inner"] == pytest.approx(0.1)
    assert by["rrrmc.op.rejfree_sparse"] == pytest.approx(0.6)
    # every idle second inside a call is named once
    assert sum(by.values()) == pytest.approx(3.5)
    read("idle_in_program_pct", ctx)
    assert "under a call's span alone 1.3" in ctx["lines"][0]


def test_gaps_within_an_interval():
    g = spans.Gaps([(0.0, 1.0), (3.0, 4.0), (6.0, 8.0)])
    assert g.within(0.5, 0.7) == pytest.approx(0.2)
    assert g.within(-1.0, 9.0) == pytest.approx(4.0)
    assert g.within(1.0, 3.0) == 0.0
    assert g.within(3.5, 7.0) == pytest.approx(1.5)
    assert g.over([[0.5, 3.5], [7.5, 9.0]]) == pytest.approx(1.5)
    assert spans.Gaps([]).within(0.0, 1.0) == 0.0
    assert spans.overlap([[0, 2], [3, 5]], [[1, 4]]) == pytest.approx(2.0)


def test_a_program_without_spans_gives_no_value():
    """The parent of the change that adds the spans: no reader raises, and
    none reports a number."""
    host = [h for h in HOST if not h[0].startswith("rrrmc.")]
    for name in READERS:
        assert read(name, ctx_of(host)) is None


def test_calls_without_launches():
    host = [("rrrmc.call.sweepMC", 0.5, 2.0)]
    ctx = ctx_of(host)
    assert read("kernel_calls_per_block", ctx) == 0.0
    assert read("launch_host_us", ctx) is None
    assert read("sync_wait_ms_per_block", ctx) == 0.0
    assert read("idle_in_program_pct", ctx) == pytest.approx(100 * 0.5 / 10)
