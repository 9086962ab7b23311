"""The port's profiling (rrrmc_tpu_torch/utils/profiling.py), as
tests/test_profiling.py holds the JAX package's: `trace` writes a trace
file of the annotated region; the samplers' spans nest, one a layer, and
cost a flag's check while no profiler records."""

import inspect
import json
import os

import pytest
import torch

import rrrmc_tpu_torch as pt
from rrrmc_tpu_torch.samplers.common import LAST_ROUTE
from rrrmc_tpu_torch.utils.profiling import annotate, device_summary, trace

CPU = {"device": "cpu"}


def test_trace_writes_the_annotated_region(tmp_path):
    logdir = str(tmp_path / "tr")
    x = torch.ones((64, 64))
    with trace(logdir) as prof:
        with annotate("hot_region"):
            (x @ x).sum()
    path = os.path.join(logdir, "trace.json")
    assert os.path.exists(path)
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "hot_region" in names
    s = device_summary(prof)
    assert s["kernels"] == 0 and s["device_us"] == 0.0   # the host only


def test_profiling_is_exported_and_syncs_a_state():
    X = pt.GraphRRG(16, 3, (-1, 1), seed=1, device="cpu")
    st = pt.init_state(X, 4, seed=1, device="cpu")
    pt.profiling.sync(st)
    pt.profiling.sync()
    assert pt.profiling.annotate is annotate
    assert pt.bklMC.__name__ == "bklMC"         # spanned keeps the API
    assert "backend" in inspect.signature(pt.bklMC).parameters


def _metropolis():
    m = pt.GraphRRG(64, 3, (-1, 1), seed=2, **CPU)
    pt.standardMC(m, 1.5, 30, step=3, chains=4, seed=9, backend="kernel",
                  **CPU)
    return 10          # a site launch a checkpoint


def _bkl():
    m = pt.GraphRRG(64, 3, (-1, 1), seed=3, **CPU)
    pt.bklMC(m, 1.0, 40, step=10, chains=4, seed=5, chunk_moves=4,
             backend="kernel", **CPU)
    return LAST_ROUTE["chunks"]      # a class-kernel launch a chunk


def _sweep():
    m = pt.GraphEA(4, 3, (-1, 1), seed=5, **CPU)
    pt.sweepMC(m, 1.0, 4, step=1, chains=4, seed=3, backend="kernel", **CPU)
    return 4           # a checkerboard launch a checkpoint


def _eo():
    m = pt.GraphEA(4, 3, (-1, 1), seed=5, **CPU)
    pt.extremal_opt(m, 1.4, 5, chains=4, seed=3, backend="kernel", **CPU)
    return 1           # one launch a call


#: sampler: (its run, returning its wrapper calls; the kernel's op span;
#: the spans that must lie inside the call's)
SAMPLERS = {
    "standardMC": (_metropolis, "rrrmc.op.site",
                   {"rrrmc.prep.site_sampler", "rrrmc.sync.field_bound",
                    "rrrmc.sync.kernel_seed", "rrrmc.prep.init_lfT",
                    "rrrmc.prep.site_schedule", "rrrmc.post.checkpoint"}),
    "bklMC": (_bkl, "rrrmc.op.rejfree_classes",
              {"rrrmc.prep.route", "rrrmc.sync.kernel_seed",
               "rrrmc.prep.resident_state",
               "rrrmc.sync.field_bound", "rrrmc.sync.chunk_test",
               "rrrmc.chunk", "rrrmc.post.fill_checkpoints",
               "rrrmc.sync.checkpoint_step", "rrrmc.post.init_aux"}),
    # the last launch writes the fields: no init_aux span
    "sweepMC": (_sweep, "rrrmc.op.sweep",
                {"rrrmc.prep.sweeper", "rrrmc.sync.kernel_seed",
                 "rrrmc.post.checkpoint"}),
    "extremal_opt": (_eo, "rrrmc.op.eo_sparse",
                     {"rrrmc.prep.route", "rrrmc.prep.rank_table",
                      "rrrmc.sync.kernel_seed",
                      "rrrmc.prep.resident_state",
                      "rrrmc.sync.field_bound"}),
}


def _spans(prof):
    return [e for e in prof.events() if e.name.startswith("rrrmc.")]


def _inside(e, outer) -> bool:
    p = e.cpu_parent
    while p is not None:
        if p is outer:
            return True
        p = p.cpu_parent
    return False


@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
def test_sampler_spans_nest_in_one_call(sampler, tmp_path):
    run, op, inner = SAMPLERS[sampler]
    with trace(str(tmp_path)) as prof:
        calls = run()
    spans = _spans(prof)
    top = [e for e in spans if e.name.startswith("rrrmc.call.")]
    assert [e.name for e in top] == [f"rrrmc.call.{sampler}"]
    rest = [e for e in spans if e is not top[0]]
    assert {e.name for e in rest} == inner | {op}
    assert all(_inside(e, top[0]) for e in rest)
    assert sum(e.name == op for e in rest) == calls
    # one family lookup a call, passed down to the kernel's runner
    assert sum(e.name == "rrrmc.prep.route" for e in rest) == (
        "rrrmc.prep.route" in inner)
    if sampler == "bklMC":        # each launch and fill inside its chunk
        for e in rest:
            if e.name in (op, "rrrmc.post.fill_checkpoints"):
                assert e.cpu_parent.name == "rrrmc.chunk"


@pytest.mark.parametrize("sweeps,fallback", [(4, False), (1, True)])
def test_sweep_fields_span_only_without_a_launch(sweeps, fallback, tmp_path):
    """The checkerboard route's `rrrmc.post.init_aux` span is its fallback:
    a call with a checkpoint takes the fields from its last launch, one
    with none (sweeps < step) launches nothing and runs init_aux."""
    m = pt.GraphEA(4, 3, (-1, 1), seed=5, **CPU)
    with trace(str(tmp_path)) as prof:
        _, st = pt.sweepMC(m, 1.0, sweeps, step=2, chains=4, seed=3,
                           backend="kernel", **CPU)
    names = [e.name for e in _spans(prof)]
    assert names.count("rrrmc.post.init_aux") == fallback
    assert names.count("rrrmc.op.sweep") == sweeps // 2
    assert LAST_ROUTE["aux"] == ("torch" if fallback else "kernel")
    assert torch.equal(st.aux, m.local_fields(st.sigma))


@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
def test_spans_cost_a_check_while_no_profiler_records(sampler,
                                                       monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    first = annotate("rrrmc.op.site")
    assert annotate("rrrmc.call.bklMC") is first
    SAMPLERS[sampler][0]()


def test_two_calls_keep_their_spans_apart(tmp_path):
    """Each call's spans are the events nested in its own call span."""
    with trace(str(tmp_path)) as prof:
        _eo()
        _eo()
    spans = _spans(prof)
    calls = [e for e in spans if e.name == "rrrmc.call.extremal_opt"]
    assert len(calls) == 2
    assert calls[0].time_range.end <= calls[1].time_range.start
    for c in calls:
        mine = [e.name for e in spans if _inside(e, c)]
        assert set(mine) == SAMPLERS["extremal_opt"][2] | {
            "rrrmc.op.eo_sparse"}
        assert mine.count("rrrmc.op.eo_sparse") == 1
