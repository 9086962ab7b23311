"""The port's profiling (rrrmc_tpu_torch/utils/profiling.py), as
tests/test_profiling.py holds the JAX package's: `trace` writes a trace
file of the annotated region, `DispatchCounters` counts and times."""

import json
import os

import torch

import rrrmc_tpu_torch as pt
from rrrmc_tpu_torch.utils.profiling import (DispatchCounters, annotate,
                                             device_summary, trace)


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


def test_dispatch_counters():
    pc = DispatchCounters()
    x = torch.arange(8.0)
    out = pc.timed("double", lambda a: a * 2, x)
    assert torch.equal(out, x * 2)
    pc.tick("double", 2)
    with pc.measure("region", sync_value=out):
        out * 3
    s = pc.summary()
    assert s["double"]["count"] == 3 and s["double"]["synced"] == 1
    assert s["region"]["count"] == 1 and s["region"]["wall_s"] >= 0.0
    assert s["region"]["device_s"] == 0.0
    pc.reset()
    assert pc.summary() == {}


def test_profiling_is_exported_and_syncs_a_state():
    X = pt.GraphRRG(16, 3, (-1, 1), seed=1, device="cpu")
    st = pt.init_state(X, 4, seed=1, device="cpu")
    pt.profiling.sync(st)
    pt.profiling.sync()
    assert pt.profiling.dispatch_counters.summary() is not None
