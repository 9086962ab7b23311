"""The kernels' work floors and the roofline shares read from them, and the
trace reduction."""

import types

import pytest

from benchmark import roofline
from benchmark.manifest import Manifest, load_json, HERE
from benchmark.trace import Interval, TraceSummary, merged

PEAKS = load_json(HERE / "peaks.json")

KERNEL_NAMES = {
    "site": ["void rrrmc::site_resident_kernel<signed char>(SiteArgs)",
             "void site_global_kernel<int>(SiteArgs)",
             "site_cut_kernel(CutArgs)"],
    "rejfree_sparse": [
        "void rrrmc::rejfree_sparse_kernel<256, signed char, int>"
        "(SparseArgs)"],
    "sweep": ["void rrrmc::sweep_kernel<3, 4>(SweepArgs)"],
    "eo_sparse": [
        "void rrrmc::eo_chain_kernel<(anonymous namespace)::SparseFlip"
        "<false>, signed char, 0, 1>(EoArgs, SparseTables)"],
}
OTHERS = ["void rrrmc::sk_sweep_kernel<16>(SkArgs)",
          "void replica_sweep_kernel<int>(X)",
          "void rrrmc::eo_chain_kernel<(anonymous namespace)::DenseFlip, "
          "short, 0, 1>(EoArgs, DenseTables)",
          "void rrrmc::rejfree_dense_kernel<256, int>(DenseArgs)",
          "Memcpy DtoD (Device -> Device)"]


@pytest.mark.parametrize("kernel", sorted(KERNEL_NAMES))
def test_kernel_names(kernel):
    import re

    rx = re.compile(Manifest().work(kernel).KERNELS)
    assert all(rx.search(n) for n in KERNEL_NAMES[kernel])
    assert not any(rx.search(n) for n in OTHERS)
    for other, names in KERNEL_NAMES.items():
        if other != kernel:
            assert not any(rx.search(n) for n in names)


def ctx_of(traffic, arrays, work, blocks=10, kernel_s=1.0, name="x"):
    summ = TraceSummary(window_s=2.0, busy_s=1.5, launches=30, syncs=20,
                        device=[Interval(name, 0.0, kernel_s)])
    run = types.SimpleNamespace(traffic=traffic, arrays=arrays)
    return {"run": run, "work": work, "blocks": blocks, "trace": summ,
            "peaks": PEAKS, "manifest": Manifest(), "window_s": 2.0,
            "device": {"kind": "test", "power_limit": "700 W"},
            "log": lambda *a: None}


@pytest.mark.parametrize("kernel,work,ops,nbytes", [
    ("site", {"attempted_flips": 1000, "applied_flips": 10},
     3 * 1000 + 5 * 10, 10 * (2 * 4 * 64 + 16 * 4 + 8 * 64 * 3)),
    ("rejfree_sparse", {"moves": 10, "iters": 10 ** 6}, 6 * 10,
     10 * (2 * 4 * 64 + 16 * 4 + 8 * 64 * 3)),
    ("sweep", {"attempted_flips": 1000}, 3 * 1000,
     10 * (2 * 4 * 64 + 8 * 4 + 4 * 64 * 1)),
    ("eo_sparse", {"moves": 100}, 6 * 100,
     10 * (3 * 4 * 64 + 16 * 4 + 8 * 64 * 3)),
])
def test_floors(kernel, work, ops, nbytes):
    K = 2 if kernel == "sweep" else 3
    ctx = ctx_of({"chains": 4}, {"N": 64, "K": K}, work)
    f = Manifest().work(kernel).floor(ctx)
    assert f == {"ops": ops, "bytes": nbytes}


def test_floor_grows_with_work_and_never_counts_philox():
    w = Manifest().work("rejfree_sparse")
    a = w.floor(ctx_of({"chains": 8}, {"N": 100, "K": 3}, {"moves": 50}))
    b = w.floor(ctx_of({"chains": 8}, {"N": 100, "K": 3}, {"moves": 100}))
    assert b["ops"] == 2 * a["ops"]
    # no dependence on the iterations the moves stand for
    c = w.floor(ctx_of({"chains": 8}, {"N": 100, "K": 3},
                       {"moves": 50, "iters": 10 ** 9}))
    assert c == a


def test_share_at_the_floor_is_100_and_below_it_more_time_less_share():
    name = "void rrrmc::sweep_kernel<3, 4>(SweepArgs)"
    work = {"attempted_flips": 10 ** 12}
    w = Manifest().work("sweep")
    f = w.floor(ctx_of({"chains": 4}, {"N": 64, "K": 6}, work))
    least = max(f["ops"] / PEAKS["ops_per_s"], f["bytes"] /
                PEAKS["bytes_per_s"])
    ctx = ctx_of({"chains": 4}, {"N": 64, "K": 6}, work, kernel_s=least,
                 name=name)
    assert roofline.share(ctx, "sweep") == pytest.approx(100.0)
    ctx = ctx_of({"chains": 4}, {"N": 64, "K": 6}, work,
                 kernel_s=4 * least, name=name)
    assert roofline.share(ctx, "sweep") == pytest.approx(25.0)


def test_share_is_none_without_the_kernel():
    ctx = ctx_of({"chains": 4}, {"N": 64, "K": 6},
                 {"attempted_flips": 1000}, name="other_kernel")
    assert roofline.share(ctx, "sweep") is None


def test_trace_reduction():
    dev = [Interval("k1", 0.0, 1.0), Interval("k2", 0.5, 1.5),
           Interval("k1", 3.0, 3.5)]
    host = [Interval("benchmark.block", 0.0, 4.0),
            Interval("cudaStreamSynchronize", 1.6, 2.9),
            Interval("aten::copy_", 3.8, 3.9)]
    s = TraceSummary(window_s=4.0, busy_s=2.0, launches=3, syncs=1,
                     device=dev, host=host, window=(0.0, 4.0))
    assert merged([(0, 1), (0.5, 1.5), (3, 3.5)]) == [[0, 1.5], [3, 3.5]]
    assert s.gaps() == [(1.5, 3.0), (3.5, 4.0)]
    assert s.kernel_s("k1") == pytest.approx(1.5)
    assert s.idle_pct() == pytest.approx(50.0)
    bd = s.breakdown()
    assert bd["device_ops"][0] == ["k1", 1.5]
    assert bd["idle_gaps"] == [["cudaStreamSynchronize", 1.5],
                               ["python before aten::copy_", 0.5]]
