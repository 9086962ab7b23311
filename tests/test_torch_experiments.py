"""rrrmc_tpu_torch.experiments against the JAX package's: the pure
statistics on the same numpy inputs (equal; the windowed overlap moments,
which the port sums in float64, against float64 numpy and XLA's float32
sums), the overlap pipeline end to end
with standardMC and bklMC, and equilibrated_factors at a small size on the
CPU (the kernels' plain versions)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import rrrmc_tpu_torch as pt
from rrrmc_tpu import experiments as jx
from rrrmc_tpu_torch import experiments as px

from torch_port_helpers import CPU

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _snapshots(B=6, n=40, N=24, seed=3, sticky=0.9):
    """+-1 snapshots [B, n, N] with time correlations (each spin keeps its
    value with probability `sticky`)."""
    rng = np.random.default_rng(seed)
    s = np.empty((B, n, N), np.int8)
    s[:, 0] = rng.choice([-1, 1], (B, N))
    for t in range(1, n):
        keep = rng.random((B, N)) < sticky
        s[:, t] = np.where(keep, s[:, t - 1], rng.choice([-1, 1], (B, N)))
    return s


@pytest.mark.parametrize("log", [True, False])
def test_stats_time_matches_jax(log):
    Es = np.random.default_rng(1).normal(size=(16, 57))
    want = jx.stats_time(Es, step=7, nbins=9, log=log)
    got = px.stats_time(torch.from_numpy(Es), step=7, nbins=9, log=log)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("t0,incr", [(None, 2.0), (3.0, 1.5), (None, 4.0)])
def test_log_windows_matches_jax(t0, incr):
    times = (np.arange(100) + 1) * 25.0
    w1, c1 = jx.log_windows(times, t0=t0, incr=incr)
    w2, c2 = px.log_windows(times, t0=t0, incr=incr)
    assert w1 == w2
    np.testing.assert_array_equal(c1, c2)


def test_overlap_moments_matches_jax():
    s = _snapshots()
    want = jx.overlap_moments(s)
    got = px.overlap_moments(torch.from_numpy(s))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    win = [(0, 5), (5, 5), (10, 30)]
    want = jx.overlap_moments(s, windows=win)
    got = px.overlap_moments(s, windows=win)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _window_moments_f64(s, windows):
    """The windowed self / cross moments of _overlap_moments_device,
    evaluated window by window in float64 numpy."""
    c = s.astype(np.float64)
    B, _, N = c.shape
    out = {k: [] for k in ("q2_mean", "q2_std", "x2_mean", "x2_std")}
    for a, b in windows:
        blk = c[:, a:b]
        g = np.einsum("bun,bvn->buv", blk, blk) / N
        iu = np.triu_indices(b - a, 1)
        q2 = g[:, iu[0], iu[1]] ** 2
        m2 = q2.mean() if q2.size else 0.0
        m4 = (q2 ** 2).mean() if q2.size else 0.0
        out["q2_mean"].append(m2)
        out["q2_std"].append(np.sqrt(max(0.0, m4 - m2 ** 2)))
        x2 = (np.einsum("bun,bvn->buv", blk[0::2], blk[1::2]) / N) ** 2
        out["x2_mean"].append(x2.mean())
        out["x2_std"].append(np.sqrt(max(0.0, (x2 ** 2).mean()
                                         - x2.mean() ** 2)))
    return {k: np.array(v) for k, v in out.items()}


@pytest.mark.parametrize("incr", [2.0, 1.5])
def test_overlap_stats_matches_jax(incr):
    """The windowed moments: exact float32 Gram products of +-1 values,
    summed in float64. They equal a float64 numpy evaluation to rtol 1e-12
    and the JAX device path, which sums in float32 (a few 1e-6 of relative
    rounding here), to rtol 1e-5 (the stds, sqrt of a difference of those
    sums, to 1e-5 absolute); the windows and their centres are equal."""
    s = _snapshots(B=8, n=48, N=30, seed=5)
    times = (np.arange(48) + 1) * 4.0
    want = jx.overlap_stats(s, times, incr=incr)
    got = px.overlap_stats(torch.from_numpy(s), times, incr=incr)
    exact = _window_moments_f64(s, px.log_windows(times, incr=incr)[0])
    np.testing.assert_array_equal(got["t"], want["t"])
    for k in ("q2_mean", "x2_mean", "q2_std", "x2_std"):
        np.testing.assert_allclose(got[k], exact[k], rtol=1e-12, atol=1e-15,
                                   err_msg=k)
    for k in ("q2_mean", "x2_mean"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    for k in ("q2_std", "x2_std"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    with pytest.raises(ValueError, match="even"):
        px.overlap_stats(torch.from_numpy(s[:7]), times)


def test_overlap_stats_identical_configs():
    out = px.overlap_stats(torch.ones((2, 8, 8), dtype=torch.int8),
                           np.arange(1, 9, dtype=float), incr=2.0)
    assert np.allclose(out["q2_mean"][1:3], 1.0)
    assert np.allclose(out["x2_mean"], 1.0)
    assert np.allclose(out["q2_std"][1:3], 0.0, atol=1e-6)


@pytest.mark.parametrize("sampler", ["standard", "bkl"])
def test_stats_overlaps_end_to_end(sampler):
    """Two disorders of GraphRRG(24, 3) through standardMC (torch route) or
    bklMC (the generic route, which the snapshot observer selects): the
    moments lie in [0, 1], q2 >= x2 on average at this early time, and the
    overlap of a chain with itself at equal times is excluded."""
    fn = {"standard": pt.standardMC, "bkl": pt.bklMC}[sampler]
    out = px.stats_overlaps(
        lambda s: pt.GraphRRG(24, 3, (-1, 1), seed=s, **CPU), fn, 0.8, 96,
        chains=4, step=8, n_disorder=2, seed=5, sampler_kw=CPU)
    if sampler == "bkl":
        assert pt.LAST_ROUTE["backend"] == "torch"
    assert set(out) == {"t", "q2_mean", "q2_std", "x2_mean", "x2_std",
                        "q2_sem_disorder"}
    for k in ("x2_mean", "q2_std", "x2_std"):
        assert np.all(np.isfinite(out[k])) and np.all(
            (out[k] >= 0) & (out[k] <= 1)), k
    q2 = out["q2_mean"][1:]
    assert np.all((q2 >= 0) & (q2 <= 1))
    assert float(np.mean(q2)) >= float(np.mean(out["x2_mean"][1:]))


def test_equilibrated_factors_on_the_cpu():
    """GraphRRG(64, 3) at tiny equil_sweeps and target_s on the kernels'
    plain versions: the JAX function's keys (as bench_all_results.json
    records them), rows for all four samplers on their kernel routes, one
    equilibration call, and each row re-measured until it lasted
    target_s / 2."""
    m = pt.GraphRRG(64, 3, (-1, 1), seed=167, **CPU)
    r = px.equilibrated_factors(m, 2.0, chains=8, equil_sweeps=5,
                                target_s=0.02, **CPU)
    rec = json.loads((ROOT / "bench_all_results.json").read_text())
    jax_keys = set(rec["factors_sparse"][0]) - {"graph", "kernel"}
    assert set(r) == jax_keys
    assert r["equil_segments"] == 1 and r["equil_virtual_iters"] == 5 * 64
    assert set(r["rows"]) == {"standard", "rrr", "bkl", "wtm"}
    routes = {k: (row["backend"], row["impl"]) for k, row in r["rows"].items()}
    assert routes == {"standard": ("kernel-site", "plain"),
                      "rrr": ("kernel-rejfree-sparse", "plain"),
                      "bkl": ("kernel-rejfree-sparse", "plain"),
                      "wtm": ("kernel-rejfree-sparse", "plain")}
    for k, row in r["rows"].items():
        assert set(rec["factors_sparse"][0]["rows"][k]) <= set(row) | {
            "backend"}
        assert row["wall_s"] >= 0.01 and row["iters_per_s"] > 0
        assert -2.0 < row["E_per_spin"] < 0
    f = r["factors_vs_rrr"]
    assert f["rrr"] == 1.0 and all(np.isfinite(v) and v > 0
                                   for v in f.values())
    assert -2.0 < r["E_per_spin_eq"] < 0
    for k in ("rrr", "bkl", "wtm"):
        assert 0 < r["rows"][k]["mean_z_over_n"] <= 1
