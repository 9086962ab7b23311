"""Experiment harness: timing, the equal-wallclock factor tables, and the
time-binned energy and overlap statistics of the reference's paper scripts
(scripts.jl: each `*_factor` is how many nominal iterations a sampler
completes in the wall-clock time of one rrrMC iteration; stats_time and
stats_overlaps).

Times are host wall-clock around work that ends in a device synchronize
(`torch.cuda.synchronize()` for a CUDA state), so they include the kernels
and not only their enqueue.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch


def _sync(t: torch.Tensor):
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def runtest(sampler: Callable, model, beta: float, iters: int, *,
            chains: int = 64, step: Optional[int] = None, seed: int = 167,
            **kw) -> Dict:
    """Timing harness (the reference's runtest): one cold run (kernel build
    included), then the best of two warm runs continuing its state; reports
    wall-clock, iterations/s, flips/s, acceptance and the final energy."""
    from .samplers.common import LAST_ROUTE

    step = step or max(1, iters // 100)
    t0 = time.perf_counter()
    Es, state = sampler(model, beta, iters, step=step, chains=chains,
                        seed=seed, **kw)
    _sync(state.E)
    t_cold = time.perf_counter() - t0
    t_warm = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        Es, state = sampler(model, beta, iters, step=step, chains=chains,
                            state=state, **kw)
        _sync(state.E)
        t_warm = min(t_warm, time.perf_counter() - t0)
    Es = Es.double().cpu()
    out = {
        "sampler": getattr(sampler, "__name__", str(sampler)),
        "backend": LAST_ROUTE.get("backend", "unknown"),
        "impl": LAST_ROUTE.get("impl"),
        "wall_cold_s": t_cold,
        "wall_warm_s": t_warm,
        "iters_per_s": iters / t_warm,
        "flips_per_s": iters * chains / t_warm,
        "accept_rate": float(state.accepted.double().mean()) / iters,
        "E_mean_final": float(Es[:, -1].mean()),
        "E_per_spin": float(Es[:, -1].mean()) / model.N,
    }
    if LAST_ROUTE.get("z_over_n") is not None:
        acc = LAST_ROUTE["acc"].double().clamp(min=1)
        zn = LAST_ROUTE["z_over_n"].double()
        out["mean_z_over_n"] = float((zn / acc).mean())
    return out


def runtest_wtm(model, beta: float, samples: int, *, chains: int = 64,
                step: float = 1.0, seed: int = 167, **kw) -> Dict:
    """WTM timing in nominal-Metropolis-iteration units: one unit of WTM
    global time corresponds to N attempted Metropolis flips."""
    from . import wtmMC
    from .samplers.common import LAST_ROUTE

    t0 = time.perf_counter()
    Es, state = wtmMC(model, beta, samples, step=step, chains=chains,
                      seed=seed, **kw)
    _sync(state.E)
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    Es, state = wtmMC(model, beta, samples, step=step, chains=chains,
                      seed=seed, **kw)
    _sync(state.E)
    t_warm = time.perf_counter() - t0
    nominal_iters = step * samples
    return {"sampler": "wtmMC", "wall_cold_s": t_cold, "wall_warm_s": t_warm,
            "backend": LAST_ROUTE.get("backend", "unknown"),
            "impl": LAST_ROUTE.get("impl"),
            "iters_per_s": nominal_iters / t_warm,
            "E_per_spin": float(Es[:, -1].double().mean()) / model.N}


def equal_wallclock_factors(model, beta: float, *, iters: int = 20_000,
                            chains: int = 64, seed: int = 167,
                            samplers: Optional[Dict[str, Callable]] = None,
                            include_wtm: bool = True,
                            **kw) -> Dict[str, float]:
    """Per-iteration speed of each sampler relative to rrrMC (the
    reference's `*_factor` alignment constants). Factor > 1 means that
    sampler completes more nominal iterations than rrrMC in equal time.
    Extra keywords (e.g. device=) go to every sampler. Every sampler runs
    on its kernel route (backend="kernel") unless `backend` says otherwise:
    standardMC's default torch route is an eager loop of small ops per
    move, which would time launch overhead against kernels."""
    from . import bklMC, rrrMC, standardMC

    kw.setdefault("backend", "kernel")

    if samplers is None:
        samplers = {"standard": standardMC, "rrr": rrrMC, "bkl": bklMC}
    rates = {}
    for name, fn in samplers.items():
        r = runtest(fn, model, beta, iters, chains=chains, seed=seed, **kw)
        rates[name] = r["iters_per_s"]
    if include_wtm:
        # match nominal length: samples * step = iters
        samples = max(10, iters // model.N)
        r = runtest_wtm(model, beta, samples, chains=chains,
                        step=iters / samples, seed=seed, **kw)
        rates["wtm"] = r["iters_per_s"]
    base = rates.get("rrr")
    return {name: rate / base for name, rate in rates.items()}


def equilibrated_factors(model, beta: float, *, chains: int = 128,
                         seed: int = 167, equil_sweeps: int = 1000,
                         densified=None, target_s: float = 6.0,
                         device=None) -> Dict:
    """Equal-wallclock sampler factors measured FROM EQUILIBRIUM, every
    sampler on its kernel: the regime of the reference's alignment table
    (scripts.jl:34-37, 163-166, which characterizes equilibrated
    low-acceptance dynamics, not transients).

    model: a sparse Pairwise (GraphRRG / GraphRRGNormal). Metropolis runs
    the site kernel on it (standardMC(backend="kernel")); rrr, bkl and wtm
    run the race kernel on `densified`, which defaults to `model` itself
    (the sparse race kernel: one route, one table); a caller may pass
    densify(model) for the dense race kernel. Equilibration is
    `equil_sweeps * N` virtual iterations of kernel BKL from a random start
    in one bklMC call; every measured row then warm-starts from the SAME
    equilibrated spins. Rows at beta >= 3 still relax while they are
    measured (their E/N falls below E_per_spin_eq), so a row's E/N and z/N
    depend on its length; E_per_spin_eq is the quantity of the law alone.

    Each row is timed around torch.cuda.synchronize() (a CUDA state) and
    re-measured until a run lasts >= target_s / 2 (see `measure`). A race
    row's nominal iterations stop at MAX_ITERS, the kernels' int32
    coordinate: such a row may then last less. Returns the JAX package's
    keys: factors vs rrr plus per-row diagnostics (acceptance or moves per
    iteration, mean z/N, absolute rates, route)."""
    from . import bklMC, rrrMC, standardMC, wtmMC
    from .samplers.bkl import MAX_ITERS
    from .samplers.common import LAST_ROUTE

    Xd = model if densified is None else densified
    N = model.N
    t0 = time.perf_counter()
    virtual = equil_sweeps * N
    _, st_eq = bklMC(Xd, beta, virtual, step=virtual, chains=chains,
                     seed=seed, backend="kernel", device=device)
    _sync(st_eq.E)
    t_eq = time.perf_counter() - t0
    C0 = st_eq.sigma
    # applied BKL moves per chain: at high beta the virtual-iteration
    # target is covered by long geometric skips, so a 1000-sweep
    # equilibration can be a few thousand moves
    eq_moves = float(st_eq.accepted.double().mean())

    def measure(model_m, call, probe_n, cap=None):
        """call(n, state_or_None) -> (Es, state): a cold run from C0 (it
        builds the kernels; not timed), a warm probe, then runs scaled
        toward target_s until one lasts >= target_s / 2. The rescale loops
        because the race kernels advance in 1024-move chunks: a short
        probe's wall-clock is quantized to whole chunks, and one linear
        extrapolation can under-shoot by the chunk fill factor. Growth is
        held to 16x a round, so a mis-scaled probe cannot turn into a run
        of minutes; `cap` bounds n."""
        _, st = call(probe_n, None)
        _sync(st.E)
        t0 = time.perf_counter()
        _, st = call(probe_n, st)
        _sync(st.E)
        dt = max(time.perf_counter() - t0, 1e-3)
        n = probe_n
        for _ in range(6):
            n = int(n * max(1.0, min(target_s / dt, 16.0)))
            if cap is not None:
                n = min(n, cap)
            acc0 = st.accepted.long()
            t0 = time.perf_counter()
            _, st2 = call(n, st)
            _sync(st2.E)
            dt = max(time.perf_counter() - t0, 1e-3)
            if dt >= target_s / 2 or n == cap:
                break
        accd = (st2.accepted.long() - acc0).double()
        row = {"backend": LAST_ROUTE.get("backend", "unknown"),
               "impl": LAST_ROUTE.get("impl"),
               "nominal_iters": n, "iters_per_s": n / dt, "wall_s": dt,
               "moves_or_accepts_per_iter": float(accd.mean()) / n,
               "E_per_spin": float(model_m.to_physical(st2.E).double()
                                   .mean()) / N}
        if LAST_ROUTE.get("z_over_n") is not None:
            zn = LAST_ROUTE["z_over_n"].double()
            ac = LAST_ROUTE["acc"].double().clamp(min=1)
            row["mean_z_over_n"] = float((zn / ac).mean())
        return row

    def kw(st):
        return {"C0": C0} if st is None else {"state": st}

    common = dict(chains=chains, seed=seed, backend="kernel", device=device)
    # probe lengths in sweeps: 20 for standard and bkl, 5 for wtm, 1/5 of
    # a sweep of rrr moves (the JAX package's probes at N = 10^4)
    rows = {}
    rows["standard"] = measure(model, lambda n, st: standardMC(
        model, beta, int(n), step=int(n), **common, **kw(st)), 20 * N)
    rows["rrr"] = measure(Xd, lambda n, st: rrrMC(
        Xd, beta, int(n), step=max(1, int(n)), **common, **kw(st)),
        max(1, N // 5), cap=MAX_ITERS)
    rows["bkl"] = measure(Xd, lambda n, st: bklMC(
        Xd, beta, int(n), step=max(1, int(n)), **common, **kw(st)), 20 * N,
        cap=MAX_ITERS)
    # wtm nominal iterations = global time * N (samples * step)
    rows["wtm"] = measure(Xd, lambda n, st: wtmMC(
        Xd, beta, 10, step=n / 10, **common, **kw(st)), 5 * N,
        cap=MAX_ITERS)
    base = rows["rrr"]["iters_per_s"]
    return {
        "beta": beta, "N": N, "chains": chains,
        "equil_sweeps": equil_sweeps, "equil_wall_s": t_eq,
        "equil_protocol": "fresh random start, kernel BKL, one call",
        "equil_virtual_iters": virtual,
        "equil_segments": 1,
        "equil_moves_per_chain": eq_moves,
        "E_per_spin_eq": float(Xd.to_physical(st_eq.E).double().mean())
        / N,
        "factors_vs_rrr": {k: r["iters_per_s"] / base
                           for k, r in rows.items()},
        "rows": rows,
    }


def stats_time(Es, *, step: int = 1, nbins: int = 20,
               log: bool = True) -> Dict[str, np.ndarray]:
    """Time-binned energy statistics (the reference's stats_time):
    Es [chains, n_checkpoints] -> per-bin (t, mean, sem), log-spaced bins by
    default; the error bar is the chain-to-chain spread of the bin means."""
    Es = _numpy(Es).astype(np.float64)
    B, n = Es.shape
    ts = (np.arange(n) + 1) * step
    if log:
        edges = np.unique(np.geomspace(1, n, nbins + 1).astype(np.int64))
    else:
        edges = np.linspace(0, n, nbins + 1).astype(np.int64)
    t_out, mean, sem = [], [], []
    for a, b in zip(edges[:-1], edges[1:]):
        if b <= a:
            continue
        block = Es[:, a:b]
        t_out.append(ts[a:b].mean())
        mean.append(block.mean())
        sem.append(block.mean(axis=1).std() / np.sqrt(B))
    return {"t": np.array(t_out), "E_mean": np.array(mean),
            "E_sem": np.array(sem)}


def overlap_moments(configs, *, windows: Optional[Sequence] = None
                    ) -> Dict[str, np.ndarray]:
    """Self and cross overlap moments in log-spaced time windows (the q^2 /
    x^2 analysis of the reference's stats_overlaps), on the host.

    configs: [chains, n_checkpoints, N] +-1 snapshots.
    q2[w] = mean over pairs of distinct times in window w of
            (s_t . s_t')^2 / N^2 (same chain, self-overlap);
    x2[w] = mean over chain pairs at equal time of (s^a . s^b)^2 / N^2."""
    c = _numpy(configs).astype(np.int8)
    B, n, N = c.shape
    if windows is None:
        edges = np.unique(np.geomspace(1, n, 11).astype(np.int64)) - 1
        windows = list(zip(edges[:-1], edges[1:]))
    q2, x2, t_out = [], [], []
    for a, b in windows:
        if b <= a:
            continue
        blk = c[:, a:b].astype(np.float64)        # [B, w, N]
        w = b - a
        g = np.einsum("bwn,bvn->bwv", blk, blk) / N
        iu = np.triu_indices(w, 1)
        q2.append(float((g[:, iu[0], iu[1]] ** 2).mean()) if len(iu[0])
                  else np.nan)
        h = np.einsum("bwn,cwn->bcw", blk, blk) / N
        bu = np.triu_indices(B, 1)
        x2.append(float((h[bu[0], bu[1]] ** 2).mean()))
        t_out.append((a + b) / 2)
    return {"t": np.array(t_out), "q2": np.array(q2), "x2": np.array(x2)}


def config_series_observer():
    """Observer collecting spin snapshots at each checkpoint (the script
    hooks' configuration dumps). Pass it as a sampler's `observer=`; the
    series is then [chains, n_ckpt, N] int8."""
    def obs(model, sigma, aux, E):
        return sigma
    return obs


# The overlap pipeline (the reference's parseovs / parsexovs /
# stats_overlaps): self overlaps over time pairs within a log window of one
# run, cross overlaps over time pairs between two independent runs of the
# same disorder, means and population stds per window, averaged over
# disorder realizations. The chain axis supplies the independent runs:
# chains (2i, 2i+1) are the reference's (s1, s2) run pairs.

def log_windows(times, *, t0: Optional[float] = None, incr: float = 2.0):
    """Checkpoint-index windows [a, b) whose times fall in
    [t0 incr^k, t0 incr^(k+1)) (the reference's LogRange windowing).
    Returns (windows, t_centers)."""
    times = np.asarray(times, np.float64)
    if t0 is None:
        t0 = float(times[0])
    edges_t, t = [], t0
    while t <= times[-1] * (1 + 1e-12):
        edges_t.append(t)
        t *= incr
    edges_t.append(t)
    idx = np.searchsorted(times, np.array(edges_t) * (1 - 1e-12))
    windows, centers = [], []
    for k in range(len(edges_t) - 1):
        a, b = int(idx[k]), int(idx[k + 1])
        if b - a >= 1:
            windows.append((a, b))
            centers.append(edges_t[k])
    return windows, np.array(centers)


def overlap_window_moments(configs: torch.Tensor, idx: torch.Tensor,
                           valid: torch.Tensor):
    """Per-window overlap moments on the snapshots' device.

    configs: [B, n, N] +-1 spins (B even: chains 2i / 2i+1 are run pairs);
    idx / valid: [W, wmax] padded checkpoint indices of each window.
    Returns (mq2, sq2, mx2, sx2), each [W]: the self and cross second
    moments and their population stds. The Gram products take the +-1
    values as float32, where they and every sum of fewer than 2^24 of them
    are exact; the moments are summed in float64."""
    B, n, N = configs.shape
    S = configs.to(torch.float32)
    Sw = S[:, idx] * valid[None, :, :, None].to(torch.float32)
    inv = 1.0 / N
    pair_ok = (valid[:, :, None] & valid[:, None, :]).to(torch.float64)
    # self: distinct time pairs within each window of the same run
    G = torch.einsum("bwun,bwvn->bwuv", Sw, Sw).double() * inv
    wmax = idx.shape[1]
    iu = torch.triu(torch.ones((wmax, wmax), dtype=torch.float64,
                               device=S.device), diagonal=1)
    m_self = pair_ok * iu[None]
    q2 = G * G
    n_self = torch.clamp(m_self.sum((1, 2)), min=1.0)
    mq2 = (q2 * m_self[None]).sum((0, 2, 3)) / (B * n_self)
    mq4 = (q2 * q2 * m_self[None]).sum((0, 2, 3)) / (B * n_self)
    sq2 = torch.sqrt(torch.clamp(mq4 - mq2 ** 2, min=0.0))
    # cross: every time pair between the two runs of a pair, equal times
    # included
    H = torch.einsum("bwun,bwvn->bwuv", Sw[0::2], Sw[1::2]).double() * inv
    x2 = H * H
    n_x = torch.clamp(pair_ok.sum((1, 2)), min=1.0)
    P = B // 2
    mx2 = (x2 * pair_ok[None]).sum((0, 2, 3)) / (P * n_x)
    mx4 = (x2 * x2 * pair_ok[None]).sum((0, 2, 3)) / (P * n_x)
    sx2 = torch.sqrt(torch.clamp(mx4 - mx2 ** 2, min=0.0))
    return mq2, sq2, mx2, sx2


def overlap_stats(configs, times, *, t0: Optional[float] = None,
                  incr: float = 2.0) -> Dict[str, np.ndarray]:
    """Windowed self / cross overlap statistics of one disorder
    realization (one 'overlaps_<tag>_sx<seed>.txt' of the reference).

    configs: [B, n_ckpt, N] +-1 snapshots (a tensor on any device, or a
    host array; B even: chains 2i, 2i+1 are the reference's two runs);
    times: [n_ckpt] checkpoint times. The moments are computed on the
    snapshots' device. Returns {"t", "q2_mean", "q2_std", "x2_mean",
    "x2_std"} per log window."""
    if configs.shape[0] % 2:
        raise ValueError("overlap_stats needs an even number of chains "
                         "(chains 2i/2i+1 form the reference's run pairs)")
    configs = torch.as_tensor(configs)
    windows, centers = log_windows(times, t0=t0, incr=incr)
    wmax = max(b - a for a, b in windows)
    idx = np.zeros((len(windows), wmax), np.int64)
    val = np.zeros((len(windows), wmax), bool)
    for k, (a, b) in enumerate(windows):
        idx[k, : b - a] = np.arange(a, b)
        val[k, : b - a] = True
    dev = configs.device
    mq2, sq2, mx2, sx2 = overlap_window_moments(
        configs, torch.as_tensor(idx, device=dev),
        torch.as_tensor(val, device=dev))
    return {"t": centers, "q2_mean": _numpy(mq2), "q2_std": _numpy(sq2),
            "x2_mean": _numpy(mx2), "x2_std": _numpy(sx2)}


def stats_overlaps(builder: Callable, sampler: Callable, beta: float,
                   iters, *, chains: int = 16, step=None, n_disorder: int = 4,
                   seed: int = 8370274, t0: Optional[float] = None,
                   incr: float = 2.0, sampler_kw: Optional[Dict] = None
                   ) -> Dict[str, np.ndarray]:
    """Disorder-averaged overlap table (the reference's stats_overlaps end
    to end): for each disorder seed, run `sampler` with snapshot
    collection, window the snapshots log-uniformly and average the
    per-window self / cross moments over the realizations, one after
    another.

    builder(disorder_seed) -> model; sampler is any of standardMC, rrrMC,
    bklMC and wtmMC (called as (model, beta, iters, step=, chains=, seed=,
    observer=, **sampler_kw); pass device= in sampler_kw, and build the
    model on that device). Returns {"t", "q2_mean", "q2_std", "x2_mean",
    "x2_std", "q2_sem_disorder"}; q2 - x2 > 0 signals unequilibrated
    glassy dynamics."""
    sampler_kw = dict(sampler_kw or {})
    if step is None:
        step = (max(1, int(iters) // 128) if isinstance(iters, int)
                else iters / 128)
    rows = []
    for d in range(n_disorder):
        model = builder(seed + d)
        series, _ = sampler(model, beta, iters, step=step, chains=chains,
                            seed=seed + 1000 + d,
                            observer=config_series_observer(), **sampler_kw)
        n_ckpt = series.shape[1]
        times = (np.arange(n_ckpt) + 1) * step
        rows.append(overlap_stats(series, times, t0=t0, incr=incr))
    L = min(len(r["t"]) for r in rows)
    out = {"t": rows[0]["t"][:L]}
    for k in ("q2_mean", "q2_std", "x2_mean", "x2_std"):
        out[k] = np.mean([r[k][:L] for r in rows], axis=0)
    out["q2_sem_disorder"] = (np.std([r["q2_mean"][:L] for r in rows],
                                     axis=0) / np.sqrt(n_disorder))
    return out


def _numpy(x) -> np.ndarray:
    """A host numpy copy of a tensor on any device, or of an array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)
