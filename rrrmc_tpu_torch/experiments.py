"""Experiment harness: timing and the equal-wallclock factor table of the
reference's paper scripts (scripts.jl: each `*_factor` is how many nominal
iterations a sampler completes in the wall-clock time of one rrrMC
iteration).

Times are host wall-clock around work that ends in a device synchronize
(`torch.cuda.synchronize()` for a CUDA state), so they include the kernels
and not only their enqueue.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

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
