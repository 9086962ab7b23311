"""The scoreboard of the PyTorch port (rrrmc_tpu_torch): the JAX package's
scripts/bench_all.py on one CUDA card, section by section, with the same
builders, seeds, shapes, chain counts and beta, written as one JSON file.

    python scripts/torch_bench_all.py [section|all] [out.json] [--device cpu]

Sections (the JAX file's names): kernels, factors, factors_sparse,
factors_chains (stored as factors_chains_beta4), sat, perc_comm,
composite_sparse, sparse_chains, disorder, factors_sparse_chains,
sat_factors. The default output is chiprun_out/torch_bench_all_results.json;
a run keeps every section already in that file (and every kernels row
done), so sections run in separate calls merge. Its "device" field holds
the card's name and power limit as `nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader` gives them ("cpu" on
the host). The script runs on the card and exits non-zero without one
unless given --device cpu. A script in scripts/ needs the repo on
PYTHONPATH.

Each section function takes its sizes as keywords whose defaults are the
published ones: `sizes={row: {keyword: value}}` for the kernels section
(each row's model size, chains, run lengths, reps and probe target), and
N / chains / betas / equil_sweeps / target_s / probe lengths for the
others. SHORT holds the published shapes and chain counts with short run
lengths (chip_smoke.py runs them).

How the JAX script maps onto the port:
- backend="pallas" becomes the kernel route (backend="kernel"); every row
  of the row sections carries "route", LAST_ROUTE["backend"] after its
  timed call. A row whose JAX row has "backend" holds the same value there.
- backend="xla", the single-move engine, becomes backend="torch", the
  generic path.
- The jitted `_recompute_E` becomes model.energy: the running energy must
  equal it exactly for integer energies, within 1e-4 N for float Pairwise
  and FullyConnected models and within 1e-4 max(1, |E|) for the composites,
  perceptrons and committees (PERF.md section 2). EO rows hold E and Emin
  to the energies of sigma and sigma_min.
- `timed_best` and `_probe_scaled` are kept; `_probe_scaled` also stops n
  at the race kernels' int32 coordinate (samplers.bkl.MAX_ITERS), where a
  row then lasts less than its target.
- Keys only the TPU gives meaning: none is in the JAX artifact's rows (no
  VMEM, block_chains or compile seconds), so no row key is dropped. The
  factor sections' per-sampler rows drop `impl` ("cuda" / "plain" beside
  their route). Added keys (ADDED_KEYS): "route" on every row of the
  kernels, sat, composite_sparse, sparse_chains and disorder sections (the
  perc_comm rows carry theirs in *_backend and backend, as in the JAX
  file), and "note" on the disorder row. No key is renamed.
- The JAX artifact's rows eo_dense_float (kernels) and perc_step_eo
  (perc_comm), which its script no longer makes, are made here too.
- disorder: the JAX ratio isolated what the disorder loop adds over a
  shared compile; the port compiles nothing at run time, so the same
  ratio measures sample_disorder's per-instance set-up and launch cost.
- perc_comm: the committees run on the generic path at milliseconds a
  move, so their probe starts at 100 iterations (the perceptrons' at
  2000), and their generic bklMC runs chunks of 32 moves: it advances in
  whole chunks, and a 1024-move chunk would be most of a short row.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import torch

import rrrmc_tpu_torch as rt
from rrrmc_tpu_torch.bench import card_line, script_device
from rrrmc_tpu_torch.models.dense import FullyConnected
from rrrmc_tpu_torch.models.pairwise import Pairwise
from rrrmc_tpu_torch.parallel.mesh import leaves
from rrrmc_tpu_torch.samplers.bkl import MAX_ITERS

DEFAULT_OUT = "chiprun_out/torch_bench_all_results.json"

#: keys the port adds to the rows of a section (module docstring)
ADDED_KEYS = {"kernels": {"route"}, "sat": {"route"},
              "composite_sparse": {"route"}, "sparse_chains": {"route"},
              "disorder": {"route", "note"}}


def sync(x: torch.Tensor):
    """Wait for the device that holds x."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def _device_of(model) -> torch.device:
    return next(leaves(model)).device


def route() -> str:
    return rt.LAST_ROUTE.get("backend", "unknown")


def timed_best(fn, reps=3):
    best = float("inf")
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        best = min(best, dt)
    return best, out


def _probe_scaled(call, probe_n, target_s=8.0, cap=10_000.0, max_n=None):
    """Probe-calibrate a state-threaded sampler call so the measured call
    lasts ~target_s. call(n, state_or_None) -> state. Returns (n, dt,
    state); n stops at max_n."""
    st = call(probe_n, None)
    sync(st.E)
    t0 = time.perf_counter()
    st = call(probe_n, st)
    sync(st.E)
    dt = max(time.perf_counter() - t0, 1e-3)
    n = int(probe_n * max(1.0, min(target_s / dt, cap)))
    if max_n is not None:
        n = min(n, max_n)
    t0 = time.perf_counter()
    st = call(n, st)
    sync(st.E)
    return n, time.perf_counter() - t0, st


@functools.lru_cache(maxsize=6)
def build(kind: str, *args, device, **kw):
    """rt.<kind>(*args, seed=..., device=device), or densify of it for a
    kind "densify <builder>"; the last few are kept, so rows on one model
    share it."""
    if kind.startswith("densify "):
        return rt.densify(build(kind[8:], *args, device=device, **kw))
    return getattr(rt, kind)(*args, device=device, **kw)


def _per_energy(model) -> bool:
    """True where the float tolerance scales with |E| (composites,
    perceptrons, committees), not with N (float Pairwise / dense)."""
    return not isinstance(model, (Pairwise, FullyConnected))


def _check(model, got, want, what):
    if not want.dtype.is_floating_point:
        if not torch.equal(got.to(want.dtype), want):
            raise AssertionError(f"{what}: the running energy differs from "
                                 f"energy(sigma)")
        return
    d = (got.double() - want.double()).abs()
    tol = (1e-4 * want.double().abs().clamp(min=1.0) if _per_energy(model)
           else 1e-4 * model.N * abs(getattr(model, "scale", 1.0)))
    if not bool((d <= tol).all()):
        raise AssertionError(f"{what}: the running energy differs from "
                             f"energy(sigma) by {float(d.max())}")


def guard(model, st, what):
    """The running energy st.E (internal units) against model.energy."""
    _check(model, st.E, model.energy(st.sigma), what)


def guard_eo(model, r, what):
    """An EOResult's E and Emin against the energies of sigma and
    sigma_min (physical units; exact for integer energies)."""
    for got, sig in ((r.E, r.sigma), (r.Emin, r.sigma_min)):
        e = model.energy(sig)
        want = model.to_physical(e)
        if e.dtype.is_floating_point:
            _check(model, got, want, what)
        elif not torch.equal(got, want):
            raise AssertionError(f"{what}: the EO energies differ from "
                                 f"those of sigma and sigma_min")


# ---------------------------------------------------------------------------
# kernels section: one function a row, (device, **sizes) -> row
# ---------------------------------------------------------------------------

def bench_ea3d_sweep(dev, *, L=16, B=8192, beta=2.0, seg=100, nseg=5,
                     reps=3):
    X = build("GraphEA", L, 3, (-1, 1), seed=42, device=dev)
    _, st = rt.sweepMC(X, beta, 10, step=10, chains=B, seed=1,
                       device=dev, backend="kernel")
    sync(st.E)
    box = [st]

    def rep():
        for g in range(nseg):
            box[0] = rt.sweepMC(X, beta, seg, step=seg, state=box[0],
                                backend="kernel")[1]
        sync(box[0].E)
    dt, _ = timed_best(rep, reps)
    guard(X, box[0], "ea3d_checkerboard_sweep")
    return {"kernel": "ea3d_checkerboard_sweep", "N": X.N, "chains": B,
            "beta": beta, "flips_per_s": B * X.N * seg * nseg / dt,
            "route": route()}


def bench_dense(name, kind, args, seed, dev, *, N, B=8192, beta=2.0,
                sweeps=None, nseg=4, reps=3):
    """The dense sweep kernel through sweepMC_dense on rt.<kind>(N, *args,
    seed=seed)."""
    model = build(kind, N, *args, seed=seed, device=dev)
    N = model.N
    if sweeps is None:
        # ~2.4e11 attempted flips a timed rep, in nseg calls
        sweeps = max(8, int(2.4e11 / (B * N) / nseg))
    _, st = rt.sweepMC_dense(model, beta, 10, step=10, chains=B, seed=3,
                             device=dev, backend="kernel")
    sync(st.E)

    def rep():
        st2 = st
        for g in range(nseg):
            st2 = rt.sweepMC_dense(model, beta, sweeps, step=sweeps,
                                   state=st2, backend="kernel")[1]
        sync(st2.E)
        return st2
    dt, st2 = timed_best(rep, reps)
    guard(model, st2, name)
    sweeps = sweeps * nseg
    return {"kernel": name, "N": N, "chains": B, "beta": beta,
            "sweeps": sweeps, "flips_per_s": B * N * sweeps / dt,
            "route": route()}


def bench_site_kernel(dev, *, N=1024, B=4096, iters=2_000_000, warm=50_000,
                      reps=3):
    X = build("GraphRRG", N, 3, (-1, 1), seed=7, device=dev)
    _, st = rt.standardMC(X, 2.0, warm, step=warm, chains=B, seed=3,
                          device=dev, backend="kernel")
    sync(st.E)

    def rep():
        _, st2 = rt.standardMC(X, 2.0, iters, step=iters, state=st,
                               backend="kernel")
        sync(st2.E)
        return st2
    dt, st2 = timed_best(rep, reps)
    guard(X, st2, "single_site_metropolis")
    return {"kernel": "single_site_metropolis", "N": X.N, "chains": B,
            "beta": 2.0, "moves_chains_per_s": iters * B / dt,
            "route": route()}


def bench_rejfree_dense(dev, *, N=1024, B=1024, beta=4.0, seg=2_000_000,
                        step=20_000, nseg=4, warm=50_000, reps=3):
    """Dense BKL kernel: SK N=1024 at beta=4."""
    X = build("GraphSK", N, seed=4, device=dev)
    _, st = rt.bklMC(X, beta, warm, step=max(1, warm // 100), chains=B,
                     seed=3, device=dev, backend="kernel")
    sync(st.E)

    def rep():
        st2 = st
        for g in range(nseg):
            st2 = rt.bklMC(X, beta, seg, step=step, state=st2,
                           backend="kernel")[1]
        sync(st2.E)
        return st2
    dt, st2 = timed_best(rep, reps)
    guard(X, st2, "rejfree_bkl_dense_sk")
    return {"kernel": "rejfree_bkl_dense_sk", "N": X.N, "chains": B,
            "beta": beta, "virtual_iters_chains_per_s": seg * nseg * B / dt,
            "route": route()}


def bench_rrr(dense, dev, *, N=1024, L=8, B=1024, seg=None, step=None,
              nseg=4, reps=3):
    """rrr race kernel: moves*chains/s (1 move = 1 iteration)."""
    beta = 2.0
    X = (build("GraphSK", N, seed=4, device=dev) if dense
         else build("GraphEA", L, 3, (-1, 1), seed=42, device=dev))
    seg = seg or (100_000 if dense else 200_000)
    step = step or (1_000 if dense else 2_000)
    _, st = rt.rrrMC(X, beta, seg // 4, step=step, chains=B, seed=3,
                     device=dev, backend="kernel")
    sync(st.E)

    def rep():
        st2 = st
        for g in range(nseg):
            st2 = rt.rrrMC(X, beta, seg, step=step, state=st2,
                           backend="kernel")[1]
        sync(st2.E)
        return st2
    dt, st2 = timed_best(rep, reps)
    name = f"rrr_{'dense_sk' if dense else 'ea3d'}"
    guard(X, st2, name)
    return {"kernel": name, "N": X.N, "chains": B, "beta": beta,
            "moves_chains_per_s": seg * nseg * B / dt, "route": route()}


def bench_rejfree(mode, dev, *, L=8, B=1024, seg=None, nseg=4, reps=3):
    """Lattice race kernel at beta=4: bkl virtual iterations or wtm time
    units, state-threaded segments."""
    beta = 4.0
    X = build("GraphEA", L, 3, (-1, 1), seed=11, device=dev)
    fn = rt.bklMC if mode == "bkl" else rt.wtmMC
    if mode == "bkl":
        seg = seg or 10_000_000          # virtual iterations a segment
        step = 100_000
        _, st = fn(X, beta, seg, step=step, chains=B, seed=3,
                   device=dev, backend="kernel")
    else:
        seg = seg or 100                 # wtm: samples, step 10 time units
        step = 10.0
        _, st = fn(X, beta, 100, step=1.0, chains=B, seed=3,
                   device=dev, backend="kernel")
    sync(st.E)

    def rep():
        st2 = st
        for g in range(nseg):
            st2 = fn(X, beta, seg, step=step, state=st2,
                     backend="kernel")[1]
        sync(st2.E)
        return st2
    dt, st2 = timed_best(rep, reps)
    iters = seg * nseg * (1 if mode == "bkl" else step)
    guard(X, st2, f"rejfree_{mode}")
    unit = ("virtual_iters_chains_per_s" if mode == "bkl"
            else "time_units_chains_per_s")
    return {"kernel": f"rejfree_{mode}", "N": X.N, "chains": B,
            "beta": beta, unit: iters * B / dt, "route": route()}


def _race_call(fn, X, beta, B, mode="bkl"):
    """call(n, state_or_None) -> state for _probe_scaled."""
    def call(n, st):
        kwa = ({"state": st} if st is not None
               else {"seed": 3, "chains": B, "device": _device_of(X)})
        if mode == "wtm":
            return fn(X, beta, 10, step=n / 10, backend="kernel", **kwa)[1]
        return fn(X, beta, int(n), step=int(n), backend="kernel", **kwa)[1]
    return call


def bench_rejfree_stream(float_j, dev, *, N=None, B=128, probe=500_000,
                         target_s=8.0):
    """The dense race kernel on densify(GraphRRG(10^4)) (the reference's
    flagship workload) or GraphSKNormal(4096), bkl at beta=4."""
    beta = 4.0
    if float_j:
        X = build("GraphSKNormal", N or 4096, seed=4, device=dev)
        name = "rejfree_bkl_sknormal_stream"
    else:
        X = build("densify GraphRRG", N or 10_000, 3, (-1, 1), seed=7,
                  device=dev)
        name = "rejfree_bkl_rrg1e4_stream"
    n, dt, st = _probe_scaled(_race_call(rt.bklMC, X, beta, B), probe,
                              target_s, max_n=MAX_ITERS)
    guard(X, st, name)
    return {"kernel": name, "N": X.N, "chains": B, "beta": beta,
            "backend": route(), "virtual_iters_chains_per_s": n * B / dt,
            "moves_per_chain": float(st.accepted.double().mean()),
            "route": route()}


def bench_rrr_stream(dev, *, N=10_000, B=128, probe=5_000, target_s=8.0):
    """rrr on densify(GraphRRG(10^4)): the dense race kernel."""
    X = build("densify GraphRRG", N, 3, (-1, 1), seed=7, device=dev)
    n, dt, st = _probe_scaled(_race_call(rt.rrrMC, X, 2.0, B), probe,
                              target_s, max_n=MAX_ITERS)
    guard(X, st, "rrr_rrg1e4_stream")
    return {"kernel": "rrr_rrg1e4_stream", "N": X.N, "chains": B,
            "beta": 2.0, "moves_chains_per_s": n * B / dt, "route": route()}


def bench_rrr_stream_f32_wide(dev, *, N=10_000, B=512, probe=2_000,
                              target_s=8.0):
    """rrr on densify(GraphRRGNormal(10^4)), float J, 512 chains."""
    X = build("densify GraphRRGNormal", N, 3, seed=167, device=dev)
    n, dt, st = _probe_scaled(_race_call(rt.rrrMC, X, 2.0, B), probe,
                              target_s, max_n=MAX_ITERS)
    guard(X, st, "rrr_rrgnormal1e4_stream_bt512")
    return {"kernel": "rrr_rrgnormal1e4_stream_bt512", "N": X.N,
            "chains": B, "beta": 2.0, "backend": route(),
            "moves_chains_per_s": n * B / dt, "route": route()}


def bench_sparse(mode, float_j, dev, *, N=10_000, B=128, probe=None,
                 target_s=8.0):
    """The sparse race kernel on the undensified GraphRRG(10^4)."""
    if float_j:
        X = build("GraphRRGNormal", N, 3, seed=167, device=dev)
        name = f"{mode}_rrgnormal1e4_sparse"
    else:
        X = build("GraphRRG", N, 3, (-1, 1), seed=7, device=dev)
        name = f"{mode}_rrg1e4_sparse"
    beta = 2.0 if mode == "rrr" else 4.0
    fn = {"rrr": rt.rrrMC, "bkl": rt.bklMC, "wtm": rt.wtmMC}[mode]
    probe = probe or (20_000 if mode == "rrr" else 500_000)
    n, dt, st = _probe_scaled(_race_call(fn, X, beta, B, mode), probe,
                              target_s,
                              max_n=None if mode == "wtm" else MAX_ITERS)
    guard(X, st, name)
    unit = ("moves_chains_per_s" if mode == "rrr"
            else "virtual_iters_chains_per_s")
    return {"kernel": name, "N": X.N, "chains": B, "beta": beta,
            "backend": route(), unit: n * B / dt, "route": route()}


def bench_eo(kind, dev, *, N=1024, L=8, B=1024, iters=None, warm=1_000,
             reps=3):
    """The EO kernels: moves*chains/s, a fresh run a rep (the chains
    advance in lockstep). kind: "ea3d", "dense_sk" or "dense_float"
    (GraphSKNormal(1024))."""
    tau = 1.4
    if kind == "ea3d":
        X = build("GraphEA", L, 3, (-1, 1), seed=42, device=dev)
    elif kind == "dense_sk":
        X = build("GraphSK", N, seed=4, device=dev)
    else:
        X = build("GraphSKNormal", N, seed=4, device=dev)
    iters = iters or (400_000 if kind == "ea3d" else 100_000)
    r0 = rt.extremal_opt(X, tau, warm, chains=B, seed=3,
                         device=dev, backend="kernel")
    sync(r0.E)

    def rep():
        r = rt.extremal_opt(X, tau, iters, chains=B, seed=5,
                            device=dev, backend="kernel")
        sync(r.E)
        return r
    dt, r = timed_best(rep, reps)
    name = "eo_dense_float" if kind == "dense_float" else f"eo_{kind}"
    guard_eo(X, r, name)
    row = {"kernel": name, "N": X.N, "chains": B, "tau": tau,
           "moves_chains_per_s": iters * B / dt,
           "best_E_per_spin": float(r.Emin.min()) / X.N}
    if kind == "dense_float":
        row["note"] = ("GraphSKNormal(1024): float32 keys, the dense EO "
                       "kernel's coarse bins")
    row["route"] = route()
    return row


def bench_eo_stream(dev, *, N=4096, B=512, probe=500, target_s=8.0):
    """The dense EO kernel on GraphSKNormal(4096), float J."""
    tau = 1.4
    X = build("GraphSKNormal", N, seed=4, device=dev)

    def call(n, r0):
        # EO chains advance in lockstep; thread the final config as C0
        kwa = {"C0": r0.sigma} if r0 is not None else {}
        r = rt.extremal_opt(X, tau, int(n), chains=B, seed=5, device=dev,
                            backend="kernel", **kwa)
        sync(r.E)
        return r

    r = call(probe, None)
    t0 = time.perf_counter()
    r = call(probe, r)
    dt = max(time.perf_counter() - t0, 1e-3)
    n = int(probe * max(1.0, min(target_s / dt, 10_000.0)))
    t0 = time.perf_counter()
    r = call(n, r)
    dt = time.perf_counter() - t0
    guard_eo(X, r, "eo_sknormal4096_stream")
    return {"kernel": "eo_sknormal4096_stream", "N": X.N, "chains": B,
            "tau": tau, "moves_chains_per_s": n * B / dt,
            "best_E_per_spin": float(r.Emin.min()) / X.N, "route": route()}


def bench_eo_sparse(dev, *, kind="GraphRRG", N=10_000, B=128,
                    iters=None, warm=2_000, reps=3):
    """The sparse EO kernel on GraphRRG(10^4) (eo_rrg1e4_sparse), or the
    PSpin3 one on GraphPSpin3(7500, 3) (eo_pspin7500)."""
    tau = 1.4
    if kind == "GraphRRG":
        X = build("GraphRRG", N, 3, (-1, 1), seed=7, device=dev)
        name, iters = "eo_rrg1e4_sparse", iters or 200_000
    else:
        X = build("GraphPSpin3", N, 3, seed=7, device=dev)
        name, iters = "eo_pspin7500", iters or 100_000
    r0 = rt.extremal_opt(X, tau, warm, chains=B, seed=3,
                         device=dev, backend="kernel")
    sync(r0.E)

    def rep():
        r = rt.extremal_opt(X, tau, iters, chains=B, seed=5,
                            device=dev, backend="kernel")
        sync(r.E)
        return r
    dt, r = timed_best(rep, reps)
    guard_eo(X, r, name)
    return {"kernel": name, "N": X.N, "chains": B, "tau": tau,
            "moves_chains_per_s": iters * B / dt,
            "best_E_per_spin": float(r.Emin.min()) / X.N, "route": route()}


def bench_sweep_site(float_j, dev, *, N=10_000, B=1024, seg=60, nseg=4,
                     reps=3):
    """sweepMC on the undensified GraphRRG(10^4): the site-sweep route."""
    beta = 2.0
    if float_j:
        X = build("GraphRRGNormal", N, 3, seed=167, device=dev)
        name = "sweep_site_rrgnormal1e4"
    else:
        X = build("GraphRRG", N, 3, (-1, 1), seed=7, device=dev)
        name = "sweep_site_rrg1e4"
    _, st = rt.sweepMC(X, beta, 20, step=20, chains=B, seed=3,
                       device=dev, backend="kernel")
    sync(st.E)

    def rep():
        st2 = st
        for g in range(nseg):
            st2 = rt.sweepMC(X, beta, seg, step=seg, state=st2,
                             backend="kernel")[1]
        sync(st2.E)
        return st2
    dt, st2 = timed_best(rep, reps)
    guard(X, st2, name)
    return {"kernel": name, "N": X.N, "chains": B, "beta": beta,
            "backend": route(), "flips_per_s": B * X.N * seg * nseg / dt,
            "route": route()}


def bench_pspin(mode, dev, *, N=7500, B=128, probe=None, target_s=8.0):
    """The PSpin3 race kernel on GraphPSpin3(7500, 3)."""
    X = build("GraphPSpin3", N, 3, seed=7, device=dev)
    beta = 1.5 if mode == "bkl" else 1.0
    fn = rt.rrrMC if mode == "rrr" else rt.bklMC
    probe = probe or (20_000 if mode == "rrr" else 500_000)
    n, dt, st = _probe_scaled(_race_call(fn, X, beta, B), probe, target_s,
                              max_n=MAX_ITERS)
    guard(X, st, f"{mode}_pspin7500")
    unit = ("moves_chains_per_s" if mode == "rrr"
            else "virtual_iters_chains_per_s")
    return {"kernel": f"{mode}_pspin7500", "N": X.N, "chains": B,
            "beta": beta, "backend": route(), unit: n * B / dt,
            "route": route()}


#: the kernels section's rows in the JAX list's order (bench_all.py:510-521)
#: plus the JAX artifact's eo_dense_float: name -> row(device, **sizes)
KERNEL_ROWS = {
    "ea3d_checkerboard_sweep": bench_ea3d_sweep,
    "sk_dense_vmem": functools.partial(bench_dense, "sk_dense_vmem",
                                       "GraphSK", (), 4, N=1024),
    "sk_dense_hbm_streamed": functools.partial(
        bench_dense, "sk_dense_hbm_streamed", "GraphSK", (), 4, N=8192,
        B=2048),
    "rrg_densified_hbm": functools.partial(
        bench_dense, "rrg_densified_hbm", "densify GraphRRG",
        (3, (-1, 1)), 7, N=10_000, B=1024),
    "single_site_metropolis": bench_site_kernel,
    "rejfree_bkl": functools.partial(bench_rejfree, "bkl"),
    "rejfree_wtm": functools.partial(bench_rejfree, "wtm"),
    "rejfree_bkl_dense_sk": bench_rejfree_dense,
    "rejfree_bkl_rrg1e4_stream": functools.partial(bench_rejfree_stream,
                                                   False),
    "rejfree_bkl_sknormal_stream": functools.partial(bench_rejfree_stream,
                                                     True),
    "rrr_rrg1e4_stream": bench_rrr_stream,
    "rrr_rrgnormal1e4_stream_bt512": bench_rrr_stream_f32_wide,
    "rrr_rrg1e4_sparse": functools.partial(bench_sparse, "rrr", False),
    "bkl_rrg1e4_sparse": functools.partial(bench_sparse, "bkl", False),
    "wtm_rrg1e4_sparse": functools.partial(bench_sparse, "wtm", False),
    "rrr_rrgnormal1e4_sparse": functools.partial(bench_sparse, "rrr", True),
    "bkl_rrgnormal1e4_sparse": functools.partial(bench_sparse, "bkl", True),
    "rrr_ea3d": functools.partial(bench_rrr, False),
    "rrr_dense_sk": functools.partial(bench_rrr, True),
    "eo_ea3d": functools.partial(bench_eo, "ea3d"),
    "eo_dense_sk": functools.partial(bench_eo, "dense_sk"),
    "eo_dense_float": functools.partial(bench_eo, "dense_float"),
    "eo_sknormal4096_stream": bench_eo_stream,
    "eo_rrg1e4_sparse": bench_eo_sparse,
    "sweep_site_rrg1e4": functools.partial(bench_sweep_site, False),
    "sweep_site_rrgnormal1e4": functools.partial(bench_sweep_site, True),
    "bkl_pspin7500": functools.partial(bench_pspin, "bkl"),
    "rrr_pspin7500": functools.partial(bench_pspin, "rrr"),
    "eo_pspin7500": functools.partial(bench_eo_sparse, kind="GraphPSpin3",
                                      N=7500),
}


def kernels_section(done=(), checkpoint=None, *, device="cuda", sizes=None):
    """Every row of KERNEL_ROWS not in `done`; sizes[row] overrides that
    row's keywords."""
    out = list(done)
    have = {r["kernel"] for r in out}
    sizes = sizes or {}
    for name, fn in KERNEL_ROWS.items():
        if name in have:
            continue
        r = fn(torch.device(device), **sizes.get(name, {}))
        print(json.dumps(r), flush=True)
        out.append(r)
        if checkpoint:
            checkpoint(out)
    return out


# ---------------------------------------------------------------------------
# the factor sections
# ---------------------------------------------------------------------------

def _factor_row(X, beta, chains, Xd, equil_sweeps, target_s, device,
                **extra):
    row = rt.experiments.equilibrated_factors(
        X, beta, chains=chains, densified=Xd, equil_sweeps=equil_sweeps,
        target_s=target_s, device=device)
    for r in row["rows"].values():
        r.pop("impl", None)      # "cuda" / "plain": the JAX rows lack it
    row.update(extra)
    print(json.dumps(row), flush=True)
    return row


def _graphs(N, device):
    return [("rrg_pmJ", lambda: rt.GraphRRG(N, 3, (-1, 1), seed=167,
                                            device=device)),
            ("rrg_normal", lambda: rt.GraphRRGNormal(N, 3, seed=167,
                                                     device=device))]


def factors_section(*, device="cuda", N=10_000, chains=128,
                    betas=(2.0, 3.0, 4.0), equil_sweeps=1000, target_s=6.0):
    """Equal-wallclock factors from equilibrium, rrr/bkl/wtm on
    densify(model) (the dense race kernel), Metropolis on the site
    kernel."""
    out = []
    for name, builder in _graphs(N, device):
        X = builder()
        Xd = rt.densify(X)
        for beta in betas:
            out.append(_factor_row(X, beta, chains, Xd, equil_sweeps,
                                   target_s, device, graph=name))
    return out


def factors_sparse_section(*, device="cuda", N=10_000, chains=128,
                           betas=(2.0, 3.0, 4.0), equil_sweeps=1000,
                           target_s=6.0):
    """The same construction with rrr/bkl/wtm on the sparse race kernel."""
    out = []
    for name, builder in _graphs(N, device):
        X = builder()
        for beta in betas:
            out.append(_factor_row(X, beta, chains, X, equil_sweeps,
                                   target_s, device, graph=name,
                                   kernel="sparse"))
    return out


def factors_chain_scaling_section(*, device="cuda", N=10_000,
                                  chain_counts=(128, 512, 1024),
                                  equil_sweeps=1000, target_s=6.0):
    """Chain-count sensitivity of the densified table at beta=4."""
    X = rt.GraphRRG(N, 3, (-1, 1), seed=167, device=device)
    Xd = rt.densify(X)
    return [_factor_row(X, 4.0, chains, Xd, equil_sweeps, target_s, device,
                        graph="rrg_pmJ") for chains in chain_counts]


def factors_sparse_chains_section(*, device="cuda", N=10_000,
                                  chain_counts=(1024,), equil_sweeps=1000,
                                  target_s=6.0):
    """factors_sparse at beta=4, +-J, 1024 chains."""
    X = rt.GraphRRG(N, 3, (-1, 1), seed=167, device=device)
    return [_factor_row(X, 4.0, chains, X, equil_sweeps, target_s, device,
                        graph="rrg_pmJ", kernel="sparse")
            for chains in chain_counts]


# ---------------------------------------------------------------------------
# the other row sections
# ---------------------------------------------------------------------------

def sat_section(*, device="cuda", N=10_000, chains=128, probe_bkl=200_000,
                probe_rrr=2_000, target_s=8.0, eo_warm=1000,
                eo_iters=30_000):
    """Random 3-SAT N=10^4, alpha=4.2 on the K-SAT race and EO kernels:
    bkl virtual iters*chains/s and rrr moves*chains/s at beta=4, EO best
    E."""
    B, beta = chains, 4.0
    X = rt.GraphSAT(N, 3, 4.2, seed=167, device=device)
    out = []

    def rf_row(mode, fn, probe, unit):
        n, dt, st = _probe_scaled(_race_call(fn, X, beta, B), probe,
                                  target_s, max_n=MAX_ITERS)
        if route() != "kernel-rejfree-sat":
            raise AssertionError(f"sat_{mode}: route {route()}")
        guard(X, st, f"sat_{mode}")
        return {"kernel": f"sat_{mode}", "N": X.N, "alpha": 4.2,
                "chains": B, "beta": beta, "Cmax": X.Cmax,
                unit: n * B / dt, "wall_s": dt,
                "E_per_spin": float(X.to_physical(st.E).double().mean())
                / X.N, "route": route()}

    out.append(rf_row("bkl", rt.bklMC, probe_bkl,
                      "virtual_iters_chains_per_s"))
    print(json.dumps(out[-1]), flush=True)
    out.append(rf_row("rrr", rt.rrrMC, probe_rrr, "moves_chains_per_s"))
    print(json.dumps(out[-1]), flush=True)
    r = rt.extremal_opt(X, 1.4, eo_warm, chains=B, seed=7, device=device)
    sync(r.Emin)
    t0 = time.perf_counter()
    r = rt.extremal_opt(X, 1.4, eo_iters, chains=B, seed=8, device=device)
    sync(r.Emin)
    dt = time.perf_counter() - t0
    guard_eo(X, r, "sat_eo")
    out.append({"kernel": "sat_eo", "N": X.N, "alpha": 4.2, "chains": B,
                "tau": 1.4, "moves_chains_per_s": eo_iters * B / dt,
                "wall_s": dt, "best_E": float(r.Emin.min()),
                "mean_best_E": float(r.Emin.double().mean()),
                "route": route()})
    print(json.dumps(out[-1]), flush=True)
    return out


#: perc_comm families (bench_all.py:685-694): name -> (builder, args,
#: probe iterations, bklMC's chunk_moves). The committees run on the
#: generic path at milliseconds a move: their probe starts small, and
#: their generic bklMC runs chunks of 32 moves (not 1024), so a probe-scaled
#: run is not one chunk's quantum
PERC_COMM = {
    "perc_step": ("GraphPercStep", (1023, 511), 2_000, 1024),
    "perc_linear": ("GraphPercLinear", (1023, 511), 2_000, 1024),
    "perc_xentr": ("GraphPercXEntr", (1023, 511, 1.0), 2_000, 1024),
    # CommStep wants odd layer sizes, CommReLU / Qu even (the reference's
    # own constraints): the nearest shapes of ~1e3 weights
    "comm_step": ("GraphCommStep", (65, 15, 487), 100, 32),
    "comm_relu": ("GraphCommReLU", (64, 16, 487), 100, 32),
    "comm_qu": ("GraphCommQu", (64, 16, 487), 100, 32),
}


def perc_comm_section(*, device="cuda", chains=256, families=None,
                      target_s=6.0, probe_scale=1.0, eo_iters=20_000,
                      eo_warm=1_000):
    """Perceptron and committee rows: moves*chains/s of standardMC (the
    generic path), rrrMC and bklMC ("auto": the perceptrons' race kernel,
    the committees' generic path), the factors vs standardMC; then the
    step perceptron's EO row."""
    B, beta = chains, 1.0
    fams = families or PERC_COMM
    out = []
    for name, (kind, args, probe, chunk) in fams.items():
        X = getattr(rt, kind)(*args, seed=5, device=device)
        row = {"family": name, "N": X.N, "chains": B, "beta": beta}
        for sname, fn, be, kw in (
                ("standard", rt.standardMC, "torch", {}),
                ("rrr", rt.rrrMC, "auto", {}),
                ("bkl", rt.bklMC, "auto", {"chunk_moves": chunk})):
            def call(n, st, fn=fn, be=be, kw=kw):
                kwa = ({"state": st} if st is not None
                       else {"seed": 3, "chains": B, "device": device})
                return fn(X, beta, int(n), step=int(n), backend=be,
                          **kw, **kwa)[1]
            n, dt, st = _probe_scaled(call, max(1, int(probe * probe_scale)),
                                      target_s=target_s, max_n=MAX_ITERS)
            guard(X, st, f"{name} {sname}")
            row[f"{sname}_iters_chains_per_s"] = n * B / dt
            row[f"{sname}_backend"] = route()
        row["factor_rrr_vs_standard"] = (row["rrr_iters_chains_per_s"]
                                         / row["standard_iters_chains_per_s"])
        row["factor_bkl_vs_standard"] = (row["bkl_iters_chains_per_s"]
                                         / row["standard_iters_chains_per_s"])
        print(json.dumps(row), flush=True)
        out.append(row)
    kind, args, _, _ = fams.get("perc_step", PERC_COMM["perc_step"])
    X = getattr(rt, kind)(*args, seed=5, device=device)
    r = rt.extremal_opt(X, 1.4, eo_warm, chains=B, seed=7, device=device)
    sync(r.E)
    t0 = time.perf_counter()
    r = rt.extremal_opt(X, 1.4, eo_iters, chains=B, seed=8, device=device)
    sync(r.E)
    dt = time.perf_counter() - t0
    guard_eo(X, r, "perc_step_eo")
    out.append({"family": "perc_step_eo", "N": X.N, "P": X.P, "chains": B,
                "tau": 1.4, "moves_chains_per_s": eo_iters * B / dt,
                "wall_s": dt, "best_E": float(r.Emin.min()),
                "mean_best_E": float(r.Emin.double().mean()),
                "backend": route()})
    print(json.dumps(out[-1]), flush=True)
    return out


def composite_sparse_section(*, device="cuda", Nk=1000, M=8, chains=128,
                             target_s=6.0, probe_rrr=1_000,
                             probe_bkl=50_000, probe_tle=20):
    """Quant(RRG) and RE(RRG) on the replica race kernel (sparse base): rrr
    moves*chains/s and bkl virtual iters*chains/s; TLE's composite-mask
    sweep rate."""
    B = chains
    out = []
    cases = [
        ("quant_rrg", rt.GraphQuant(Nk, M, 1.0, 1.0, rt.GraphRRG(
            Nk, 3, (-1, 1), seed=11, device=device)), 1.0),
        ("re_rrg", rt.GraphRobustEnsemble(Nk, M, 2.0, 1.0, rt.GraphRRG(
            Nk, 3, (-1, 1), seed=12, device=device)), 1.0),
    ]
    for name, X, beta in cases:
        for mode, fn, probe, unit in (
                ("rrr", rt.rrrMC, probe_rrr, "moves_chains_per_s"),
                ("bkl", rt.bklMC, probe_bkl, "virtual_iters_chains_per_s")):
            n, dt, st = _probe_scaled(_race_call(fn, X, beta, B), probe,
                                      target_s=target_s, max_n=MAX_ITERS)
            if route() != "kernel-rejfree-replica-sparse":
                raise AssertionError(f"{name}_{mode}: route {route()}")
            guard(X, st, f"{name}_{mode}")
            row = {"kernel": f"{name}_{mode}", "NM": X.N, "M": X.M,
                   "chains": B, "beta": beta, unit: n * B / dt,
                   "wall_s": dt, "route": route()}
            print(json.dumps(row), flush=True)
            out.append(row)
    T = rt.GraphTopologicalLocalEntropy(
        Nk, M, 0.5, 0.3, 1.0, rt.GraphRRG(Nk, 3, (-1, 1), seed=13,
                                          device=device))

    def call(n, st):
        kwa = ({"state": st} if st is not None
               else {"seed": 3, "chains": B, "device": _device_of(X)})
        return rt.sweepMC(T, 1.0, int(n), step=int(n), **kwa)[1]
    n, dt, st = _probe_scaled(call, probe_tle, target_s=target_s)
    guard(T, st, "tle_rrg_sweep")
    row = {"kernel": "tle_rrg_sweep", "NM": T.N, "M": T.M, "chains": B,
           "beta": 1.0, "sweeps_per_s": n / dt,
           "flips_chains_per_s": n * T.N * B / dt, "wall_s": dt,
           "route": route()}
    print(json.dumps(row), flush=True)
    out.append(row)
    return out


def sparse_chains_section(*, device="cuda", N=10_000, N_pspin=7500,
                          chain_counts=(128, 512, 1024), target_s=6.0,
                          probe_rrr=2_000, probe_bkl=500_000, eo_warm=500,
                          eo_iters=20_000):
    """rrr / bkl / EO on GraphRRG(10^4) and rrr on GraphPSpin3(7500) at
    128, 512 and 1024 chains, beta=4."""
    beta = 4.0
    X = rt.GraphRRG(N, 3, (-1, 1), seed=167, device=device)
    P = rt.GraphPSpin3(N_pspin, 3, seed=11, device=device)
    out = []
    for B in chain_counts:
        for name, X_, fn, probe, unit in (
                ("rrr_rrg1e4_sparse", X, rt.rrrMC, probe_rrr,
                 "moves_chains_per_s"),
                ("bkl_rrg1e4_sparse", X, rt.bklMC, probe_bkl,
                 "virtual_iters_chains_per_s"),
                ("rrr_pspin7500", P, rt.rrrMC, probe_rrr,
                 "moves_chains_per_s")):
            n, dt, st = _probe_scaled(_race_call(fn, X_, beta, B), probe,
                                      target_s=target_s, max_n=MAX_ITERS)
            guard(X_, st, name)
            row = {"kernel": name, "N": X_.N, "chains": B, "beta": beta,
                   unit: n * B / dt, "wall_s": dt, "route": route()}
            print(json.dumps(row), flush=True)
            out.append(row)
        r0 = rt.extremal_opt(X, 1.4, eo_warm, chains=B, seed=7, device=device)
        sync(r0.Emin)
        t0 = time.perf_counter()
        r = rt.extremal_opt(X, 1.4, eo_iters, chains=B, seed=8, device=device)
        sync(r.Emin)
        dt = time.perf_counter() - t0
        guard_eo(X, r, "eo_rrg1e4_sparse")
        row = {"kernel": "eo_rrg1e4_sparse", "N": X.N, "chains": B,
               "tau": 1.4, "moves_chains_per_s": eo_iters * B / dt,
               "wall_s": dt,
               "best_E_per_spin": float(r.Emin.min()) / X.N,
               "route": route()}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def sat_factors_section(*, device="cuda", N=10_000, chains=128,
                        equil_iters=None, equil_seg=2_000_000, target_s=6.0,
                        probes=(2_000, 100_000, 50_000, 2_000)):
    """Equal-wallclock K-SAT factors from equilibrium: Metropolis on the
    generic path (no site kernel takes K-SAT), bkl / wtm / rrr on the K-SAT
    race kernel; factors are iterations/s ratios to Metropolis. The
    equilibration is 200 N virtual iterations of kernel bkl in segments of
    `equil_seg` (the row's definition)."""
    B, beta = chains, 4.0
    X = rt.GraphSAT(N, 3, 4.2, seed=167, device=device)
    tgt = equil_iters or 200 * X.N
    st_eq, done, seg = None, 0, equil_seg
    t0 = time.perf_counter()
    while done < tgt:
        seg = min(seg, tgt - done)
        kwa = ({"state": st_eq} if st_eq is not None
               else {"seed": 167, "chains": B, "device": device})
        _, st_eq = rt.bklMC(X, beta, seg, step=seg, backend="kernel", **kwa)
        sync(st_eq.E)
        done += seg
    t_eq = time.perf_counter() - t0
    C0 = st_eq.sigma

    def measure(call, probe_n):
        st = call(probe_n, None)
        sync(st.E)
        t0 = time.perf_counter()
        st = call(probe_n, st)
        sync(st.E)
        dt = max(time.perf_counter() - t0, 1e-3)
        n = probe_n
        for _ in range(6):
            n = min(int(n * max(1.0, min(target_s / dt, 16.0))), MAX_ITERS)
            t0 = time.perf_counter()
            st2 = call(n, st)
            sync(st2.E)
            dt = max(time.perf_counter() - t0, 1e-3)
            if dt >= target_s / 2:
                break
        guard(X, st2, f"sat_factors {route()}")
        return {"backend": route(), "nominal_iters": n,
                "iters_per_s": n / dt, "wall_s": dt,
                "E_per_spin": float(X.to_physical(st2.E).double().mean())
                / X.N}

    def kw(st):
        return ({"C0": C0, "chains": B, "seed": 167, "device": device}
                if st is None
                else {"state": st})

    rows = {}
    rows["standard"] = measure(lambda n, st: rt.standardMC(
        X, beta, int(n), step=int(n), backend="torch", **kw(st))[1],
        probes[0])
    rows["bkl"] = measure(lambda n, st: rt.bklMC(
        X, beta, int(n), step=int(n), backend="kernel", **kw(st))[1],
        probes[1])
    rows["wtm"] = measure(lambda n, st: rt.wtmMC(
        X, beta, 10, step=n / 10, backend="kernel", **kw(st))[1],
        probes[2])
    rows["rrr"] = measure(lambda n, st: rt.rrrMC(
        X, beta, int(n), step=int(n), backend="kernel", **kw(st))[1],
        probes[3])
    base = rows["standard"]["iters_per_s"]
    res = {"N": X.N, "alpha": 4.2, "beta": beta, "chains": B,
           "equil_virtual_iters": tgt, "equil_wall_s": t_eq,
           "equil_protocol": "fresh random start, kernel BKL segments",
           "factors_vs_standard": {k: r["iters_per_s"] / base
                                   for k, r in rows.items()},
           "rows": rows}
    print(json.dumps(res), flush=True)
    return [res]


def disorder_section(*, device="cuda", N=10_000, chains=128, D=8,
                     iters=20_000_000):
    """8 GraphRRG(10^4) instances through sample_disorder(bklMC) against
    one fresh instance measured the same way (module docstring)."""
    from rrrmc_tpu_torch.parallel.mesh import sample_disorder

    B, beta = chains, 4.0
    models = [rt.GraphRRG(N, 3, (-1, 1), seed=100 + d, device=device)
              for d in range(D + 2)]
    it = iters
    # a spare instance first: the kernels' library is loaded and warm
    _, st = rt.bklMC(models[D + 1], beta, it, step=it, chains=B, seed=3,
                     device=device, backend="kernel")
    sync(st.E)
    t0 = time.perf_counter()
    _, st1 = sample_disorder(rt.bklMC, models[D:D + 1], beta, it,
                             chains=B, seed=7, step=it, backend="kernel")
    sync(st1.E)
    dt1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, sts = sample_disorder(rt.bklMC, models[:D], beta, it, chains=B,
                             seed=7, step=it, backend="kernel")
    sync(sts.E)
    dtD = time.perf_counter() - t0
    if route() != "kernel-rejfree-sparse" \
            or rt.LAST_ROUTE.get("disorder_instances") != D:
        raise AssertionError(f"disorder: route {rt.LAST_ROUTE}")
    for d in range(D):
        _check(models[d], sts.E[d], models[d].energy(sts.sigma[d]),
               f"disorder instance {d}")
    row = {"kernel": "disorder_bkl_rrg1e4", "N": N, "chains": B,
           "beta": beta, "instances": D, "wall_single_s": dt1,
           "wall_8x_s": dtD, "per_instance_efficiency": dt1 * D / dtD,
           "route": route(),
           "note": "no compile at run time: the ratio measures "
                   "sample_disorder's per-instance set-up (state, tables) "
                   "and launch cost against one instance, not what a "
                   "shared compile saves"}
    print(json.dumps(row), flush=True)
    return [row]


#: section name on the command line -> (key in the file, function)
SECTIONS = {
    "kernels": ("kernels", kernels_section),
    "factors": ("factors", factors_section),
    "factors_sparse": ("factors_sparse", factors_sparse_section),
    "factors_chains": ("factors_chains_beta4",
                       factors_chain_scaling_section),
    "sat": ("sat", sat_section),
    "perc_comm": ("perc_comm", perc_comm_section),
    "composite_sparse": ("composite_sparse", composite_sparse_section),
    "sparse_chains": ("sparse_chains", sparse_chains_section),
    "disorder": ("disorder", disorder_section),
    "factors_sparse_chains": ("factors_sparse_chains",
                              factors_sparse_chains_section),
    "sat_factors": ("sat_factors", sat_factors_section),
}

#: the published shapes and chain counts with short run lengths: a fraction
#: of a second of probe target and one rep a row (chip_smoke.py)
SHORT_TARGET = 0.2
SHORT = {
    "kernels": {
        "ea3d_checkerboard_sweep": dict(seg=20, nseg=1, reps=1),
        "sk_dense_vmem": dict(sweeps=20, nseg=1, reps=1),
        "sk_dense_hbm_streamed": dict(sweeps=4, nseg=1, reps=1),
        "rrg_densified_hbm": dict(sweeps=4, nseg=1, reps=1),
        "single_site_metropolis": dict(iters=200_000, warm=10_000, reps=1),
        "rejfree_bkl": dict(seg=1_000_000, nseg=1, reps=1),
        "rejfree_wtm": dict(seg=20, nseg=1, reps=1),
        "rejfree_bkl_dense_sk": dict(seg=200_000, nseg=1, warm=10_000,
                                     reps=1),
        "rejfree_bkl_rrg1e4_stream": dict(target_s=SHORT_TARGET),
        "rejfree_bkl_sknormal_stream": dict(target_s=SHORT_TARGET,
                                            probe=50_000),
        "rrr_rrg1e4_stream": dict(target_s=SHORT_TARGET, probe=1_000),
        "rrr_rrgnormal1e4_stream_bt512": dict(target_s=SHORT_TARGET,
                                              probe=500),
        "rrr_rrg1e4_sparse": dict(target_s=SHORT_TARGET, probe=2_000),
        "bkl_rrg1e4_sparse": dict(target_s=SHORT_TARGET),
        "wtm_rrg1e4_sparse": dict(target_s=SHORT_TARGET),
        "rrr_rrgnormal1e4_sparse": dict(target_s=SHORT_TARGET, probe=2_000),
        "bkl_rrgnormal1e4_sparse": dict(target_s=SHORT_TARGET,
                                        probe=100_000),
        "rrr_ea3d": dict(seg=20_000, step=2_000, nseg=1, reps=1),
        "rrr_dense_sk": dict(seg=10_000, step=1_000, nseg=1, reps=1),
        "eo_ea3d": dict(iters=40_000, warm=300, reps=1),
        "eo_dense_sk": dict(iters=10_000, warm=300, reps=1),
        "eo_dense_float": dict(iters=10_000, warm=300, reps=1),
        "eo_sknormal4096_stream": dict(target_s=SHORT_TARGET, probe=100),
        "eo_rrg1e4_sparse": dict(iters=20_000, warm=300, reps=1),
        "sweep_site_rrg1e4": dict(seg=10, nseg=1, reps=1),
        "sweep_site_rrgnormal1e4": dict(seg=10, nseg=1, reps=1),
        "bkl_pspin7500": dict(target_s=SHORT_TARGET),
        "rrr_pspin7500": dict(target_s=SHORT_TARGET, probe=2_000),
        "eo_pspin7500": dict(iters=10_000, warm=300, reps=1),
    },
    "sat": dict(target_s=SHORT_TARGET, probe_bkl=50_000, probe_rrr=500,
                eo_warm=300, eo_iters=3_000),
    "composite_sparse": dict(target_s=SHORT_TARGET, probe_tle=2),
    "sparse_chains": dict(chain_counts=(1024,), target_s=SHORT_TARGET,
                          probe_bkl=100_000, probe_rrr=500, eo_warm=100,
                          eo_iters=2_000),
    "disorder": dict(iters=1_000_000),
    "perc_comm": dict(target_s=SHORT_TARGET, probe_scale=0.1,
                      eo_warm=300, eo_iters=2_000),
}


def run(which, path, device, sizes=None, log=print):
    """Run section `which` (or "all") into the JSON file `path`, keeping
    every section already there. sizes: {section: keywords}."""
    sizes = sizes or {}
    res = {}
    if os.path.exists(path):          # resume: keep every prior section
        with open(path) as f:
            res = json.load(f)
    res["device"] = card_line() if device.type == "cuda" else "cpu"

    def write():
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(res, f, indent=1)

    def checkpoint(out):
        res["kernels"] = out
        write()

    for name, (key, fn) in SECTIONS.items():
        if which not in (name, "all"):
            continue
        t0 = time.perf_counter()
        if name == "kernels":
            res[key] = fn(res.get("kernels", ()), checkpoint, device=device,
                          sizes=sizes.get(name))
        else:
            res[key] = fn(device=device, **sizes.get(name, {}))
        log(f"section {name}: {time.perf_counter() - t0:.1f} s  "
            f"[{res['device']}]")
        write()
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("section", nargs="?", default="all",
                    choices=list(SECTIONS) + ["all"])
    ap.add_argument("out", nargs="?", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = script_device(args.device, "torch_bench_all")
    if device.type == "cuda":
        print(card_line(), flush=True)
    run(args.section, args.out, device)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    sys.exit(main())
