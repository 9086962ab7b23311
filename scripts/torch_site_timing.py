#!/usr/bin/env python3
"""Time the site kernel and the checkerboard sweep kernel of the PyTorch +
CUDA port on their kernel-table cases (PERF.md section 6: row 1, the site
kernel on GraphRRG(10^4, 3) +-J with 1024 chains, 10 000 moves, one
standardMC launch of the main path, 300 000 moves, and where the tree's
kernel takes a beta per chain the PT path's case, 32 betas over the 1024
chains and one sweep of the permutation schedule; row 3, the
checkerboard sweep on EA-3D L=16 +-J with 8192 chains, 100 sweeps, and a
launch of the benchmark's sweepMC call, 10 sweeps, without and, where the
tree's Sweeper takes `aux`, with the fields epilogue of a call's last
launch), for
the rrrmc_tpu_torch package under --root, so that two trees are timed in
one call on one card:

    python3 scripts/torch_site_timing.py --root DIR [--reps 6] [--paths]
        [--ablation]

Each case starts from init_state(seed=167) on one schedule (the site
kernel's drawn from a generator seeded 167, as chip_smoke.py draws it) and
runs through the tree's own wrapper (site.site_chunk, with the family's
bound on |lf| where the tree takes one; sweep.Sweeper), timed with CUDA
events: one untimed launch, then --reps launches, all printed with their
median, and the tree's plan where it records one.

--paths times the main paths' calls in the place of the kernel cases, as
chip_smoke.py runs them: standardMC(backend="kernel") on GraphRRG(10^4, 3)
(3 * 10^6 moves, 1024 chains, 10 launches), sweepMC's site-sweep route on
GraphRRG(10^4, 3) (100 sweeps, 1024 chains) and the port's benchmark line
(`rrrmc_tpu_torch.bench.measure`: EA-3D L=16, 8192 chains, best of 3 runs
of 1000 sweeps): one untimed call, then --reps calls, each on the host
clock around the call and a synchronize.

--ablation (this tree's kernels) takes the designs apart on the row cases
and the standardMC path: the site kernel's groups capped at 1 (each
chain's moves one by one on its resident state: a variant of csrc/site.cu
with kGroupMax = 1, built alone under rrrmc_tpu_torch/_build/ablation/ and
loaded in the place of the package's library) against the package's 32;
the sweep, launched through its C entry with the chains and threads a
block and the lane layout given here rather than the plan's: one chain a
block and one chain a lane (the division-free rows alone), the plan's
chains a block with one chain a lane (the chains in step), the plan's with
four chains a lane (the design), and other chains a block.

Prints one JSON line per case and the card's name and power limit; exits 1
without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

SEED = 167
BETA = 2.0
#: row 1: GraphRRG(N, 3) +-J, its chains, the row's moves and one
#: standardMC launch of the main path (3 * 10^6 moves in 10 launches)
SITE_N, SITE_B, SITE_MOVES, PATH_MOVES = 10_000, 1024, 10_000, 300_000
#: the PT path's ladder (chip_smoke.py): beta_t = PT_BETA0 + PT_DBETA t,
#: PT_CHAINS chains a rung
PT_BETA0, PT_DBETA, PT_CHAINS = 1.0, 0.02, 32
#: row 3: EA-3D L=16 +-J (the bench's lattice, seed 42), chains, sweeps;
#: the sweeps of one launch of the benchmark's sweepMC call
SWEEP_L, SWEEP_B, SWEEPS, CALL_SWEEPS = 16, 8192, 100, 10
#: --paths: standardMC's moves and checkpoints, the site-sweep route's
#: sweeps and checkpoint step (chip_smoke.py's RRG and EA-3D paths)
MET_ITERS, MET_STEP, RRG_SWEEPS, RRG_STEP = 3_000_000, 300_000, 100, 10


def events_ms(torch, fn) -> float:
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def site_launcher(torch, rt, model, n_moves, ladder=False):
    """launch() of the tree's site wrapper on a fresh copy of the start:
    n_moves random sites at BETA, or with `ladder` the PT path's case (one
    sweep of the permutation schedule, chain t * PT_CHAINS + b at
    PT_BETA0 + PT_DBETA t)."""
    from rrrmc_tpu_torch.ops import site
    from rrrmc_tpu_torch.samplers.common import init_lfT
    from rrrmc_tpu_torch.samplers.families import half_bound

    st = rt.init_state(model, SITE_B, seed=SEED, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    sites = torch.randint(0, model.N, (n_moves,), generator=g,
                          device="cuda", dtype=torch.int32)
    beta_s = BETA * model.scale
    if ladder:
        sites = torch.as_tensor(site._perm_of(SEED, 0, model.N).astype(
            "int32"), device="cuda")
        beta_s = ((PT_BETA0 + PT_DBETA * torch.arange(
            SITE_B // PT_CHAINS, dtype=torch.float64)).repeat_interleave(
                PT_CHAINS) * model.scale).float().cuda()
    base = [st.sigma.t().contiguous(), init_lfT(model, st.sigma),
            st.E.clone(), torch.zeros(SITE_B, dtype=torch.int32,
                                      device="cuda")]
    extra = ({"field_bound": half_bound(model)} if "field_bound" in
             inspect.signature(site.site_chunk).parameters else {})

    def launch():
        a = [t.clone() for t in base]
        torch.cuda.synchronize()
        return a

    def run(a):
        site.site_chunk(*a, sites, model.neigh, model.J, seed=SEED,
                        beta_s=beta_s, **extra)

    return launch, run


def sweep_launcher(torch, rt, model, sweeps=SWEEPS, aux=False):
    """launch() of the tree's Sweeper on a fresh copy of the start, `sweeps`
    sweeps; with `aux` it also writes the fields (a call's last launch)."""
    from rrrmc_tpu_torch.ops import sweep

    sw = sweep.Sweeper(model, BETA)
    st = rt.init_state(model, SWEEP_B, seed=SEED, device="cuda")

    def launch():
        a = [st.sigma.clone(), st.E.clone()]
        if aux:
            a.append(torch.empty_like(st.sigma, dtype=torch.int32))
        torch.cuda.synchronize()
        return a

    def run(a):
        sw(*a[:2], seed=SEED, n_sweeps=sweeps,
           **({"aux": a[2]} if aux else {}))

    return launch, run, sw


def case_line(torch, root, card, label, row, fresh, run, reps, kernel,
              plan=None, **extra):
    """Time run() on fresh() inputs: a warm-up, then `reps` launches; the
    plan printed is `plan`, else the tree's last plan of `kernel`
    (ops/launch.py's PLANS)."""
    from rrrmc_tpu_torch.ops.launch import PLANS

    def once():
        a = fresh()
        return events_ms(torch, lambda: run(a))

    once()                                                # warm-up
    ms = [once() for _ in range(reps)]
    if plan is None:
        plan = PLANS.get(kernel)
    print(json.dumps({
        "root": root, "row": row, "case": label, "ms": ms,
        "median_ms": statistics.median(ms), "min_ms": min(ms),
        "plan": dict(plan) if plan else None, "card": card, **extra}),
        flush=True)


def kernel_cases(torch, rt, root, card, reps):
    from rrrmc_tpu_torch.ops import site, sweep

    m = rt.GraphRRG(SITE_N, 3, (-1, 1), seed=SEED, device="cuda")
    for label, n in (("RRG+-J, 10 000 moves (the row)", SITE_MOVES),
                     ("RRG+-J, 300 000 moves (a standardMC launch)",
                      PATH_MOVES)):
        fresh, run = site_launcher(torch, rt, m, n)
        case_line(torch, root, card, label, 1, fresh, run, reps, "site",
                  chains=SITE_B, moves=n)
    if hasattr(site, "chain_betas"):   # a tree whose kernel takes them
        fresh, run = site_launcher(torch, rt, m, m.N, ladder=True)
        case_line(torch, root, card, f"RRG+-J, {SITE_B // PT_CHAINS} betas "
                  f"a chain's rung, one sweep (the PT path's case)", 1,
                  fresh, run, reps, "site", chains=SITE_B, moves=m.N)
    lat = rt.GraphEA(SWEEP_L, 3, (-1, 1), seed=42, device="cuda")
    fresh, run, _ = sweep_launcher(torch, rt, lat)
    case_line(torch, root, card, "EA3D-L16+-J, 100 sweeps (the row)", 3,
              fresh, run, reps, "sweep", chains=SWEEP_B, sweeps=SWEEPS)
    takes_aux = "aux" in inspect.signature(sweep.Sweeper.__call__).parameters
    for aux in (False, True) if takes_aux else (False,):
        fresh, run, _ = sweep_launcher(torch, rt, lat, CALL_SWEEPS, aux)
        case_line(torch, root, card, f"EA3D-L16+-J, {CALL_SWEEPS} sweeps (a "
                  f"launch of the benchmark's call){', with aux' * aux}", 3,
                  fresh, run, reps, "sweep", chains=SWEEP_B,
                  sweeps=CALL_SWEEPS, aux=aux)


def path_lines(torch, rt, root, card, reps):
    from rrrmc_tpu_torch import bench

    m = rt.GraphRRG(SITE_N, 3, (-1, 1), seed=SEED, device="cuda")

    def host_s(call):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for label, call, work, unit in (
            ("standardMC GraphRRG(10^4, 3), kernel route",
             lambda: rt.standardMC(m, BETA, MET_ITERS, step=MET_STEP,
                                   chains=SITE_B, seed=1, backend="kernel",
                                   device="cuda"),
             MET_ITERS * SITE_B, "moves*chains/s"),
            ("sweepMC GraphRRG(10^4, 3), site-sweep route",
             lambda: rt.sweepMC(m, BETA, RRG_SWEEPS, step=RRG_STEP,
                                chains=SITE_B, seed=15, device="cuda"),
             RRG_SWEEPS * SITE_N * SITE_B, "attempted flips*chains/s")):
        host_s(call)                                      # warm-up
        secs = [host_s(call) for _ in range(reps)]
        rates = [work / t for t in secs]
        print(json.dumps({
            "root": root, "path": label, "route": rt.LAST_ROUTE["backend"],
            "seconds": secs, "rates": rates,
            "median_rate": statistics.median(rates), "rate_unit": unit,
            "card": card}), flush=True)
    values = []
    for _ in range(reps):
        record, extra, _, _ = bench.measure()
        values.append(record["value"])
    print(json.dumps({
        "root": root, "path": "bench.measure (EA-3D L=16, 8192 chains)",
        "metric": "ea3d_attempted_flips_per_s", "values": values,
        "median": statistics.median(values), "card": card}), flush=True)


def site_variant(cuda_build, name, subs):
    """The library of a variant of csrc/site.cu (text substitutions `subs`),
    built alone from a copy of csrc/ and loaded with the package's C
    signatures: it holds the site kernel's functions only."""
    d = os.path.join(cuda_build.BUILD_DIR, "ablation", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC, d)
    path = os.path.join(d, "site.cu")
    text = open(path).read()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{name}: no {old!r} in site.cu")
        text = text.replace(old, new)
    open(path, "w").write(text)
    so = os.path.join(d, "lib.so")
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared",
                    "-o", so, path], check=True, capture_output=True,
                   timeout=900)
    lib = ctypes.CDLL(so)
    for fn, (res, argt) in cuda_build._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).restype = res
            getattr(lib, fn).argtypes = argt
    return lib


def sweep_pinned(torch, sw, chains, threads, four):
    """(run, facts): run(a) launches the sweep kernel through its C entry
    on a = [sigma, E] with `chains` chains and `threads` threads a block,
    four chains a lane or one (the Sweeper's wrapper takes its plan's);
    facts as the plan's keys."""
    from rrrmc_tpu_torch.ops import cuda_build, launch, sweep

    lib = cuda_build.library()
    rows = sweep.site_rows(sw.Jp, sw.Jm, sw.L, sw.D, four).data
    n_th = sw.th.shape[0]
    smem = n_th * 4 + sw.L ** sw.D * sweep.site_bytes(chains)
    out = launch.facts("rrrmc_sweep_info", (sw.D, int(n_th > 0), int(four)),
                       threads, smem, 0)
    facts = {"chains": chains, "threads": threads, "smem": smem,
             "lanes": "4 chains" if four else "1 chain",
             "blocks_per_sm": out[0], "registers": out[1],
             "spill_bytes": out[2]}

    def run(a):
        sigma, E = a
        err = lib.rrrmc_sweep(
            sigma.data_ptr(), E.data_ptr(), rows.data_ptr(),
            sw.th.data_ptr(), None, sw.L, sw.D, sigma.shape[0], n_th,
            int(four), chains.bit_length() - 1, threads, SWEEPS, SEED, 0, 0,
            sw.beta2s, torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "sweep launch")

    return run, facts


def ablation(torch, rt, root, card, reps):
    from rrrmc_tpu_torch.ops import cuda_build, launch, site

    package = cuda_build.library()
    one_by_one = site_variant(cuda_build, "site_cap1", [
        ("constexpr int kGroupMax = 32;", "constexpr int kGroupMax = 1;")])
    m = rt.GraphRRG(SITE_N, 3, (-1, 1), seed=SEED, device="cuda")
    for cap, lib in ((1, one_by_one), (site.GROUP_MAX, package)):
        cuda_build._lib = lib
        launch.facts.cache_clear()      # the facts hold for one library
        try:
            fresh, run = site_launcher(torch, rt, m, SITE_MOVES)
            case_line(torch, root, card, f"site groups capped at {cap}", 1,
                      fresh, run, reps, "site", ablation="site", cap=cap)
            t0 = time.perf_counter()
            rt.standardMC(m, BETA, MET_ITERS, step=MET_STEP, chains=SITE_B,
                          seed=1, backend="kernel", device="cuda")
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            print(json.dumps({
                "root": root, "ablation": "site", "cap": cap,
                "path": "standardMC GraphRRG(10^4, 3)", "seconds": s,
                "rate": MET_ITERS * SITE_B / s,
                "rate_unit": "moves*chains/s", "card": card}), flush=True)
        finally:
            cuda_build._lib = package
            launch.facts.cache_clear()
    lat = rt.GraphEA(SWEEP_L, 3, (-1, 1), seed=42, device="cuda")
    fresh, run, sw = sweep_launcher(torch, rt, lat)
    run(fresh())                                # the plan's C and threads
    C, T = launch.PLANS["sweep"]["chains"], launch.PLANS["sweep"]["threads"]
    for label, chains, threads, four in (
            ("rows alone: 1 chain a block, 1 a lane", 1, T, False),
            ("chains in step: the plan's C, 1 chain a lane", C, T, False),
            ("the design: the plan's C, 4 chains a lane", C, T, True),
            ("4 chains a lane, C=16", 16, T, True),
            ("4 chains a lane, C=16, 512 threads", 16, 512, True),
            ("4 chains a lane, C=8", 8, T, True),
            ("4 chains a lane, C=32, 512 threads", 32, 512, True)):
        pinned, facts = sweep_pinned(torch, sw, chains, threads, four)
        case_line(torch, root, card, label, 3, fresh, pinned, reps, "sweep",
                  plan=facts, ablation="sweep")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--ablation", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_site_timing: no CUDA device is visible", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.bench import card_line
    from rrrmc_tpu_torch.ops import cuda_build

    assert os.path.dirname(os.path.dirname(rt.__file__)) == root, rt.__file__
    cuda_build.library()
    card = card_line()
    if args.paths:
        path_lines(torch, rt, root, card, args.reps)
    elif args.ablation:
        ablation(torch, rt, root, card, args.reps)
    else:
        kernel_cases(torch, rt, root, card, args.reps)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
