#!/usr/bin/env python3
"""Time the tau-EO kernels of the PyTorch + CUDA port on their kernel-table
cases (PERF.md section 6: rows 8 to 11, 18 and 20), for the
rrrmc_tpu_torch package under --root, so that two trees are timed in one
call on one card:

    python3 scripts/torch_eo_timing.py --root DIR [--reps 6] [--paths]
        [--ablation]

Each case runs 300 moves (EO_CMP_MOVES of chip_smoke.py) of the family's
EO wrapper (samplers/families.py: its tables and keyword arguments) from
init_state(seed=167), timed with CUDA events around a launch enqueued
behind an untimed one (the card's time, as chip_smoke.py's single launches
give it, without the wrapper's host work): one untimed round, then --reps
timed launches, all printed with their median; then the same from the
state after WARM moves of the kernel (the paths run near the EO optimum,
where the selected classes differ from a random start's). The cases: EA-3D
L=8 +-J (row 8's lattice branch, 1024 chains), GraphRRG(10^4, 3) +-J with
1024 and 128 chains and GraphRRGNormal(10^4, 3) with 1024 (row 10),
GraphPSpin3(7500, 3) with 128 (row 11), GraphPercStep / Linear /
XEntr(1023, 511) with 256 (row 20), and the rows that share csrc/eo.cuh:
GraphSK(1024) with 1024 (row 8's dense branch), densify(GraphRRG(10^4, 3))
with 1024 and GraphSKNormal(4096) with 512 (row 9), GraphSAT(10^4, 3, 4.2)
with 128 (row 18).

--paths times the EO main paths' extremal_opt calls as chip_smoke.py runs
them (one untimed call, then --reps calls, host clock around each call and
a synchronize): EA-3D L=8 (1024 chains, 400 000 moves), GraphRRG(10^4)
(128 chains, 200 000; 1024 chains, 20 000), GraphRRGNormal(10^4) (1024,
20 000), GraphPSpin3(7500, 3) (128, 100 000), GraphPercStep and
GraphPercXEntr(1023, 511) (256, 20 000).

--ablation (this tree) takes the sparse kernel's design apart on the row
cases, each part against the design in the same call: the ranks drawn move
by move (a variant of csrc/eo_sparse.cu), the flip's row updated one site
after another by one lane (a variant), the tie race 32 groups a round in
the place of a 16-byte vector a lane (int8 keys), int16 keys in the place
of int8 (the wrapper's launch with the int16 key code), every float bin
crowded (a variant that always takes the radix select over the selected
bin), and the plan's warps a chain against the others (the kernel's C
entry, rrrmc_eo_sparse, called with each W and the plan's key type and
bins).
Variants are built alone from a copy of csrc/ under
rrrmc_tpu_torch/_build/ablation/ and loaded in the place of the package's
library for the sparse kernel's calls.

Prints one JSON line per case and the card's name and power limit; exits 1
without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

SEED = 167
TAU = 1.4
MOVES = 300
#: warm moves before the second timing of each case
WARM = 20_000
#: --paths: (label, model key, chains, moves), chip_smoke.py's EO runs
PATHS = (("extremal_opt GraphEA(8, 3)", "ea8", 1024, 400_000),
         ("extremal_opt GraphRRG(10^4) 128 chains", "rrg", 128, 200_000),
         ("extremal_opt GraphRRG(10^4) 1024 chains", "rrg", 1024, 20_000),
         ("extremal_opt GraphRRGNormal(10^4)", "rrgn", 1024, 20_000),
         ("extremal_opt GraphPSpin3(7500, 3)", "ps", 128, 100_000),
         ("extremal_opt GraphPercStep(1023, 511)", "step", 256, 20_000),
         ("extremal_opt GraphPercXEntr(1023, 511)", "xentr", 256, 20_000))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].strip()


def events_ms(torch, fn) -> float:
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def models(rt, only=None) -> dict:
    """The cases' models by key, built on the card."""
    D = "cuda"
    make = {
        "ea8": lambda: rt.GraphEA(8, 3, (-1, 1), seed=42, device=D),
        "rrg": lambda: rt.GraphRRG(10_000, 3, (-1, 1), seed=7, device=D),
        "rrgn": lambda: rt.GraphRRGNormal(10_000, 3, seed=7, device=D),
        "ps": lambda: rt.GraphPSpin3(7500, 3, seed=7, device=D),
        "step": lambda: rt.GraphPercStep(1023, 511, seed=5, device=D),
        "linear": lambda: rt.GraphPercLinear(1023, 511, seed=5, device=D),
        "xentr": lambda: rt.GraphPercXEntr(1023, 511, 1.0, seed=5,
                                           device=D),
        "sk": lambda: rt.GraphSK(1024, seed=4, device=D),
        "drrg": lambda: rt.densify(rt.GraphRRG(10_000, 3, (-1, 1), seed=7,
                                               device=D)),
        "skn": lambda: rt.GraphSKNormal(4096, seed=4, device=D),
        "sat": lambda: rt.GraphSAT(10_000, 3, 4.2, seed=167, device=D),
    }
    return {k: f() for k, f in make.items() if only is None or k in only}


#: (row, label, model key, chains)
CASES = ((8, "GraphEA(8, 3) lattice", "ea8", 1024),
         (10, "GraphRRG(10^4) +-J", "rrg", 1024),
         (10, "GraphRRG(10^4) +-J 128 chains", "rrg", 128),
         (10, "GraphRRGNormal(10^4)", "rrgn", 1024),
         (11, "GraphPSpin3(7500, 3)", "ps", 128),
         (20, "GraphPercStep(1023, 511)", "step", 256),
         (20, "GraphPercLinear(1023, 511)", "linear", 256),
         (20, "GraphPercXEntr(1023, 511)", "xentr", 256),
         (8, "GraphSK(1024) dense", "sk", 1024),
         (9, "densify(GraphRRG(10^4))", "drrg", 1024),
         (9, "GraphSKNormal(4096)", "skn", 512),
         (18, "GraphSAT(10^4, 3, 4.2)", "sat", 128))


def eo_state(torch, rt, model, B):
    """(wrapper, tables, kw, start, cdf): the family's EO wrapper and its
    arguments, and the chains' start [sigma, state, E, Emin, sigma_min,
    itmin]."""
    from rrrmc_tpu_torch.samplers.eo import rank_table
    from rrrmc_tpu_torch.samplers.families import family_of, resident_state

    fam = family_of(model)
    st = rt.init_state(model, B, seed=SEED, device="cuda")
    lf, E = resident_state(fam, model, st.sigma, st.E)
    start = [st.sigma.clone(), lf, E, E.clone(), st.sigma.clone(),
             torch.zeros(B, dtype=torch.int32, device="cuda")]
    return (fam.eo, fam.tables(model), fam.eo_kw(model), start,
            rank_table(model.N, TAU, "cuda"))


def plan_of(fam_eo):
    """The tree's last plan of the wrapper's module, if it records one."""
    mod = sys.modules[fam_eo.__module__]
    plan = getattr(mod, "LAST_PLAN", None)
    if plan is None and fam_eo.__name__ == "eo_pspin_chunk":
        plan = getattr(sys.modules["rrrmc_tpu_torch.ops.eo"], "LAST_PLAN",
                       None)
    return dict(plan) if plan else None


def time_case(torch, root, card, row, label, chunk, tables, kw, start, cdf,
              reps, move0=0, **extra):
    def launch(a):
        chunk(*a, *tables, cdf, n_moves=MOVES, seed=SEED, move0=move0, **kw)

    def once():
        # the timed launch is enqueued behind an untimed one, so the events
        # time the card, not the wrapper's host work in front of the launch
        a, b = [t.clone() for t in start], [t.clone() for t in start]
        torch.cuda.synchronize()
        launch(b)
        return events_ms(torch, lambda: launch(a))

    once()                                                # warm-up
    ms = [once() for _ in range(reps)]
    print(json.dumps({
        "root": root, "row": row, "case": label, "moves": MOVES,
        "move0": move0, "ms": ms, "median_ms": statistics.median(ms),
        "min_ms": min(ms),
        "plan": None if "warps" in extra else plan_of(chunk), "card": card,
        **extra}),
        flush=True)


def kernel_cases(torch, rt, root, card, reps):
    ms = models(rt)
    for row, label, key, B in CASES:
        chunk, tables, kw, start, cdf = eo_state(torch, rt, ms[key], B)
        time_case(torch, root, card, row, label, chunk, tables, kw, start,
                  cdf, reps, chains=B, begin="random")
        warm = [t.clone() for t in start]
        chunk(*warm, *tables, cdf, n_moves=WARM, seed=SEED, **kw)
        time_case(torch, root, card, row, label, chunk, tables, kw, warm,
                  cdf, reps, move0=WARM, chains=B, begin=f"after {WARM}")


def path_lines(torch, rt, root, card, reps):
    ms = models(rt, {k for _, k, _, _ in PATHS})

    def host_s(call):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for label, key, B, moves in PATHS:
        def call():
            return rt.extremal_opt(ms[key], TAU, moves, chains=B, seed=44,
                                   device="cuda")

        host_s(call)                                      # warm-up
        secs = [host_s(call) for _ in range(reps)]
        rates = [moves * B / t for t in secs]
        print(json.dumps({
            "root": root, "path": label, "route": rt.LAST_ROUTE["backend"],
            "seconds": secs, "rates": rates,
            "median_rate": statistics.median(rates),
            "rate_unit": "moves*chains/s", "card": card}), flush=True)


def variant(cuda_build, name, subs):
    """The library of a variant of csrc/eo_sparse.cu (text substitutions
    `subs`), built alone from a copy of csrc/ and loaded with the package's
    C signatures: it holds the sparse EO kernel's functions only."""
    d = os.path.join(cuda_build.BUILD_DIR, "ablation", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC, d)
    path = os.path.join(d, "eo_sparse.cu")
    text = open(path).read()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{name}: no {old!r} in eo_sparse.cu")
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


#: the variants of --ablation: name -> substitutions in eo_sparse.cu
VARIANTS = {
    "ranks move by move": [(
        "    if ((m & 31) == 0) rl = rrrmc::rank_of(a.cdf, N, a.seed, chain, "
        "mv + lane);\n    const int r = __shfl_sync(kAll, rl, m & 31);",
        "    const int r = rrrmc::rank_of(a.cdf, N, a.seed, chain, mv);\n"
        "    (void)rl;")],
    "flip by one lane": [
        ("      if (K < 32 && !__any_sync(kAll, twice)) {",
         "      if (false) {"),
        ("        if (K <= 32) {", "        if (false) {")],
    "tie race 32 groups a round": [(
        "      rrrmc::warp_tie_packed(keys, NV, cw * 32, kT, v, hist[bin] == 1, "
        "q,\n                             a.seed, chain, mv, best, win);",
        "      rrrmc::warp_tie(NG, cw * 32, kT, [&](int g) { return "
        "rrrmc::word_mask(reinterpret_cast<const uint32_t*>(keys)[g], v); },"
        " q, a.seed, chain, mv, best, win);")],
    "every float bin crowded": [("      if (c <= 32) {", "      if (false) {")],
}

#: the variants that hold only for int8 keys (the others' instantiations
#: build, but are not timed)
INT8_ONLY = {"tie race 32 groups a round"}


def int16_keys(torch, lib, chunk):
    """The sparse wrapper with int16 keys in the place of int8 (the kernel's
    C entry with key code 1, the same 2 half_max + 1 bins)."""
    from rrrmc_tpu_torch.ops import eo

    def run(sigma, lf, E, emin, smin, itmin, neigh, J, cdf, *, n_moves,
            seed, half_max, move0=0):
        eo.sparse_launch("eo_sparse", sigma, lf, E, emin, smin, itmin, neigh,
                         J, cdf, n_moves=n_moves, seed=seed, move0=move0,
                         chain0=0, key=torch.int16,
                         nb=eo.hist_bins(True, half_max), pspin=False)

    run.__module__ = chunk.__module__
    return run


def warps_chunk(torch, chunk, plan, w):
    """The sparse or PSpin3 EO wrapper's launch on w warps a chain: the
    kernel's C entry with the key type and bins of `plan` (the wrapper's
    eo.LAST_PLAN) and w in the place of the plan's warps; a ValueError
    where the block does not fit on an SM."""
    from rrrmc_tpu_torch.ops import cuda_build, eo

    key = getattr(torch, plan["key"])
    code, nb = eo.KEY_CODES[key], plan["bins"]

    def run(sigma, lf, E, emin, smin, itmin, *tables_cdf, n_moves, seed,
            move0=0, half_max=None):
        *tables, cdf = tables_cdf
        pspin = len(tables) == 1
        neigh, J = (tables[0], None) if pspin else tables
        B, N = sigma.shape
        K = 2 * neigh.shape[1] if pspin else neigh.shape[1]
        lib = cuda_build.library()
        smem = lib.rrrmc_eo_sparse_smem(N, code, nb, w)
        facts = eo.launch_facts("rrrmc_eo_sparse_info", (code, int(pspin)),
                                sigma.device.index or 0, w, smem)
        if smem > facts[4] or facts[0] == 0:
            raise ValueError(f"{w} warps a chain do not fit ({facts})")
        lo, scale = (eo.coarse_map(key, nb, half_max, J, lf)
                     if plan["select"] == "coarse" else (0.0, 0.0))
        err = lib.rrrmc_eo_sparse(
            *eo.launch_args(sigma, lf, E, emin, smin, itmin),
            neigh.data_ptr(), J.data_ptr() if J is not None else None,
            cdf.data_ptr(), N, K, B, n_moves, seed & 0xFFFFFFFF,
            move0 & 0xFFFFFFFF, 0, code, int(pspin), nb, lo, scale, w,
            torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, f"eo_sparse on {w} warps a chain")

    run.__module__ = chunk.__module__
    return run


def ablation(torch, rt, root, card, reps):
    from rrrmc_tpu_torch.ops import cuda_build, eo

    package = cuda_build.library()
    ms = models(rt, {"ea8", "rrg", "rrgn", "ps"})
    cases = [c for c in CASES if c[2] in ms]
    libs = {"design": package}
    libs.update({name: variant(cuda_build, name.replace(" ", "_"), subs)
                 for name, subs in VARIANTS.items()})
    for row, label, key, B in cases:
        chunk, tables, kw, start, cdf = eo_state(torch, rt, ms[key], B)
        plan = None
        for name, lib in libs.items():
            if (name == "every float bin crowded" and key != "rrgn") or (
                    name in INT8_ONLY and key == "rrgn"):
                continue
            cuda_build._lib = lib
            try:
                time_case(torch, root, card, row, label, chunk, tables, kw,
                          start, cdf, reps, ablation=name, chains=B)
            finally:
                cuda_build._lib = package
            if name == "design":
                plan = plan_of(chunk)
        if key in ("ea8", "rrg"):
            time_case(torch, root, card, row, label,
                      int16_keys(torch, package, chunk), tables, kw, start,
                      cdf, reps, ablation="int16 keys", chains=B)
        for w in eo.EO_WARPS:
            try:
                time_case(torch, root, card, row, label,
                          warps_chunk(torch, chunk, plan, w), tables, kw,
                          start, cdf, reps, ablation=f"{w} warps a chain",
                          chains=B, warps=w)
            except ValueError as e:
                print(json.dumps({"root": root, "row": row, "case": label,
                                  "ablation": f"{w} warps a chain",
                                  "refused": str(e), "card": card}),
                      flush=True)


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
        print("torch_eo_timing: no CUDA device is visible", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import rrrmc_tpu_torch as rt
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
