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
XEntr(1023, 511) with 256 (row 20), GraphSK(1024) with 1024 (row 8's dense
branch), densify(GraphRRG(10^4, 3)) with 1024 and GraphSKNormal(4096) with
512 (row 9), GraphSAT(10^4, 3, 4.2) with 128 (row 18).

--paths times the EO main paths' extremal_opt calls as chip_smoke.py runs
them (one untimed call, then --reps calls, host clock around each call and
a synchronize): EA-3D L=8 (1024 chains, 400 000 moves), GraphRRG(10^4)
(128 chains, 200 000; 1024 chains, 20 000), GraphRRGNormal(10^4) (1024,
20 000), GraphPSpin3(7500, 3) (128, 100 000), GraphPercStep and
GraphPercXEntr(1023, 511) (256, 20 000), GraphSK(1024) (1024, 100 000),
densify(GraphRRG(10^4)) (1024, 20 000), GraphSKNormal(4096) (512, 20 000)
and GraphSAT(10^4, 3, 4.2) (128, 30 000).

--ablation (this tree) takes the EO kernels' designs apart on the row
cases, each part against the design in the same call, through the
kernels' C entries (rrrmc_eo_sparse, rrrmc_eo_dense, rrrmc_eo_sat) with
the plan's key type and bins: the sparse kernel's ranks drawn move by move,
its flip by one lane, the tie race 32 groups a round in the place of a
16-byte vector a lane (int8 keys), int16 keys in the place of int8, the
coarse select's list pass unrolled by the compiler, super-bins moved with
every bin move, every float bin crowded; the dense kernel's bin moves
merged in a warp (__match_any_sync), int16 keys site by site and int8
keys packed, the row vectors in flight (4 for 1 and 1 for 4), no
zero-vector skip, int16 keys in coarse bins of width 4 and 16 on
GraphSK(1024) (both from a random start and after WARM moves); the K-SAT
kernel's uint16 keys for uint8 and its flip's loads one after another; a
launch of no move (the load and the store) on the dense
and K-SAT cases; and the plan's warps a chain against the others.
Variants are built alone from a copy of csrc/ under
rrrmc_tpu_torch/_build/ablation/ (VARIANTS: text substitutions in the
sources).

Prints one JSON line per case and the card's name and power limit; exits 1
without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
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
         ("extremal_opt GraphPercXEntr(1023, 511)", "xentr", 256, 20_000),
         ("extremal_opt GraphSK(1024)", "sk", 1024, 100_000),
         ("extremal_opt densify(GraphRRG(10^4))", "drrg", 1024, 20_000),
         ("extremal_opt GraphSKNormal(4096)", "skn", 512, 20_000),
         ("extremal_opt GraphSAT(10^4, 3, 4.2)", "sat", 128, 30_000))


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
    """The tree's last plan of the wrapper's kernel (ops/launch.py's PLANS,
    by the name of the wrapper `<kernel>_chunk`), if it records one."""
    from rrrmc_tpu_torch.ops.launch import PLANS

    plan = PLANS.get(fam_eo.__name__.removesuffix("_chunk"))
    return dict(plan) if plan else None


@contextlib.contextmanager
def library(cuda_build, lib):
    """Within the block the wrappers and the launch seam's facts use `lib`,
    a variant build of the package's library."""
    from rrrmc_tpu_torch.ops import launch

    package = cuda_build.library()
    cuda_build._lib = lib
    launch.facts.cache_clear()      # the facts hold for one library
    try:
        yield
    finally:
        cuda_build._lib = package
        launch.facts.cache_clear()


def time_case(torch, root, card, row, label, chunk, tables, kw, start, cdf,
              reps, move0=0, moves=MOVES, **extra):
    def launch(a):
        chunk(*a, *tables, cdf, n_moves=moves, seed=SEED, move0=move0, **kw)

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
        "root": root, "row": row, "case": label, "moves": moves,
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


def variant(cuda_build, name, source, subs):
    """The library of a variant of one EO kernel source (`source`, built
    alone from a copy of csrc/ whose files take the text substitutions
    `subs`, (file, old, new)), loaded with the package's C signatures: it
    holds that kernel's functions only."""
    d = os.path.join(cuda_build.BUILD_DIR, "ablation", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC, d)
    for fname, old, new in subs:
        path = os.path.join(d, fname)
        text = open(path).read()
        if old not in text:
            raise RuntimeError(f"{name}: no {old!r} in {fname}")
        open(path, "w").write(text.replace(old, new))
    so = os.path.join(d, "lib.so")
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared",
                    "-o", so, os.path.join(d, source)], check=True,
                   capture_output=True, timeout=900)
    lib = ctypes.CDLL(so)
    for fn, (res, argt) in cuda_build._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).restype = res
            getattr(lib, fn).argtypes = argt
    return lib


#: the dense flip's bin moves with the lanes of a warp that move between one
#: pair of exact bins merged into one atomic each (__match_any_sync)
MERGED_MOVE = """\
    if constexpr (C::kSel == kEoHist) {
      const bool moved = ok && b0 != b1;
      const unsigned peers =
          __match_any_sync(kAll, moved ? (b0 << 16) | b1 : -1);
      if (moved && __ffs(peers) - 1 == c.lane) {
        const int n = __popc(peers);
        atomicAdd(c.hist + b0, -n);
        atomicAdd(c.hist + b1, n);
        if (c.nb > 32 && (b0 >> 5) != (b1 >> 5)) {
          atomicAdd(c.sup + (b0 >> 5), -n);
          atomicAdd(c.sup + (b1 >> 5), n);
        }
      }
    } else if (ok) {
      c.move_bins(b0, b1);
    }
"""

#: the variants of --ablation: name -> (kernel source, substitutions
#: (file, old, new), the cases' model keys it is timed on)
VARIANTS = {
    "ranks move by move": ("eo_sparse.cu", [(
        "eo_chain.cuh",
        "    if ((m & 31) == 0) rl = rank_of(a.cdf, N, a.seed, chain, "
        "mv + lane);\n    const int r = __shfl_sync(kAll, rl, m & 31);",
        "    const int r = rank_of(a.cdf, N, a.seed, chain, mv);\n"
        "    (void)rl;")], {"ea8", "rrg", "rrgn", "ps"}),
    "flip by one lane": ("eo_sparse.cu", [
        ("eo_sparse.cu", "    if (K < 32 && !__any_sync(kAll, twice)) {",
         "    if (false) {"),
        ("eo_sparse.cu", "      if (K <= 32) {", "      if (false) {")],
        {"ea8", "rrg", "rrgn", "ps"}),
    # int8 keys only (the other instantiations build, but are not timed)
    "tie race 32 groups a round": ("eo_sparse.cu", [(
        "eo_chain.cuh",
        "      warp_tie_packed(keys, NV, cw * 32, kT, v - key_of(KT(0)),\n"
        "                      hist[bin] == 1, q, a.seed, chain, mv, best, "
        "win);",
        "      warp_tie(NG, cw * 32, kT, [&](int g) { return "
        "word_mask(reinterpret_cast<const uint32_t*>(keys)[g], v); },"
        " q, a.seed, chain, mv, best, win);")], {"ea8", "rrg", "ps"}),
    "super-bins moved with every bin move": ("eo_sparse.cu", [(
        "eo_chain.cuh", "if (nb > 32 && (b0 >> 5) != (b1 >> 5)) {",
        "if (nb > 32) {")], {"rrgn"}),
    "super-bins moved with every bin move (dense)": ("eo_dense.cu", [(
        "eo_chain.cuh", "if (nb > 32 && (b0 >> 5) != (b1 >> 5)) {",
        "if (nb > 32) {")], {"sk"}),
    "list pass unrolled by the compiler": ("eo_sparse.cu", [(
        "eo_chain.cuh", "#pragma unroll 1\n      for (int i0 = cw * 32; i0 < N;",
        "      for (int i0 = cw * 32; i0 < N;")], {"rrgn"}),
    "every float bin crowded": ("eo_sparse.cu", [(
        "eo_chain.cuh", "      if (cl <= 32) {", "      if (false) {")],
        {"rrgn"}),
    # the dense flip's design points
    "bin moves merged in a warp": ("eo_dense.cu", [(
        "eo_dense.cu", "    if (ok) c.move_bins(b0, b1);\n", MERGED_MOVE)],
        {"sk", "drrg"}),
    "int16 keys site by site": ("eo_dense.cu", [(
        "eo_dense.cu", "return key_bytes == 2;", "return false;")], {"sk"}),
    "int8 keys packed": ("eo_dense.cu", [(
        "eo_dense.cu", "return key_bytes == 2;", "return key_bytes <= 2;")],
        {"drrg"}),
    "four row vectors in flight packed": ("eo_dense.cu", [(
        "eo_dense.cu", "kRowLoadsPacked = 1, kRowLoadsSites = 4;",
        "kRowLoadsPacked = 4, kRowLoadsSites = 4;")], {"sk"}),
    "one row vector in flight site by site": ("eo_dense.cu", [(
        "eo_dense.cu", "kRowLoadsPacked = 1, kRowLoadsSites = 4;",
        "kRowLoadsPacked = 1, kRowLoadsSites = 1;")], {"drrg", "skn"}),
    "no zero-vector skip": ("eo_dense.cu", [(
        "eo_dense.cu", "(q.x | q.y | q.z | q.w) != 0u", "true")], {"drrg"}),
    # the K-SAT kernel's loads issued ahead (sat.cuh)
    "flip loads one after another": ("eo_sat.cu", [(
        "eo_sat.cu", "sat_flip_at<32, true>", "sat_flip_at<32, false>")],
        {"sat"}),
    # int16 keys in coarse bins (key code 1 takes the coarse select)
    "int16 keys in coarse bins": ("eo_dense.cu", [
        ("eo_dense.cu",
         "    case 1: return by_warps<int16_t, kEoHist, int8_t>(W);",
         "    case 1: return by_warps<int16_t, kEoCoarse, int8_t>(W);"),
        ("eo_dense.cu", "kKeyBytes[key], nb, W, key >= 2, 0)",
         "kKeyBytes[key], nb, W, key >= 1, 0)")], set()),
}

#: the widths 2^k of the int16 coarse bins timed on GraphSK(1024)
COARSE_WIDTHS = (4, 16)


def c_entry_chunk(torch, chunk, plan, w, code=None, nb=None, coarse=None):
    """The EO wrapper's launch through its kernel's C entry (the sparse or
    PSpin3, dense or K-SAT one) on w warps a chain, with the key code and
    bins of `plan` (the wrapper's last plan) unless `code` / `nb` are
    given, from the library in use (a variant's within `library`);
    `coarse` (lo, scale) gives the bin map of a coarse select. A ValueError
    where the block does not fit on an SM."""
    from rrrmc_tpu_torch.ops import cuda_build, eo, launch

    kind = chunk.__module__.rsplit(".", 1)[1]
    key = getattr(torch, plan["key"])
    if code is None:
        code = (eo.KEY_CODES if kind != "eo_sat"
                else sys.modules[chunk.__module__].SAT_KEY_CODES)[key]
    nb = plan["bins"] if nb is None else nb

    def run(sigma, lf, E, emin, smin, itmin, *tables_cdf, n_moves, seed,
            move0=0, half_max=None):
        *tables, cdf = tables_cdf
        B, N = sigma.shape
        L = cuda_build.library()
        dev = sigma.device.index or 0
        st = torch.cuda.current_stream().cuda_stream
        state = eo.launch_args(sigma, lf, E, emin, smin, itmin)
        if coarse is not None:
            lo, scale = coarse
        elif plan["select"] == "coarse":
            lo, scale = eo.coarse_map(
                key, nb, half_max,
                tables[-1] if kind in ("eo", "eo_pspin") else None, lf)
        else:
            lo, scale = 0.0, 0.0
        if kind in ("eo", "eo_pspin"):
            pspin = len(tables) == 1
            neigh, J = (tables[0], None) if pspin else tables
            K = 2 * neigh.shape[1] if pspin else neigh.shape[1]
            smem = L.rrrmc_eo_sparse_smem(N, code, nb, w)
            facts = launch.facts("rrrmc_eo_sparse_info", (code, int(pspin)),
                                 w, smem, dev)
            call = lambda: L.rrrmc_eo_sparse(
                *state, neigh.data_ptr(),
                J.data_ptr() if J is not None else None, cdf.data_ptr(), N,
                K, B, n_moves, seed & 0xFFFFFFFF, move0 & 0xFFFFFFFF, 0,
                code, int(pspin), nb, lo, scale, w, st)
        elif kind == "eo_dense":
            (J,) = tables
            smem = L.rrrmc_eo_dense_smem(N, code, nb, w)
            facts = launch.facts("rrrmc_eo_dense_info", (code,), w, smem, dev)
            call = lambda: L.rrrmc_eo_dense(
                *state, J.data_ptr(), cdf.data_ptr(), N, B, n_moves,
                seed & 0xFFFFFFFF, move0 & 0xFFFFFFFF, 0, code, nb, lo,
                scale, w, st)
        else:
            A, Lt, T, TL = tables
            Mc, K = A.shape
            smem = L.rrrmc_eo_sat_smem(N, Mc, code, nb, w)
            facts = launch.facts("rrrmc_eo_sat_info", (code,), w, smem, dev)
            call = lambda: L.rrrmc_eo_sat(
                sigma.data_ptr(), lf.data_ptr(), E.data_ptr(),
                emin.data_ptr(), smin.data_ptr(), itmin.data_ptr(),
                A.data_ptr(), Lt.data_ptr(), T.data_ptr(), TL.data_ptr(),
                cdf.data_ptr(), N, Mc, K, T.shape[1], B, n_moves,
                seed & 0xFFFFFFFF, move0 & 0xFFFFFFFF, 0, code, nb, w, st)
        if smem > facts[4] or facts[0] == 0:
            raise ValueError(f"{w} warps a chain do not fit ({facts})")
        cuda_build.check(call(), f"{kind} on {w} warps a chain")

    run.__name__ = chunk.__name__
    return run


#: the cases of --ablation by model key (CASES' labels), and the cases
#: timed again after WARM moves too
ABLATION_KEYS = ("ea8", "rrg", "rrgn", "ps", "sk", "drrg", "skn", "sat")
WARM_ABLATION = {"sk"}


def ablation(torch, rt, root, card, reps):
    from rrrmc_tpu_torch.ops import cuda_build, eo
    from rrrmc_tpu_torch.samplers.families import half_bound

    cuda_build.library()
    ms = models(rt, set(ABLATION_KEYS))
    cases = [c for c in CASES if c[2] in ms]
    libs = {name: variant(cuda_build, name.replace(" ", "_"), source, subs)
            for name, (source, subs, _) in VARIANTS.items()}
    for row, label, key, B in cases:
        chunk, tables, kw, start, cdf = eo_state(torch, rt, ms[key], B)
        starts = [(0, start, "random")]
        if key in WARM_ABLATION:
            warm = [t.clone() for t in start]
            chunk(*warm, *tables, cdf, n_moves=WARM, seed=SEED, **kw)
            starts.append((WARM, warm, f"after {WARM}"))
        for move0, st, begin in starts:
            def timed(fn, name, **extra):
                try:
                    time_case(torch, root, card, row, label, fn, tables, kw,
                              st, cdf, reps, move0=move0, ablation=name,
                              chains=B, begin=begin, **extra)
                except ValueError as e:
                    print(json.dumps({"root": root, "row": row,
                                      "case": label, "ablation": name,
                                      "refused": str(e), "card": card}),
                          flush=True)

            timed(chunk, "design")
            plan = plan_of(chunk)
            if key in ("sk", "drrg", "skn", "sat") and not move0:
                timed(chunk, "no move (the load and the store)", moves=0)
            for name, (_, _, keys) in VARIANTS.items():
                if key in keys:
                    with library(cuda_build, libs[name]):
                        timed(c_entry_chunk(torch, chunk, plan,
                                            plan["warps"]), name)
            if key in ("ea8", "rrg"):
                timed(c_entry_chunk(torch, chunk, plan, plan["warps"],
                                    code=1), "int16 keys")
            if key == "sat":
                timed(c_entry_chunk(torch, chunk, plan, plan["warps"],
                                    code=1), "uint16 keys")
            if key == "sk":
                half = half_bound(ms[key])
                for width in COARSE_WIDTHS:
                    nb = (2 * half) // width + 1
                    with library(cuda_build,
                                 libs["int16 keys in coarse bins"]):
                        timed(c_entry_chunk(
                            torch, chunk, plan, plan["warps"], code=1,
                            nb=nb, coarse=(-float(half), 1.0 / width)),
                            f"int16 keys in coarse bins of {width}")
            if move0:
                continue
            for w in eo.EO_WARPS:
                timed(c_entry_chunk(torch, chunk, plan, w),
                      f"{w} warps a chain", warps=w)


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
