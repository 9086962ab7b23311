#!/usr/bin/env python3
"""Where a dense sweep kernel's time goes: time variants of
rrrmc_tpu_torch/csrc/sk_sweep.cu (--kernel sk) or replica_sweep.cu
(--kernel replica), each with one part taken out, on one NVIDIA GPU:

    python3 scripts/torch_sweep_ablation.py --kernel sk [--root DIR]
        [--reps 3]

--root names the tree whose rrrmc_tpu_torch package (and csrc/) is timed,
so that the kernel of another commit (a `git archive` in a directory that
.gitignore lists) can be taken apart in the same call. The variants follow
the kernel's generation: the warp-per-chain kernels (one Philox call a lane
and round, the commit read row by row) or the block-synchronous ones (bits
drawn once a site, the commit an int8 tensor-core product), told apart by
`mma.sync` in the source.

Each variant is built from a copy of csrc/ under the tree's
rrrmc_tpu_torch/_build/ (one nvcc a variant, all started together) and
loaded in the place of the package's library, then times the kernel-table
cases (PERF.md section 6): --kernel sk row 12 (GraphSK(1024), 8192 chains,
3 sweeps) and row 13 (GraphSK(8192), 2048 chains, 1 sweep), --kernel
replica row 15 (GraphQSKT(1024, 16), 1024 chains), GraphSKRE(1024, 5)
gamma=2 (1024 chains) and GraphQSKNormalT(1024, 16) (128 chains), one
sweep each, all from init_state(seed=167). The variants of one case run in
turns, each timed --reps times. A variant that takes a part out computes a
wrong sweep: only its time means something; its acceptance is printed
beside it, since the work of the correction and the commit follows the
accepted flips. Variants:

  base           the kernel as it is
  philox_3       Philox with 3 rounds in the place of 10
  philox_1       Philox with 1 round (about a tenth of the draw's work)
                 (block-synchronous kernels)
  fast_exp       __expf in the place of expf (replica)
  no_diag        the span's diagonal block of J is not loaded into shared
                 memory (block-synchronous kernels)
  no_correction  the span's later fields are not corrected after a flip
  no_commit      the accepted flips are not committed to the fields
  chains_8       blocks of 8 chains in the place of 16 (block-synchronous
                 kernels: twice the blocks, the commit reads J once for 8)

Prints one JSON line per variant and case (with its registers and spill
lines from ptxas) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHILOX_3 = ("philox.cuh", "for (int r = 0; r < 10; ++r)",
            "for (int r = 0; r < 3; ++r)")
PHILOX_1 = ("philox.cuh", "for (int r = 0; r < 10; ++r)",
            "for (int r = 0; r < 1; ++r)")
CHAINS_8 = ("sweep_block.cuh", "constexpr int kChains = 16;",
            "constexpr int kChains = 8;")
#: (kernel, generation) -> (source, {variant: [(file, text, replacement)]})
VARIANTS = {
    ("sk", 1): ("sk_sweep.cu", {
        "base": [],
        "philox_3": [PHILOX_3],
        "no_correction": [("sk_sweep.cu",
                           "          lfw[k2] += d * (int32_t)jrow[k2];",
                           "          ;")],
        "no_commit": [("sk_sweep.cu", "if (n_acc && vec) {",
                       "if (false) {"),
                      ("sk_sweep.cu", "} else if (n_acc) {",
                       "} else if (false) {")],
    }),
    ("replica", 1): ("replica_sweep.cu", {
        "base": [],
        "philox_3": [PHILOX_3],
        "fast_exp": [("replica_sweep.cu", "expf(-beta * dE)",
                      "__expf(-beta * dE)")],
        "no_correction": [("replica_sweep.cu",
                           "            lfw[q2] += d * T(jrow[q2]);",
                           "            ;")],
        "no_commit": [("replica_sweep.cu",
                       "        if (n_acc) {\n"
                       "          for (int i = lane; i < Nk; i += 32) {",
                       "        if (false) {\n"
                       "          for (int i = lane; i < Nk; i += 32) {")],
    }),
    ("sk", 2): ("sk_sweep.cu", {
        "base": [],
        "philox_3": [PHILOX_3],
        "philox_1": [PHILOX_1],
        "chains_8": [CHAINS_8],
        "no_diag": [("sk_sweep.cu",
                     "      rrrmc::load_diag<VEC>(Jd, sp, J, N, s0, len);\n",
                     "")],
        "no_correction": [("sk_sweep.cu",
                           "          rrrmc::correct_span(lfw, Jd + kf * sp, "
                           "d, kf + 1, len, lane);\n", "")],
        "no_commit": [("sk_sweep.cu",
                       "      if (n_flips > rrrmc::kRowFlips)\n",
                       "      if (false)\n"),
                      ("sk_sweep.cu", "      else if (n_flips)\n",
                       "      else if (false)\n")],
    }),
    ("replica", 2): ("replica_sweep.cu", {
        "base": [],
        "philox_3": [PHILOX_3],
        "philox_1": [PHILOX_1],
        "chains_8": [CHAINS_8],
        "no_diag": [("replica_sweep.cu",
                     "        rrrmc::load_diag<VEC>(Jd, sp, J, Nk, i0, len);\n",
                     "")],

        "fast_exp": [("replica_sweep.cu", "expf(-beta * dE)",
                      "__expf(-beta * dE)")],
        "no_correction": [
            ("replica_sweep.cu",
             "            rrrmc::correct_span(lfw, Jd + qf * sp, d, qf + 1, "
             "len, lane);\n", ""),
            ("replica_sweep.cu", "          if (vec4) {\n"
             "            // groups of 4", "          if (false) {\n"
             "            // groups of 4"),
            ("replica_sweep.cu",
             "            for (int q2 = qf + 1 + lane; q2 < len; q2 += 32)\n"
             "              lfw[q2] += d * jrow[q2];\n", "")],
        "no_commit": [("replica_sweep.cu",
                       "        if (n_flips > rrrmc::kRowFlips)\n",
                       "        if (false)\n"),
                      ("replica_sweep.cu", "        else if (n_flips)\n",
                       "        else if (false)\n"),
                      ("replica_sweep.cu", "if (n_acc && vec4) {",
                       "if (false) {"),
                      ("replica_sweep.cu", "} else if (n_acc) {",
                       "} else if (false) {")],
    }),
}


def generation(csrc: str, source: str) -> int:
    with open(os.path.join(csrc, source)) as f:
        text = f.read()
    if "mma.sync" in text or "sweep_block.cuh" in text:
        return 2
    return 1


def build(cuda_build, source, name, subs, out_dir):
    """Start nvcc on the variant's copy of csrc/ (its `source` alone);
    returns the process."""
    d = os.path.join(out_dir, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC, d)
    for fname, old, new in subs:
        path = os.path.join(d, fname)
        text = open(path).read()
        if old not in text:
            raise RuntimeError(f"{name}: no {old!r} in {fname}")
        open(path, "w").write(text.replace(old, new))
    return subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared", "-o",
         os.path.join(d, "lib.so"), os.path.join(d, source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load(cuda_build, path):
    """The variant's library with the package's C signatures."""
    lib = ctypes.CDLL(path)
    for fn, (res, argt) in cuda_build._SIGNATURES.items():
        if hasattr(lib, fn):
            f = getattr(lib, fn)
            f.restype, f.argtypes = res, argt
    return lib


def cases(kernel, rt):
    """(label, model, chains, beta, sweeps, warm sweeps) of a kernel's timed
    cases: each row's case and its equilibrium case."""
    if kernel == "sk":
        sk1 = rt.GraphSK(1024, seed=4, device="cuda")
        sk8 = rt.GraphSK(8192, seed=4, device="cuda")
        return (("row 12: GraphSK(1024)", sk1, 8192, 2.0, 3, 0),
                ("row 12: GraphSK(1024)", sk1, 8192, 2.0, 3, 50),
                ("row 13: GraphSK(8192)", sk8, 2048, 2.0, 1, 0),
                ("row 13: GraphSK(8192)", sk8, 2048, 2.0, 1, 2))
    qskt = rt.GraphQSKT(1024, 16, 0.3, 2.0, seed=8370274, device="cuda")
    skre = rt.GraphSKRE(1024, 5, 2.0, 0.4, seed=8370275, device="cuda")
    return (("row 15: GraphQSKT(1024, 16)", qskt, 1024, 2.0, 1, 0),
            ("row 15: GraphQSKT(1024, 16)", qskt, 1024, 2.0, 1, 79),
            ("GraphSKRE(1024, 5) gamma=2", skre, 1024, 0.4, 1, 0),
            ("GraphSKRE(1024, 5) gamma=2", skre, 1024, 0.4, 1, 499),
            ("GraphSKRE(1024, 5) gamma=5", rt.GraphSKRE(
                1024, 5, 5.0, 0.4, seed=8370275, device="cuda"), 1024, 0.4,
             1, 100),
            ("GraphQSKNormalT(1024, 16)", rt.GraphQSKNormalT(
                1024, 16, 0.3, 2.0, seed=8370274, device="cuda"), 128, 2.0,
             1, 0))


def runner(torch, kernel, model, B, beta, sweeps, warm):
    """() -> (ms, flipped fraction) of one launch from the start state
    (after `warm` sweeps of the library loaded now: the base variant's),
    through the tree's SKSweeper or ReplicaSweeper."""
    import rrrmc_tpu_torch as rt

    st = rt.init_state(model, B, seed=167, device="cuda")
    if kernel == "sk":
        from rrrmc_tpu_torch.ops import sk

        sw = sk.SKSweeper(model, beta)
        sig0, lf0, E0 = st.sigma, model.local_fields(st.sigma), st.E
        extra = []
    else:
        from rrrmc_tpu_torch.ops import replica, replica_sweep

        sw = replica_sweep.ReplicaSweeper(model, beta)
        sig0 = st.sigma
        lf0, E0 = replica.replica_state(model, st.sigma, st.E)
        extra = [torch.zeros(B, dtype=torch.int32, device="cuda")]

    if warm:
        # one launch of `warm` sweeps in place on copies of the start
        sig0, lf0, E0 = sig0.clone(), lf0.clone(), E0.clone()
        sw(sig0, lf0, E0, *[t.clone() for t in extra], seed=167,
           n_sweeps=warm)

    def call(s):
        a = [s, lf0.clone(), E0.clone(), *[t.clone() for t in extra]]
        return lambda: sw(*a, seed=167, n_sweeps=sweeps, sweep0=warm)

    def once():
        s = sig0.clone()
        fn = call(s)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        flips = float((s != sig0).double().mean())
        return t0.elapsed_time(t1), flips

    return once


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=("sk", "replica"), default="sk")
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_sweep_ablation: no CUDA device is visible",
              file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.bench import card_line
    from rrrmc_tpu_torch.ops import cuda_build

    assert os.path.dirname(os.path.dirname(rt.__file__)) == root, rt.__file__
    name = "sk_sweep.cu" if args.kernel == "sk" else "replica_sweep.cu"
    gen = generation(str(cuda_build.CSRC), name)
    source, variants = VARIANTS[(args.kernel, gen)]
    out_dir = os.path.join(cuda_build.BUILD_DIR, "ablation", args.kernel)
    os.makedirs(out_dir, exist_ok=True)
    procs = {n: build(cuda_build, source, n, s, out_dir)
             for n, s in variants.items()}
    report = {}
    for n, proc in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {n}:\n{log[-4000:]}")
        report[n] = {
            "registers": sorted({int(r) for r in
                                 re.findall(r"Used (\d+) registers", log)}),
            "spill_lines": sum(bool(re.search(r"[1-9]\d* bytes spill", ln))
                               for ln in log.splitlines())}
    libs = {n: load(cuda_build, os.path.join(out_dir, n, "lib.so"))
            for n in variants}
    card = card_line()
    for label, m, B, beta, sweeps, warm in cases(args.kernel, rt):
        cuda_build._lib = libs["base"]
        once = runner(torch, args.kernel, m, B, beta, sweeps, warm)
        ms, acc = {n: [] for n in variants}, {}
        for rep in range(args.reps + 1):   # the first turn warms up
            for n, lib in libs.items():
                cuda_build._lib = lib
                t, a = once()
                if rep:
                    ms[n].append(t)
                acc[n] = a
        for n in variants:
            print(json.dumps({"variant": n, "generation": gen, "case": label,
                              "chains": B, "sweeps": sweeps,
                              "warm_sweeps": warm, "ms": ms[n],
                              "flipped": acc[n], **report[n], "root": root,
                              "card": card}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
