#!/usr/bin/env python3
"""Where a race kernel's time goes: time variants of
rrrmc_tpu_torch/csrc/rejfree_sparse.cu (--kernel sparse) or
rejfree_dense.cu (--kernel dense), each with one part of the fused pass
taken out or one launch bound changed, on one NVIDIA GPU:

    python3 scripts/torch_race_ablation.py [--kernel sparse] [--reps 3]

Each variant is built from a copy of csrc/ under rrrmc_tpu_torch/_build/
(one nvcc per variant, all started together) and loaded in the place of
the package's library, then times one 1024-move chunk with every chain
active (a target no chain reaches), printed with the launch's plan. The
sparse kernel: bkl on PERF.md's row 2 and row 4 cases (GraphRRG(10^4, 3)
and GraphEA(16, 3) +-J, 1024 chains, beta = 2: 256 threads a chain by the
launch rule). The dense kernel: bkl and rrr on row 5's case
(GraphSK(1024), beta = 4) at 132, 528 and 1024 chains (one block an SM,
four, and the row's two waves of four), bkl on row 6's cases
(densify(GraphRRG(10^4, 3)) with 1024 chains, GraphSKNormal(4096) with
128), beta = 4. The variants of one case run in turns, each timed --reps
times. A variant that takes a part out computes a wrong race: only its
time means something. Variants:

  base            the kernel as it is
  no_philox       the race words from a cheap hash in the place of Philox
  no_transpose    each lane races its own Philox group's four words (no
                  exchange of words within the quad; sparse)
  always_exact    every site's score from the two IEEE logs (no bound)
  no_second       no second sum of z where min bE > 0 (dense)
  no_flip         the winner's flip left out (the state never changes)
  min_blocks_6/8  __launch_bounds__(256, 6 or 8): fewer registers, more
                  blocks of 256 threads on an SM (8: sparse)

Prints one JSON line per variant and case (with the variant's registers
and spill lines from ptxas) and the card's name and power limit.
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
LB = "__launch_bounds__(T, 1024 / T)"
PHILOX = """        x = philox4x32_10(make_uint4(g, mv, DRAW_RACE, 0u),
                          make_uint2(seed, chain));"""
#: variant -> [(file, text, replacement)], shared by both kernels
COMMON = {
    "base": [],
    "no_philox": [("race.cuh", PHILOX,
                   "        x = make_uint4(g * 2654435761u, g ^ mv, g + mv,"
                   " g * 40503u);")],
    "always_exact": [("race.cuh",
                      "if (f.lb[(word >> 24) ^ 0x80u] + be <= thr)",
                      "if (true)")],
}
#: --kernel -> (source, its own variants)
KERNELS = {
    "sparse": ("rejfree_sparse.cu", {
        "no_transpose": [
            ("race.cuh", "const uint32_t word = words[j];",
             "const uint32_t word = j == 0 ? x0 : j == 1 ? x1 : "
             "j == 2 ? x2 : x3;"),
            ("race.cuh", "  for (int r0 = 0; r0 < rows; r0 += 4) {\n"
             "    if (RACE) {",
             "  for (int r0 = 0; r0 < rows; r0 += 4) {\n"
             "    uint32_t x0 = 0u, x1 = 0u, x2 = 0u, x3 = 0u;\n"
             "    if (RACE) {"),
            ("race.cuh", "      f.words[3 * (T + 1) + tid] = x.w;\n",
             "      f.words[3 * (T + 1) + tid] = x.w;\n"
             "      x0 = x.x; x1 = x.y; x2 = x.z; x3 = x.w;\n")],
        "no_flip": [("rejfree_sparse.cu",
                     "  auto flip = [&](int w, int sw, bool rrr) {\n"
                     "    if (tid >= 32) return;",
                     "  auto flip = [&](int w, int sw, bool rrr) {\n"
                     "    return;")],
        "min_blocks_6": [("rejfree_sparse.cu", LB,
                          "__launch_bounds__(T, T == 256 ? 6 : 1024 / T)")],
        "min_blocks_8": [("rejfree_sparse.cu", LB,
                          "__launch_bounds__(T, T == 256 ? 8 : 1024 / T)")],
    }),
    "dense": ("rejfree_dense.cu", {
        "no_second": [("race.cuh", "  if (mn != 0.0f) {", "  if (false) {")],
        "no_flip": [("rejfree_dense.cu",
                     "    add_row<T>(lf, J + (size_t)w * N, N, G(-2 * sw), "
                     "rrr ? saved : nullptr);\n", ""),
                    ("rejfree_dense.cu", "    restore<T>(lf, saved, N);\n",
                     "")],
        "min_blocks_6": [("rejfree_dense.cu", LB,
                          "__launch_bounds__(T, T == 256 ? 6 : 1024 / T)")],
    }),
}


def cases(kernel, rt):
    """(label, model, chains, beta, modes) of a kernel's timed cases."""
    if kernel == "sparse":
        return (("row 2: GraphRRG(10^4, 3) +-J", rt.GraphRRG(
                    10_000, 3, (-1, 1), seed=167, device="cuda"), 1024, 2.0,
                 ("bkl",)),
                ("row 4: GraphEA(16, 3) +-J", rt.GraphEA(
                    16, 3, (-1, 1), seed=42, device="cuda"), 1024, 2.0,
                 ("bkl",)))
    sk = rt.GraphSK(1024, seed=4, device="cuda")
    return tuple((f"row 5: GraphSK(1024), {b} chains", sk, b, 4.0,
                  ("bkl", "rrr")) for b in (132, 528, 1024)) + (
        ("row 6: densify(GraphRRG(10^4, 3))", rt.densify(rt.GraphRRG(
            10_000, 3, (-1, 1), seed=7, device="cuda")), 1024, 4.0,
         ("bkl",)),
        ("row 6: GraphSKNormal(4096)", rt.GraphSKNormal(
            4096, seed=4, device="cuda"), 128, 4.0, ("bkl",)))


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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="sparse")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_race_ablation: no CUDA device is visible",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.bench import card_line
    from rrrmc_tpu_torch.ops import cuda_build, launch
    from rrrmc_tpu_torch.samplers.families import family_of

    source, own = KERNELS[args.kernel]
    variants = {**COMMON, **own}
    out_dir = os.path.join(cuda_build.BUILD_DIR, "ablation", args.kernel)
    os.makedirs(out_dir, exist_ok=True)
    procs = {n: build(cuda_build, source, n, s, out_dir)
             for n, s in variants.items()}
    report = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
        report[name] = {
            "registers": sorted({int(r) for r in
                                 re.findall(r"Used (\d+) registers", log)}),
            "spill_lines": sum(bool(re.search(r"[1-9]\d* bytes spill", ln))
                               for ln in log.splitlines())}
    libs = {n: load(cuda_build, os.path.join(out_dir, n, "lib.so"))
            for n in variants}
    card = card_line()
    for label, m, B, beta, modes in cases(args.kernel, rt):
        fam = family_of(m)
        st = rt.init_state(m, B, seed=167, device="cuda")
        lf = m.init_aux(st.sigma)
        for mode in modes:
            def once():
                a = [st.sigma.clone(), lf.clone(), st.E.clone(),
                     torch.zeros(B, dtype=torch.int32, device="cuda"),
                     torch.zeros(B, dtype=torch.int32, device="cuda"),
                     torch.zeros(B, dtype=torch.float32, device="cuda")]
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                fam.race(*a, *fam.tables(m), mode=mode, n_moves=1024,
                         seed=167, beta_s=beta * m.scale, target=2 ** 30,
                         **fam.race_kw(m))
                t1.record()
                torch.cuda.synchronize()
                return t0.elapsed_time(t1)

            ms, plans = {n: [] for n in variants}, {}
            for rep in range(args.reps + 1):   # the first turn warms up
                for name, lib in libs.items():
                    cuda_build._lib = lib
                    launch.facts.cache_clear()  # they hold for one library
                    launch.PLANS.clear()
                    t = once()
                    if rep:
                        ms[name].append(t)
                    (plans[name],) = launch.PLANS.values()
            for name in variants:
                print(json.dumps({"variant": name, "case": label,
                                  "chains": B, "mode": mode, "moves": 1024,
                                  "ms": ms[name], "plan": plans[name],
                                  **report[name], "card": card}),
                      flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
