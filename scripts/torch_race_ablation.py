#!/usr/bin/env python3
"""Where the sparse race kernel's time goes: time variants of
rrrmc_tpu_torch/csrc/rejfree_sparse.cu, each with one part of the fused
pass taken out or one launch bound changed, on one NVIDIA GPU:

    python3 scripts/torch_race_ablation.py [--reps 3]

Each variant is built from a copy of csrc/ under rrrmc_tpu_torch/_build/
(one nvcc per variant, all started together) and loaded in the place of
the package's library, then times one 1024-move bkl chunk with every chain
active (a target no chain reaches) on PERF.md's row 2 and row 4 cases
(GraphRRG(10^4, 3) and GraphEA(16, 3) +-J, 1024 chains, beta = 2: 256
threads a chain by the launch rule, printed with the launch's plan). A
variant that takes a part out computes a wrong race: only its time means
something. Variants:

  base            the kernel as it is
  no_philox       the race words from a cheap hash in the place of Philox
  no_transpose    each lane races its own Philox group's four words (no
                  exchange of words within the quad)
  always_exact    every site's score from the two IEEE logs (no bound)
  no_flip         the winner's flip left out (the state never changes)
  min_blocks_6/8  __launch_bounds__(256, 6 or 8): fewer registers, more
                  blocks of 256 threads on an SM

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
#: variant -> [(file, text, replacement)]
VARIANTS = {
    "base": [],
    "no_philox": [("race.cuh", PHILOX,
                   "        x = make_uint4(g * 2654435761u, g ^ mv, g + mv,"
                   " g * 40503u);")],
    "no_transpose": [("race.cuh", "const uint32_t word = words[j];",
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
    "always_exact": [("race.cuh",
                      "if (f.lb[(word >> 24) ^ 0x80u] + be <= thr)",
                      "if (true)")],
    "no_flip": [("rejfree_sparse.cu",
                 "  auto flip = [&](int w, int sw, bool rrr) {\n"
                 "    if (tid >= 32) return;",
                 "  auto flip = [&](int w, int sw, bool rrr) {\n    return;")],
    "min_blocks_6": [("rejfree_sparse.cu", LB,
                      "__launch_bounds__(T, T == 256 ? 6 : 1024 / T)")],
    "min_blocks_8": [("rejfree_sparse.cu", LB,
                      "__launch_bounds__(T, T == 256 ? 8 : 1024 / T)")],
}


def build(cuda_build, name, subs, out_dir):
    """Start nvcc on the variant's copy of csrc/; returns the process."""
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
         os.path.join(d, "lib.so"), os.path.join(d, "rejfree_sparse.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_race_ablation: no CUDA device is visible",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.ops import cuda_build, rejfree
    from rrrmc_tpu_torch.samplers.families import family_of

    out_dir = os.path.join(cuda_build.BUILD_DIR, "ablation")
    os.makedirs(out_dir, exist_ok=True)
    procs = {n: build(cuda_build, n, s, out_dir) for n, s in VARIANTS.items()}
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
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].strip()
    cases = (("row 2: GraphRRG(10^4, 3) +-J", rt.GraphRRG(
                 10_000, 3, (-1, 1), seed=167, device="cuda")),
             ("row 4: GraphEA(16, 3) +-J", rt.GraphEA(
                 16, 3, (-1, 1), seed=42, device="cuda")))
    B = 1024
    for name in VARIANTS:
        lib = ctypes.CDLL(os.path.join(out_dir, name, "lib.so"))
        for fn, (res, argt) in cuda_build._SIGNATURES.items():
            if hasattr(lib, fn):
                f = getattr(lib, fn)
                f.restype, f.argtypes = res, argt
        cuda_build._lib = lib
        for label, m in cases:
            fam = family_of(m)
            st = rt.init_state(m, B, seed=167, device="cuda")
            lf = m.init_aux(st.sigma)

            def once():
                a = [st.sigma.clone(), lf.clone(), st.E.clone(),
                     torch.zeros(B, dtype=torch.int32, device="cuda"),
                     torch.zeros(B, dtype=torch.int32, device="cuda"),
                     torch.zeros(B, dtype=torch.float32, device="cuda")]
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                fam.race(*a, *fam.tables(m), mode="bkl", n_moves=1024,
                         seed=167, beta_s=2.0, target=2 ** 30,
                         **fam.race_kw(m))
                t1.record()
                torch.cuda.synchronize()
                return t0.elapsed_time(t1)

            once()
            ms = [once() for _ in range(args.reps)]
            print(json.dumps({"variant": name, "case": label, "chains": B,
                              "moves": 1024, "ms": ms,
                              "plan": dict(rejfree.LAST_PLAN),
                              **report[name], "card": card}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
