#!/usr/bin/env python3
"""Whether parallel tempering's rung at beta = 1 on GraphRRG(10^4, 3) +-J
(seed 167, the PT path of chip_smoke.py) agrees with plain sweepMC at
beta = 1 once both have run long enough, on one CUDA card.

beta = 1 is below the K = 3 glass transition (tanh beta_c = 1 / sqrt(2),
beta_c ~ 0.881): both runs start from random spins and age, so a gap
between them at one length says nothing by itself. A gap that is aging
shrinks as the runs grow; a bias of the ladder stays. The script runs,
each from random spins, with PT_SWEEPS sweeps a round:

* ladder "hot end at 1": PT_T rungs beta_k = 1 + 0.02 k of PT_CHAINS
  chains (the PT path's), LONG rounds; the rung at beta = 1 is rung 0;
* ladder "hot end at 0.8": beta_k = 0.8 + 0.02 k, the same shape and
  length; the rung at beta = 1 is rung 10, with ten hotter rungs, the
  hottest above beta_c;
* sweepMC at beta = 1 and, as a control, at 1.1: REF_CHAINS chains,
  LONG * PT_SWEEPS sweeps, E read every PT_SWEEPS sweeps.

For each length L of LENGTHS (rounds; one run read at its prefixes) it
prints the second-half E/N of each series over rounds [L / 2, L) (the
columns' time averages, their mean and standard error) and the gaps to
sweepMC at beta = 1 with 5 hypot of the standard errors; and the series
in windows of rounds [w, 2 w). Then, from the hot-end-at-1 ladder's final
state, it continues the ladder CONT rounds and runs sweepMC at beta = 1
from the PT_CHAINS configurations that hold rank 0 at its start (the same
spins), and prints both series' E/N in windows: a ladder whose rung 0 is
Boltzmann at beta = 1 hands sweepMC configurations on which it does not
drift.

    PYTHONPATH=. python3 scripts/torch_pt_equilibration.py [--out FILE]

One JSON line per reading on stdout (and in --out), with the card's name
and power limit; exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from rrrmc_tpu_torch.bench import card_line

SEED = 167
N_SITES = 10_000
PT_T, PT_CHAINS, PT_SWEEPS = 32, 32, 10
LONG = 6000
LENGTHS = (200, 600, 2000, 6000)
REF_CHAINS = 1024
CONT = 200
LADDERS = {"hot end at 1": (1.0, 0), "hot end at 0.8": (0.8, 10)}


def second_half(series, L):
    """Mean and standard error over columns of the time averages of a
    [rounds, C] series over rounds [L / 2, L)."""
    m = series[L // 2:L].double().mean(0)
    return float(m.mean()), float(m.std()) / m.numel() ** 0.5


def windows(series):
    """The [rounds, C] series' mean over rounds [w, 2 w), w = 1, 2, 4..."""
    out, w = {}, 1
    while w < series.shape[0]:
        out[f"{w}-{min(2 * w, series.shape[0])}"] = float(
            series[w:2 * w].double().mean())
        w *= 2
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import rrrmc_tpu_torch as rt

    card = card_line()
    lines = []

    def emit(rec):
        rec["card"] = card
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)

    X = rt.GraphRRG(N_SITES, 3, (-1, 1), seed=SEED)
    N = X.N
    series, states = {}, {}
    for name, (b0, k) in LADDERS.items():
        betas = [b0 + 0.02 * j for j in range(PT_T)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Es, ranks, st = rt.parallel_tempering(
            X, betas, LONG, sweeps_per_round=PT_SWEEPS, chains=PT_CHAINS,
            seed=SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        series[name] = rt.energies_by_rank(Es, ranks)[:, k] / N
        states[name] = st
        emit({"run": f"parallel_tempering {name}", "betas": [betas[0],
              betas[-1]], "rung": k, "beta": betas[k], "rounds": LONG,
              "seconds": wall, "windows": windows(series[name])})
    for beta in (1.0, 1.1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        E_ref, _ = rt.sweepMC(X, beta, LONG * PT_SWEEPS, step=PT_SWEEPS,
                              chains=REF_CHAINS, seed=SEED + 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        series[f"sweepMC {beta:g}"] = E_ref.t() / N
        emit({"run": f"sweepMC beta {beta:g}", "sweeps": LONG * PT_SWEEPS,
              "chains": REF_CHAINS, "seconds": wall,
              "windows": windows(series[f"sweepMC {beta:g}"])})
    for L in LENGTHS:
        ref, sref = second_half(series["sweepMC 1"], L)
        rec = {"run": "gap", "rounds": L, "sweeps": L * PT_SWEEPS,
               "sweepMC 1": [ref, sref]}
        for name, s in series.items():
            if name == "sweepMC 1":
                continue
            a, sa = second_half(s, L)
            rec[name] = [a, sa]
            rec[f"{name} - sweepMC 1"] = a - ref
            rec[f"{name} five_se"] = 5 * math.hypot(sa, sref)
        emit(rec)

    # the same spins: the ladder's rank-0 configurations at the end of its
    # run, continued in the ladder and alone under sweepMC at beta = 1
    st = states["hot end at 1"]
    betas = [1.0 + 0.02 * j for j in range(PT_T)]
    at0 = st.rank == 0
    sig0 = st.sigma[at0]
    Es, ranks, _ = rt.parallel_tempering(
        X, betas, CONT, sweeps_per_round=PT_SWEEPS, chains=PT_CHAINS,
        state=st)
    pt = rt.energies_by_rank(Es, ranks)[:, 0] / N
    s0 = rt.state_from_arrays(X, sig0.cpu().numpy(), seed=SEED + 4,
                              device=sig0.device)
    E_ref, _ = rt.sweepMC(X, 1.0, CONT * PT_SWEEPS, step=PT_SWEEPS,
                          state=s0)
    ref = E_ref.t() / N
    emit({"run": "same spins", "rounds": CONT,
          "start": float(X.energy(sig0).double().mean()) / N,
          "parallel_tempering rung 0": windows(pt),
          "sweepMC 1": windows(ref),
          "second half": {"parallel_tempering rung 0": second_half(pt, CONT),
                          "sweepMC 1": second_half(ref, CONT)}})
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
