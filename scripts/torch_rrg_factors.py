"""The reference's equal-wallclock sampler-alignment experiment on the
PyTorch port (rrrmc_tpu_torch), on one CUDA card: per-iteration speed of
each sampler relative to rrrMC on GraphRRG N=10^4 K=3 (seed 167), +-J and
Gaussian couplings, at beta in {2, 3, 4} (RRRMC.jl scripts/scripts.jl:
30-37, 163-166; BASELINE.md lists the reference's CPU rows).

The table is `experiments.equilibrated_factors` on the sparse race kernel
(the JAX package's scripts/bench_all.py::factors_sparse_section): 128
chains, 1000 sweeps of kernel BKL from a random start, then every row from
the same spins. One JSON row per (graph, beta) on stdout, with the card's
name and power limit.

    python scripts/torch_rrg_factors.py [--out rows.json] [--no-table]
        [--random-start] [--densified-check SWEEPS] [--law-check SWEEPS]

--no-table skips the factor table (for a run of the checks alone).

--random-start also runs the JAX package's scripts/rrg_factors.py table:
equal_wallclock_factors from a random start (20 000 iterations, 256
chains) and standardMC's aggregate rate. --densified-check equilibrates
the Gaussian graph for SWEEPS sweeps at each beta by bklMC on the sparse
race kernel and on densify(model) (the dense race kernel) from one seed,
and prints both E/N with their standard errors over the chains.
--law-check runs, on the +-J graph at each beta, kernel bklMC and
standardMC on the site kernel for SWEEPS sweeps of nominal iterations from
random starts (256 chains, seeds 167, 1, 2, 3): BKL is the rejection-free
form of the same random-site Metropolis chain, so their E/N at equal
iterations must agree. A script in scripts/ needs the repo on PYTHONPATH.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

import rrrmc_tpu_torch as rt
from rrrmc_tpu_torch.bench import card_line
from rrrmc_tpu_torch.experiments import (equal_wallclock_factors,
                                         equilibrated_factors, runtest)

N, K, SEED = 10_000, 3, 167
CHAINS, TARGET_S, EQUIL_SWEEPS = 128, 6.0, 1000
BETAS = (2.0, 3.0, 4.0)
GRAPHS = {"rrg_pmJ": lambda: rt.GraphRRG(N, K, (-1, 1), seed=SEED),
          "rrg_normal": lambda: rt.GraphRRGNormal(N, K, seed=SEED)}


def densified_check(X, Xd, beta: float, sweeps: int, chains: int,
                    card: str):
    """E/N after `sweeps` sweeps of kernel bklMC from one random start on
    the sparse Gaussian graph X and on its densified copy Xd."""
    out = {"check": "sparse vs densified", "graph": "rrg_normal",
           "beta": beta, "sweeps": sweeps, "chains": chains, "card": card}
    for name, model in (("sparse", X), ("densified", Xd)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sweeps * N
        _, st = rt.bklMC(model, beta, n, step=n, chains=chains, seed=SEED,
                         backend="kernel")
        torch.cuda.synchronize()
        e = model.to_physical(st.E).double() / N
        out[name] = {"backend": rt.LAST_ROUTE["backend"],
                     "impl": rt.LAST_ROUTE["impl"],
                     "E_per_spin": float(e.mean()),
                     "sem": float(e.std()) / chains ** 0.5,
                     "moves_per_chain": float(st.accepted.double().mean()),
                     "wall_s": time.perf_counter() - t0}
    print(json.dumps(out), flush=True)
    return out


def law_check(X, beta: float, sweeps: int, card: str):
    """E/N of kernel bklMC and of standardMC on the site kernel after
    `sweeps` sweeps of nominal iterations from random starts, 256 chains,
    four seeds each."""
    n = sweeps * N
    for name, sampler in (("bkl", rt.bklMC), ("standard", rt.standardMC)):
        for seed in (SEED, 1, 2, 3):
            _, st = sampler(X, beta, n, step=n, chains=256, seed=seed,
                            backend="kernel")
            e = X.to_physical(st.E).double() / N
            rec = {"check": "bkl against Metropolis", "graph": "rrg_pmJ",
                   "beta": beta, "sweeps": sweeps, "sampler": name,
                   "backend": rt.LAST_ROUTE["backend"], "seed": seed,
                   "E_per_spin": float(e.mean()),
                   "sem": float(e.std()) / 256 ** 0.5, "card": card}
            print(json.dumps(rec), flush=True)
            yield rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    ap.add_argument("--no-table", action="store_true")
    ap.add_argument("--random-start", action="store_true")
    ap.add_argument("--densified-check", type=int, metavar="SWEEPS")
    ap.add_argument("--law-check", type=int, metavar="SWEEPS")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_rrg_factors: no CUDA device is visible")
    card = card_line()
    print(card, flush=True)
    out = []
    for name in () if args.no_table else GRAPHS:
        X = GRAPHS[name]()
        for beta in BETAS:
            row = equilibrated_factors(X, beta, chains=CHAINS,
                                       equil_sweeps=EQUIL_SWEEPS,
                                       target_s=TARGET_S)
            row.update(graph=name, kernel="sparse", card=card)
            print(json.dumps(row), flush=True)
            out.append(row)
        if args.random_start:
            for beta in BETAS:
                f = equal_wallclock_factors(X, beta, iters=20_000,
                                            chains=256)
                rec = {"random_start": True, "graph": name, "beta": beta,
                       "factors_vs_rrr": f, "card": card}
                print(json.dumps(rec), flush=True)
                out.append(rec)
            r = runtest(rt.standardMC, X, 2.0, 20_000, chains=256,
                        backend="kernel")
            rec = {"random_start": True, "graph": name,
                   "standardMC": r, "card": card}
            print(json.dumps(rec), flush=True)
            out.append(rec)
    if args.densified_check:
        X = GRAPHS["rrg_normal"]()
        Xd = rt.densify(X)
        for beta in BETAS:
            out.append(densified_check(X, Xd, beta, args.densified_check,
                                       CHAINS, card))
    if args.law_check:
        X = GRAPHS["rrg_pmJ"]()
        for beta in BETAS:
            out.extend(law_check(X, beta, args.law_check, card))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
