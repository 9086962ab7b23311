"""The reference paper's RRG relaxation experiment (test_RRG, RRRMC.jl
scripts/scripts.jl:83-149) on the PyTorch port (rrrmc_tpu_torch), on one
CUDA card: quench +-J random regular graphs to inverse temperature beta and
record the energy relaxation E(t) of standardMC (the site kernel), rrrMC
and bklMC (the sparse race kernel) on a common nominal-iteration axis,
averaged over disorder realizations and chains (`experiments.stats_time`).

The disorder realizations (GraphRRG seeds 100, 101, ...) run one after
another; each sampler call advances its chains together on the card.

    python scripts/torch_paper_rrg.py OUT.json [N] [n_seeds] [chains] [beta]

Prints a table per sampler and writes the JSON to OUT.json. A script in
scripts/ needs the repo on PYTHONPATH.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

import rrrmc_tpu_torch as rt
from rrrmc_tpu_torch.bench import card_line
from rrrmc_tpu_torch.experiments import stats_time


def main():
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    path = sys.argv[1]
    N = int(sys.argv[2]) if len(sys.argv) > 2 else 4096
    n_seeds = int(sys.argv[3]) if len(sys.argv) > 3 else 10
    chains = int(sys.argv[4]) if len(sys.argv) > 4 else 64
    beta = float(sys.argv[5]) if len(sys.argv) > 5 else 2.0
    iters, step = 100_000, 1000
    if not torch.cuda.is_available():
        raise SystemExit("torch_paper_rrg: no CUDA device is visible")
    card = card_line()
    print(card)

    models = [rt.GraphRRG(N, 3, (-1, 1), seed=100 + s)
              for s in range(n_seeds)]
    out = {"N": N, "K": 3, "beta": beta, "n_seeds": n_seeds,
           "chains": chains, "iters": iters, "step": step, "card": card,
           "samplers": {}}
    for name, sampler, kw in [
        ("standardMC", rt.standardMC, {"backend": "kernel"}),
        ("rrrMC", rt.rrrMC, {}),
        ("bklMC", rt.bklMC, {}),
    ]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Es = []
        for s, X in enumerate(models):
            E, st = sampler(X, beta, iters, step=step, chains=chains,
                            seed=7 + s, **kw)
            if not torch.equal(X.energy(st.sigma), st.E):
                raise AssertionError(f"{name}: E != energy(sigma)")
            Es.append(E.double().cpu().numpy())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        Es = np.concatenate(Es, axis=0) / N
        st_ = stats_time(Es, step=step, nbins=12)
        out["samplers"][name] = {"backend": rt.LAST_ROUTE["backend"],
                                 "impl": rt.LAST_ROUTE.get("impl"),
                                 "wall_s": wall,
                                 **{k: v.tolist() for k, v in st_.items()}}
        print(f"== {name} ({rt.LAST_ROUTE['backend']}, {wall:.2f} s) ==")
        for t, m, e in zip(st_["t"], st_["E_mean"], st_["E_sem"]):
            print(f"  t={t:>10.0f}  E/N = {m:+.5f} +- {e:.5f}")

    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
