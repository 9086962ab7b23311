"""The cost of `tempered_ensembles` against the ladder size T on the
PyTorch port (the JAX package's scripts/tempering_scaling.py): the ladder
is a Python loop over slots, one slot kernel a slot and one host sync a
round (the swap), so a round's cost should grow linearly in T.

Workload: `tempered_ensembles` with `sweep_kernel` (one site-kernel sweep
launch a slot a round) on GraphRRG(256, 3, +-J, seed=11), beta_k = 0.5 +
0.06 k, T in {2, 4, 8, 16, 32}, 64 chains. For each T:

  * first_call_s: the wall-clock of the first 2-round call less that of a
    second one, with the kernel library built beforehand (the JAX row's
    compile_s: nothing is compiled here at run time);
  * round_s, round_per_slot_s: the steady-state wall-clock a round (a
    2 + rounds call less a 2-round one, over rounds), and a round a slot;
  * swap_acc_mean: accepted swaps a chain over the 2 + rounds call.

    python scripts/torch_tempering_scaling.py [rounds] [out.json]
        [--device cpu] [--T 2 4 ...]

The default output is chiprun_out/torch_tempering_scaling.json, with the
card's name and power limit (nvidia-smi) in "device". It runs on the card
and exits non-zero without one unless given --device cpu. A script in
scripts/ needs the repo on PYTHONPATH.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

import rrrmc_tpu_torch as rt
from rrrmc_tpu_torch.bench import card_line, script_device
from rrrmc_tpu_torch.parallel.tempering import sweep_kernel, tempered_ensembles

DEFAULT_OUT = "chiprun_out/torch_tempering_scaling.json"
N, K, SEED, CHAINS = 256, 3, 11, 64
LADDERS = (2, 4, 8, 16, 32)


def _timed(fn, device):
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0, out


def measure(T, rounds, *, device, chains=CHAINS, n=N):
    X = rt.GraphRRG(n, K, (-1, 1), seed=SEED, device=device)
    # swap-viable ladder at every T: a fixed adjacent spacing sized so
    # Delta_beta * std(E) ~ 1 at N=256 (std(E) ~ sqrt(N) ~ 16)
    betas = 0.5 + 0.06 * np.arange(T)
    models = [X] * T

    def call(n_rounds):
        return tempered_ensembles(models, betas, n_rounds, chains=chains,
                                  kernel=sweep_kernel, seed=5,
                                  device=device)
    t_first, _ = _timed(lambda: call(2), device)
    t_warm2, _ = _timed(lambda: call(2), device)
    dt, (_, _, st) = _timed(lambda: call(2 + rounds), device)
    per_round = (dt - t_warm2) / rounds
    return {"T": T, "first_call_s": t_first - t_warm2,
            "round_s": per_round, "round_per_slot_s": per_round / T,
            "swap_acc_mean": float(st.swap_acc.double().mean())}


def run(rounds, *, device, ladders=LADDERS, chains=CHAINS, n=N, log=print):
    """One row a ladder size; the kernel library is built first."""
    if device.type == "cuda":
        from rrrmc_tpu_torch.ops import cuda_build
        cuda_build.library()
    rows = []
    for T in ladders:
        r = measure(T, rounds, device=device, chains=chains, n=n)
        rows.append(r)
        log(json.dumps(r))
    return {"model": f"GraphRRG N={n} K={K}, sweep_kernel, chains={chains}",
            "ladder": "beta_k = 0.5 + 0.06k (fixed adjacent spacing sized "
                      "for ~20-40% swap acceptance at every T; "
                      "swap_acc_mean counts accepted swaps per chain over "
                      "the 2 + rounds call)",
            "rounds_measured": rounds, "rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rounds", nargs="?", type=int, default=20)
    ap.add_argument("out", nargs="?", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--T", type=int, nargs="+", default=list(LADDERS))
    args = ap.parse_args(argv)
    device = script_device(args.device, "torch_tempering_scaling")
    card = card_line() if device.type == "cuda" else "cpu"
    print(card, flush=True)
    out = run(args.rounds, device=device, ladders=args.T,
              log=lambda s: print(s, flush=True))
    out["device"] = card
    d = os.path.dirname(args.out)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
