#!/usr/bin/env python3
"""Time the dense sweep kernels of the PyTorch + CUDA port on their
kernel-table cases (PERF.md section 6: row 12, GraphSK(1024) with 8192
chains, 3 sweeps; row 13, GraphSK(8192) with 2048 chains, 1 sweep; row 15,
GraphQSKT(1024, 16) with 1024 chains, 1 sweep), GraphSKRE(1024, 5) at
gamma=2 and 5 (1024 chains) and GraphQSKNormalT(1024, 16) (128 chains, the
float base), for the rrrmc_tpu_torch package under --root, so that two
trees are timed in one call on one card:

    python3 scripts/torch_sweep_timing.py --root DIR [--reps 6] [--paths]

Each case runs twice: from init_state(seed=167) (the row's case) and from
the state that one main-path checkpoint of warm sweeps of the tree's own
kernel reaches from it (its equilibrium case: 50 sweeps for GraphSK(1024),
2 for GraphSK(8192), 79 for the Trotter composites, 499 for SKRE at
gamma=2 and 100 at gamma=5, as chip_smoke.py's main paths step; gamma=5's
is nearly frozen). Both trees reach the same warm state (their kernels
equal the plain version bit for bit); `state` prints a checksum of it.
Each launch goes through the tree's SKSweeper or ReplicaSweeper and is
timed with CUDA events; --reps launches of each, all printed with their
median.

--paths times the main paths' sampler calls in the place of the kernel
cases, as chip_smoke.py runs them: sweepMC on GraphSK(1024) (8192 chains,
500 sweeps) and GraphSK(8192) (2048 chains, 20 sweeps), sweepMC_quant on
GraphQSKT(1024, 16) (395 sweeps) and sweepMC_replica on GraphSKRE(1024, 5)
at gamma=2 (499 sweeps) and 3, 4, 5 (100 sweeps each), 1024 chains: one
untimed call, then --reps calls, each on the host clock around the call
and a synchronize, as attempted flips x chains per second.

Prints one JSON line per case and the card's name and power limit; exits 1
without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

SEED = 167
#: (label, builder, sampler, chains, beta, sweeps, checkpoint step, seed)
#: of the main paths' sweep calls (chip_smoke.py's dense and replica paths)
PATHS = tuple(
    [("sweepMC GraphSK(1024)", lambda rt: rt.GraphSK(1024, seed=4,
                                                     device="cuda"),
      "sweepMC", 8192, 2.0, 500, 50, 21),
     ("sweepMC GraphSK(8192)", lambda rt: rt.GraphSK(8192, seed=4,
                                                     device="cuda"),
      "sweepMC", 2048, 2.0, 20, 2, 22),
     ("sweepMC_quant QSKT(1024, 16)", lambda rt: rt.GraphQSKT(
         1024, 16, 0.3, 2.0, seed=8370274, device="cuda"),
      "sweepMC_quant", 1024, 2.0, 395, 79, 71),
     ("sweepMC_replica SKRE(1024, 5) gamma=2", lambda rt: rt.GraphSKRE(
         1024, 5, 2.0, 0.4, seed=8370275, device="cuda"),
      "sweepMC_replica", 1024, 0.4, 499, 499, 75)]
    + [(f"sweepMC_replica SKRE(1024, 5) gamma={g}", lambda rt, g=g:
        rt.GraphSKRE(1024, 5, float(g), 0.4, seed=8370275, device="cuda"),
        "sweepMC_replica", 1024, 0.4, 100, 100, 77) for g in (3, 4, 5)])
#: (row, label, builder, chains, beta, sweeps, warm sweeps)
CASES = (
    (12, "GraphSK(1024)", lambda rt: rt.GraphSK(1024, seed=4, device="cuda"),
     8192, 2.0, 3, 50),
    (13, "GraphSK(8192)", lambda rt: rt.GraphSK(8192, seed=4, device="cuda"),
     2048, 2.0, 1, 2),
    (15, "GraphQSKT(1024, 16)", lambda rt: rt.GraphQSKT(
        1024, 16, 0.3, 2.0, seed=8370274, device="cuda"), 1024, 2.0, 1, 79),
    (None, "GraphSKRE(1024, 5) gamma=2", lambda rt: rt.GraphSKRE(
        1024, 5, 2.0, 0.4, seed=8370275, device="cuda"), 1024, 0.4, 1, 499),
    (None, "GraphSKRE(1024, 5) gamma=5", lambda rt: rt.GraphSKRE(
        1024, 5, 5.0, 0.4, seed=8370275, device="cuda"), 1024, 0.4, 1, 100),
    (None, "GraphQSKNormalT(1024, 16)", lambda rt: rt.GraphQSKNormalT(
        1024, 16, 0.3, 2.0, seed=8370274, device="cuda"), 128, 2.0, 1, 79),
)


def events_ms(torch, fn) -> float:
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def sweeper(torch, rt, model, B, beta):
    """(state tensors, launch(tensors, n_sweeps, sweep0), its kernel's
    name in ops/launch.py's PLANS)."""
    st = rt.init_state(model, B, seed=SEED, device="cuda")
    if hasattr(model, "resid_m"):
        from rrrmc_tpu_torch.ops import replica, replica_sweep

        sw = replica_sweep.ReplicaSweeper(model, beta)
        lf, E = replica.replica_state(model, st.sigma, st.E)
        acc = torch.zeros(B, dtype=torch.int32, device="cuda")
        return ([st.sigma, lf, E, acc],
                lambda a, n, s0: sw(*a, seed=SEED, n_sweeps=n, sweep0=s0),
                "replica_sweep")
    from rrrmc_tpu_torch.ops import sk

    sw = sk.SKSweeper(model, beta)
    return ([st.sigma, model.local_fields(st.sigma), st.E],
            lambda a, n, s0: sw(*a, seed=SEED, n_sweeps=n, sweep0=s0),
            "sk_sweep")


def time_paths(torch, rt, root, card, reps) -> None:
    """One JSON line per main-path sweep call of PATHS."""
    import time

    for label, build, sampler, B, beta, sweeps, step, seed in PATHS:
        model = build(rt)
        fn = getattr(rt, sampler)

        def call():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(model, beta, sweeps, step=step, chains=B, seed=seed)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        call()                                            # warm-up
        secs = [call() for _ in range(reps)]
        rates = [sweeps * model.N * B / t for t in secs]
        print(json.dumps({
            "root": root, "path": label, "chains": B, "sweeps": sweeps,
            "seconds": secs, "rates": rates,
            "median_rate": statistics.median(rates),
            "rate_unit": "attempted flips*chains/s", "card": card}),
            flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--paths", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_sweep_timing: no CUDA device is visible",
              file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.bench import card_line
    from rrrmc_tpu_torch.ops import cuda_build
    from rrrmc_tpu_torch.ops.launch import PLANS

    assert os.path.dirname(os.path.dirname(rt.__file__)) == root, rt.__file__
    cuda_build.library()
    card = card_line()
    if args.paths:
        time_paths(torch, rt, root, card, args.reps)
        print(card)
        return 0
    for row, label, build, B, beta, sweeps, warm in CASES:
        model = build(rt)
        state, launch, kernel = sweeper(torch, rt, model, B, beta)
        for w in (0, warm):
            start = [t.clone() for t in state]
            if w:
                launch(start, w, 0)
            torch.cuda.synchronize()
            check = [float(start[0].double().sum()),
                     float(start[2].double().sum())]

            def once():
                a = [t.clone() for t in start]
                return events_ms(torch, lambda: launch(a, sweeps, w))

            once()                                        # warm-up
            ms = [once() for _ in range(args.reps)]
            plan = PLANS.get(kernel)
            print(json.dumps({
                "root": root, "row": row, "case": label, "chains": B,
                "sweeps": sweeps, "warm_sweeps": w, "state": check,
                "ms": ms, "median_ms": statistics.median(ms),
                "plan": dict(plan) if plan else None, "card": card}),
                flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
