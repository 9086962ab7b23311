#!/usr/bin/env python3
"""Time the race kernels of the PyTorch + CUDA port on their kernel-table
cases (PERF.md section 6, rows 2, 4, 5, 6, 7, 14, 16, 17 and 19; row 6 on
its two cases, row 19 on step, its case, and on xentr), for the
rrrmc_tpu_torch package under --root, so that two trees are timed in one
call on one card:

    python3 scripts/torch_race_timing.py --root DIR [--sweep] [--reps 3]
        [--rows 17,19]

Each case is chip_smoke.py's row case: B chains from init_state(seed=167),
one chunk of 1024 moves through the model family's race wrapper, timed with
CUDA events: first with a target no chain reaches (every chain active),
then with the target at the median coordinate of that launch (about half
the chains stop mid-chunk: the row's time). bkl and rrr each; --reps
launches of each, all printed. --sweep also times the fused race kernels at
every block size they are built for (ops/rejfree.py's FUSED_THREADS,
pinned by `pinned_threads`, which --sweep needs in the tree), and the
crossover cases: K-SAT and the step perceptron at 128 chains with 4-12
sites a thread at 512 threads, between the rows' 2 and 15-20, where the
launch rule's MIN_SITES_PER_THREAD falls. Prints one JSON line per case
and the card's name and power limit; exits 1 without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

SEED = 167
MOVES = 1024
#: (row, label, builder, chains, beta)
CASES = (
    (2, "GraphRRG(10^4, 3) +-J", lambda rt: rt.GraphRRG(
        10_000, 3, (-1, 1), seed=SEED, device="cuda"), 1024, 2.0),
    (4, "GraphEA(16, 3) +-J", lambda rt: rt.GraphEA(
        16, 3, (-1, 1), seed=42, device="cuda"), 1024, 2.0),
    (5, "GraphSK(1024)", lambda rt: rt.GraphSK(
        1024, seed=4, device="cuda"), 1024, 4.0),
    (6, "densify(GraphRRG(10^4, 3))", lambda rt: rt.densify(rt.GraphRRG(
        10_000, 3, (-1, 1), seed=7, device="cuda")), 1024, 4.0),
    (6, "GraphSKNormal(4096)", lambda rt: rt.GraphSKNormal(
        4096, seed=4, device="cuda"), 128, 4.0),
    (7, "GraphPSpin3(7500, 3)", lambda rt: rt.GraphPSpin3(
        7500, 3, seed=7, device="cuda"), 128, 1.5),
    (14, "GraphQSKT(1024, 16)", lambda rt: rt.GraphQSKT(
        1024, 16, 0.3, 2.0, seed=8370274, device="cuda"), 1024, 2.0),
    (16, "Quant(GraphRRG(1000, 3), M=8)", lambda rt: rt.GraphQuant(
        1000, 8, 1.0, 1.0, rt.GraphRRG(1000, 3, (-1, 1), seed=11,
                                       device="cuda")), 128, 1.0),
    (17, "GraphSAT(10^4, 3, 4.2)", lambda rt: rt.GraphSAT(
        10_000, 3, 4.2, seed=SEED, device="cuda"), 128, 4.0),
    (19, "GraphPercStep(1023, 511)", lambda rt: rt.GraphPercStep(
        1023, 511, seed=5, device="cuda"), 256, 1.0),
    (19, "GraphPercXEntr(1023, 511)", lambda rt: rt.GraphPercXEntr(
        1023, 511, 1.0, seed=5, device="cuda"), 256, 1.0),
)
#: --sweep only: (label, builder, chains, beta) with 4-12 sites a thread at
#: 512 threads, the patterns' bits in shared memory
CROSSOVER = tuple(
    (f"GraphSAT({n}, 3, 4.2)", lambda rt, n=n: rt.GraphSAT(
        n, 3, 4.2, seed=SEED, device="cuda"), 128, 4.0)
    for n in (3000, 4096, 6000)) + tuple(
    (f"GraphPercStep({n}, {p})", lambda rt, n=n, p=p: rt.GraphPercStep(
        n, p, seed=5, device="cuda"), 128, 1.0)
    for n, p in ((2047, 255), (4095, 127)))


def events_ms(torch, fn) -> float:
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def time_case(torch, rt, model, B, beta, mode, reps, threads=None):
    """(ms with every chain active, ms with half stopping) lists."""
    from rrrmc_tpu_torch.ops.rejfree import coord_dtype
    from rrrmc_tpu_torch.samplers.families import family_of, resident_state

    fam = family_of(model)
    tables = fam.tables(model)
    st = rt.init_state(model, B, seed=SEED, device="cuda")
    lf, E = resident_state(fam, model, st.sigma, st.E)
    ct = coord_dtype(mode)
    base = dict(sigma=st.sigma, lf=lf, E=E,
                coord=torch.zeros(B, dtype=ct, device="cuda"),
                acc=torch.zeros(B, dtype=torch.int32, device="cuda"),
                zacc=torch.zeros(B, dtype=torch.float32, device="cuda"))
    kw = dict(mode=mode, n_moves=MOVES, seed=SEED, beta_s=beta * model.scale)
    # the family's bound on the resident fields (a tree before the fused
    # kernels has none)
    kw.update(getattr(fam, "race_kw", lambda m: {})(model))
    rejfree = sys.modules["rrrmc_tpu_torch.ops.rejfree"]
    pin = contextlib.nullcontext() if threads is None else \
        rejfree.pinned_threads(threads)

    def run(target):
        a = {k: v.clone() for k, v in base.items()}
        ms = events_ms(torch, lambda: fam.race(
            a["sigma"], a["lf"], a["E"], a["coord"], a["acc"], a["zacc"],
            *tables, target=target, **kw))
        return ms, a

    with pin:
        unreachable = 2 ** 30
        run(unreachable)                              # warm-up
        full = [run(unreachable)[0] for _ in range(reps)]
        _, probe = run(unreachable)
        target = max(int(probe["coord"].double().median().item()), 1) \
            if mode == "bkl" else MOVES // 2
        half = [run(target)[0] for _ in range(reps)]
    return full, half


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rows", default="",
                    help="comma-separated rows to time (default: all)")
    args = ap.parse_args()
    rows = {int(r) for r in args.rows.split(",") if r}
    import torch

    if not torch.cuda.is_available():
        print("torch_race_timing: no CUDA device is visible", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.bench import card_line
    from rrrmc_tpu_torch.ops import cuda_build, launch

    assert os.path.dirname(os.path.dirname(rt.__file__)) == root, rt.__file__
    cuda_build.library()
    card = card_line()
    rejfree = sys.modules["rrrmc_tpu_torch.ops.rejfree"]
    if args.sweep and not hasattr(rejfree, "pinned_threads"):
        print("torch_race_timing: --sweep needs ops/rejfree.py's "
              "pinned_threads in the tree", file=sys.stderr)
        return 1
    cases = CASES + (tuple((None,) + c for c in CROSSOVER)
                     if args.sweep else ())
    for row, label, build, B, beta in cases:
        if rows and row not in rows:
            continue
        model = build(rt)
        sizes = [None] + (list(rejfree.FUSED_THREADS) if args.sweep else [])
        for mode in ("bkl", "rrr"):
            for threads in sizes:
                launch.PLANS.clear()
                full, half = time_case(torch, rt, model, B, beta, mode,
                                       args.reps, threads)
                plan = next(iter(launch.PLANS.values()), None)
                print(json.dumps({
                    "root": root, "row": row, "case": label, "chains": B,
                    "mode": mode, "moves": MOVES, "threads": threads,
                    "ms_half_stopping": half, "ms_every_chain": full,
                    "plan": plan, "card": card}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
