"""Work floor of the K-SAT race kernel (csrc/rejfree_sat.cu, with sat.cuh
and race.cuh) running BKL over the window.

Operations: a move applies one flip, which needs at least one random draw
(the variable's; the skip's is not counted), the flipped spin and its
energy, one count update for each clause of the variable and one dE update
for each other variable of those clauses: 3 + d + d (K - 1) at the
formula's mean degree d = K Mc / N (from A). The iterations a move stands
for, the race's passes over the N variables, Philox rounds and the z sums
are not counted, as for the sparse race.
Bytes: each block reads and writes its chains' int8 spins once, their
energy and flip counter (4 bytes each); each launch reads and writes the
[B, Mc] int32 satisfied counts once and reads the int32 clause tables
A, L [Mc, K] and the variables' tables T, TL once, at one entry a literal
(K Mc each, no padding).
"""

KERNELS = r"rejfree_sat_kernel"


def floor(ctx):
    run, w = ctx["run"], ctx["work"]
    N, K, A = run.arrays["N"], run.arrays["K"], run.arrays["A"]
    Mc = len(A)
    B = int(run.traffic["chains"])
    if w.get("moves") is None:
        return None
    slots = int((A < N).sum())
    ops = w["moves"] * (3 * N + K * slots) // N
    launches = ctx["trace"].kernel_count(KERNELS)
    nbytes = (ctx["blocks"] * (2 * B * N + 16 * B)
              + launches * (8 * B * Mc + 16 * K * Mc))
    return {"ops": ops, "bytes": nbytes}
