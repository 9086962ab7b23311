"""A random K-SAT formula from a seed: round(alpha N) clauses, each of K
distinct variables drawn uniformly and K literal signs +-1 with equal odds
(RRRMC.jl's `gen_randomKSAT`, SAT.jl:42-56), vectorised in NumPy: the
clauses are drawn as one [Mc, K] array, and the rows that repeat a
variable are drawn again until none does. The formula's law is
`GraphSAT`'s; its draw order is not.

`make` gives plain arrays, which the reference reads; `to_program` hands the
same arrays to the port through `rrrmc_tpu_torch.make_sat`.
"""

from __future__ import annotations

import numpy as np


def clauses(N: int, K: int, Mc: int, rng: np.random.Generator):
    """[Mc, K] int32 variables, K distinct ones a clause, each clause
    uniform over the ordered K-tuples of distinct variables."""
    if not 0 < K <= N:
        raise ValueError(f"K = {K} distinct variables of N = {N}")
    A = rng.integers(0, N, size=(Mc, K), dtype=np.int64)
    while True:
        srt = np.sort(A, axis=1)
        bad = np.nonzero((srt[:, 1:] == srt[:, :-1]).any(axis=1))[0]
        if bad.size == 0:
            return A.astype(np.int32)
        A[bad] = rng.integers(0, N, size=(bad.size, K), dtype=np.int64)


def make(cfg: dict, rng: np.random.Generator) -> dict:
    N, K = int(cfg["N"]), int(cfg["K"])
    Mc = int(round(float(cfg["alpha"]) * N))
    A = clauses(N, K, Mc, rng)
    L = (2 * rng.integers(0, 2, size=(Mc, K)) - 1).astype(np.int32)
    return {"N": N, "K": K, "Mc": Mc, "A": A, "L": L}


def to_program(arrays: dict, device):
    """The port's SATModel on `device`."""
    import rrrmc_tpu_torch as pt

    return pt.make_sat(arrays["N"], arrays["A"], arrays["L"], device=device)
