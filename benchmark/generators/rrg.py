"""A random K-regular graph with couplings drawn from the levels, from a
seed: the pairing model with restarts (RRRMC.jl's `gen_RRG`, as the JAX
package and the port draw it, here vectorised in NumPy and frozen), one
coupling an undirected edge.

`make` gives plain arrays, which the reference reads; `to_program` hands the
same arrays to the port through `rrrmc_tpu_torch.convert`.
"""

from __future__ import annotations

import numpy as np


def edges(N: int, K: int, rng: np.random.Generator):
    """(lo, hi) [N K / 2] of a simple K-regular graph: stubs paired at
    random, the pairing drawn again until it has no self-loop and no
    double edge."""
    if (N * K) % 2:
        raise ValueError("N * K must be even")
    for _ in range(10_000):
        stubs = rng.permutation(np.repeat(np.arange(N, dtype=np.int64), K))
        a, b = stubs[0::2], stubs[1::2]
        if np.any(a == b):
            continue
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        if np.unique(lo * N + hi).size == lo.size:
            return lo, hi
    raise RuntimeError(f"no simple {K}-regular graph drawn on {N} sites")


def neighbour_table(N: int, K: int, lo, hi, J):
    """[N, K] neighbours and couplings of each site, from the edge list."""
    src = np.concatenate([lo, hi])
    dst = np.concatenate([hi, lo])
    jj = np.concatenate([J, J])
    order = np.argsort(src, kind="stable")
    if not np.array_equal(np.bincount(src, minlength=N), np.full(N, K)):
        raise ValueError("not a K-regular edge list")
    return (dst[order].reshape(N, K).astype(np.int32),
            jj[order].reshape(N, K).astype(np.int32))


def make(cfg: dict, rng: np.random.Generator) -> dict:
    N, K = int(cfg["N"]), int(cfg["K"])
    lo, hi = edges(N, K, rng)
    J = rng.choice(np.asarray(cfg["levels"], dtype=np.int32), size=lo.size)
    neigh, Jt = neighbour_table(N, K, lo, hi, J)
    return {"N": N, "K": K, "neigh": neigh, "J": Jt,
            "levels": list(cfg["levels"])}


def to_program(arrays: dict, device):
    """The port's Pairwise on `device`, with the pair classes that
    `GraphRRG` gives the same levels."""
    import rrrmc_tpu_torch as pt

    N, K = arrays["N"], arrays["K"]
    return pt.pairwise_from_arrays(
        arrays["neigh"], arrays["J"], np.zeros(N, dtype=np.int32),
        np.int32(0), N=N, K=K, scale=1.0,
        classes=pt.enumerate_pair_classes(
            [float(x) for x in arrays["levels"]], K),
        device=device)
