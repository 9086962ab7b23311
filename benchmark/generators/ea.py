"""An Edwards-Anderson lattice, periodic, L^D sites, with couplings drawn
from the levels, from a seed (RRRMC.jl's `GraphEA`; the JAX package's and
the port's draw: `rng.choice(levels, size=(D,) + (L,) * D)`).

Jd[d][x] couples site x to x + e_d (sites in C order of their D
coordinates). `make` also writes the lattice as a plain [N, 2D] neighbour
table, which the reference reads; `to_program` hands Jd to the port through
`rrrmc_tpu_torch.convert.lattice_from_arrays`.
"""

from __future__ import annotations

import numpy as np


def neighbour_table(L: int, D: int, Jd: np.ndarray):
    """[N, 2D] neighbours and couplings: x + e_d with Jd[d][x], and
    x - e_d with Jd[d][x - e_d], for each direction d."""
    N = L ** D
    idx = np.arange(N).reshape((L,) * D)
    neigh, J = [], []
    for d in range(D):
        up = np.roll(idx, -1, axis=d)          # x + e_d
        down = np.roll(idx, 1, axis=d)         # x - e_d
        neigh += [up.ravel(), down.ravel()]
        J += [Jd[d].ravel(), np.roll(Jd[d], 1, axis=d).ravel()]
    return (np.stack(neigh, 1).astype(np.int32),
            np.stack(J, 1).astype(np.int32))


def make(cfg: dict, rng: np.random.Generator) -> dict:
    L, D = int(cfg["L"]), int(cfg["D"])
    Jd = rng.choice(np.asarray(cfg["levels"], dtype=np.int32),
                    size=(D,) + (L,) * D)
    neigh, J = neighbour_table(L, D, Jd)
    return {"N": L ** D, "K": 2 * D, "L": L, "D": D, "Jd": Jd,
            "neigh": neigh, "J": J, "levels": list(cfg["levels"])}


def to_program(arrays: dict, device):
    """The port's LatticeEA on `device`, with the pair classes that
    `GraphEA` gives the same levels."""
    import rrrmc_tpu_torch as pt

    L, D = arrays["L"], arrays["D"]
    return pt.lattice_from_arrays(
        arrays["Jd"], np.zeros(L ** D, dtype=np.int32), L, D, 1.0,
        classes=pt.enumerate_pair_classes(
            [float(x) for x in arrays["levels"]], 2 * D),
        device=device)
