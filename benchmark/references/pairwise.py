"""The plain reference of a pairwise Ising model, sum over edges of
-J_ij s_i s_j, read from the benchmark's own [N, K] neighbour and coupling
tables (generators/*.py): local fields, energies and the Metropolis
acceptance sum z, worked out again from the spins alone.

Plain PyTorch in int64 (float64 for z), in blocks of rows so that it fits
beside what the run left on the card. It imports nothing of the program.
"""

from __future__ import annotations

import torch

#: chains a block of rows: [rows, N, K] int64 gathers stay under 1 GB at
#: N = 10^4
ROWS = 1024


class Tables:
    """The neighbour table and couplings on `device`, as int64."""

    def __init__(self, arrays: dict, device):
        self.N, self.K = int(arrays["N"]), int(arrays["K"])
        self.neigh = torch.as_tensor(arrays["neigh"], device=device).long()
        self.J = torch.as_tensor(arrays["J"], device=device).long()


def _rows(sigma: torch.Tensor):
    for lo in range(0, sigma.shape[0], ROWS):
        yield sigma[lo:lo + ROWS].long()


def fields(tab: Tables, sigma: torch.Tensor) -> torch.Tensor:
    """[B, N] int64 local fields h_i = sum_k J_ik s_(neigh_ik)."""
    return torch.cat([(s[:, tab.neigh] * tab.J).sum(-1) for s in
                      _rows(sigma)])


def energy(tab: Tables, sigma: torch.Tensor) -> torch.Tensor:
    """[B] int64 energies -1/2 sum_i s_i h_i (each edge once)."""
    out = []
    for s in _rows(sigma):
        pair = (s * (s[:, tab.neigh] * tab.J).sum(-1)).sum(-1)
        if bool((pair % 2 != 0).any()):
            raise ValueError("an odd pair sum: the table is not symmetric")
        out.append(-(pair // 2))
    return torch.cat(out)


def delta(tab: Tables, sigma: torch.Tensor) -> torch.Tensor:
    """[B, N] int64 energy changes 2 s_i h_i of flipping each site."""
    return 2 * sigma.long() * fields(tab, sigma)


def z(tab: Tables, sigma: torch.Tensor, beta: float) -> torch.Tensor:
    """[B] float64 sum_i min(1, exp(-beta dE_i)): N times the probability
    that a Metropolis proposal of a uniform site is accepted."""
    out = []
    for s in _rows(sigma):
        h = (s[:, tab.neigh] * tab.J).sum(-1)
        dE = (2 * s * h).double()
        out.append(torch.exp(-beta * dE.clamp(min=0)).sum(-1))
    return torch.cat(out)


def z_flipped(tab: Tables, sigma: torch.Tensor, beta: float) -> torch.Tensor:
    """[B, N] float64: z of each chain's spins with site i flipped, from
    the change of the weights of i and of its K neighbours (a simple
    graph: no site is its own neighbour or twice another's)."""
    out = []
    for s in _rows(sigma):
        h = (s[:, tab.neigh] * tab.J).sum(-1)

        def w(dE):
            return torch.exp(-beta * dE.clamp(min=0).double())

        d = 2 * s * h                                   # [b, N]
        z0 = w(d).sum(-1, keepdim=True)
        dn = d[:, tab.neigh]                            # [b, N, K]
        sn = s[:, tab.neigh]
        dn2 = dn - 4 * sn * tab.J * s[:, :, None]       # after flipping i
        out.append(z0 - w(d) + w(-d) + (w(dn2) - w(dn)).sum(-1))
    return torch.cat(out)
