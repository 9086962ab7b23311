"""The plain reference of random K-SAT: the energy is the number of violated
clauses, read from the benchmark's own clause arrays (generators/sat.py:
A [Mc, K] variables, L [Mc, K] literal signs, +1 satisfied by a spin +1):
each clause's satisfied literals, the energies, the energy change of
flipping each variable and the Metropolis acceptance sum z, worked out
again from the spins alone.

Plain PyTorch in int64 (float64 for z), in blocks of rows so that it fits
beside what the run left on the card. It imports nothing of the program:
the per-variable tables are built here from A alone.
"""

from __future__ import annotations

import numpy as np
import torch

#: chains a block of rows: the [rows, N, slots] int64 gathers of `delta`
#: stay under 0.4 GB at N = 10^4, alpha = 4.2
ROWS = 128


class Tables:
    """The clauses on `device` as int64, and from them, for each variable,
    its clause slots (`slot_c` its clauses, `slot_l` its literal signs,
    padded with the clause Mc, which counts 2 and holds no literal) and the
    other variables of those clauses (`e_*`, one entry a clause and ordered
    pair of its variables; `p_i`, `p_j` the distinct pairs)."""

    def __init__(self, arrays: dict, device):
        A = np.asarray(arrays["A"], dtype=np.int64)
        L = np.asarray(arrays["L"], dtype=np.int64)
        self.N, self.K, self.Mc = int(arrays["N"]), A.shape[1], A.shape[0]
        N, K, Mc = self.N, self.K, self.Mc
        self.A = torch.as_tensor(A, device=device)
        self.L = torch.as_tensor(L, device=device)
        # one entry (variable, clause, its sign) per literal, by variable
        var, cl = A.reshape(-1), np.repeat(np.arange(Mc), K)
        lit = L.reshape(-1)
        order = np.argsort(var, kind="stable")
        var, cl, lit = var[order], cl[order], lit[order]
        deg = np.bincount(var, minlength=N)
        slot = np.arange(var.size) - np.repeat(np.cumsum(deg) - deg, deg)
        width = max(int(deg.max(initial=0)), 1)
        sc = np.full((N, width), Mc, dtype=np.int64)
        sl = np.zeros((N, width), dtype=np.int64)
        sc[var, slot], sl[var, slot] = cl, lit
        self.slot_c = torch.as_tensor(sc, device=device)
        self.slot_l = torch.as_tensor(sl, device=device)
        # one entry (i, clause a, its other variable j) per ordered pair of
        # distinct literals of a clause; `pair` numbers the distinct (i, j)
        ki, kj = np.nonzero(~np.eye(K, dtype=bool))
        ei = A[:, ki].reshape(-1)
        ej = A[:, kj].reshape(-1)
        ea = np.repeat(np.arange(Mc), ki.size)
        key, pair = np.unique(ei * N + ej, return_inverse=True)
        t = lambda a: torch.as_tensor(a, device=device)     # noqa: E731
        self.e_i, self.e_j, self.e_a = t(ei), t(ej), t(ea)
        self.e_li = t(L[:, ki].reshape(-1))
        self.e_lj = t(L[:, kj].reshape(-1))
        self.e_pair = t(pair.reshape(-1))
        self.p_i, self.p_j = t(key // N), t(key % N)


def _rows(sigma: torch.Tensor):
    for lo in range(0, sigma.shape[0], ROWS):
        yield sigma[lo:lo + ROWS].long()


def _counts(tab: Tables, s: torch.Tensor) -> torch.Tensor:
    """[b, Mc] satisfied literals of each clause."""
    return (s[:, tab.A] == tab.L).sum(-1)


def delta_counts(tab: Tables, s: torch.Tensor, c: torch.Tensor
                 ) -> torch.Tensor:
    """[b, N] energy changes of flipping each variable of the spins s,
    from their counts c [b, Mc]: +1 for each clause the variable alone
    satisfies, -1 for each violated clause it is in."""
    ce = torch.cat([c, torch.full_like(c[:, :1], 2)], 1)[:, tab.slot_c]
    sat = s[:, :, None] == tab.slot_l
    return ((ce == 1) & sat).sum(-1) - (ce == 0).sum(-1)


def fields(tab: Tables, sigma: torch.Tensor) -> torch.Tensor:
    """[B, Mc] int64 satisfied literals of each clause (the program's aux
    of a SATModel)."""
    return torch.cat([_counts(tab, s) for s in _rows(sigma)])


def energy(tab: Tables, sigma: torch.Tensor) -> torch.Tensor:
    """[B] int64 violated clauses."""
    return torch.cat([(_counts(tab, s) == 0).sum(-1) for s in _rows(sigma)])


def delta(tab: Tables, sigma: torch.Tensor) -> torch.Tensor:
    """[B, N] int64 energy changes of flipping each variable."""
    return torch.cat([delta_counts(tab, s, _counts(tab, s))
                      for s in _rows(sigma)])


def _w(dE: torch.Tensor, beta: float) -> torch.Tensor:
    return torch.exp(-beta * dE.clamp(min=0).double())


def z(tab: Tables, sigma: torch.Tensor, beta: float) -> torch.Tensor:
    """[B] float64 sum_i min(1, exp(-beta dE_i)): N times the probability
    that a Metropolis proposal of a uniform variable is accepted."""
    return torch.cat([_w(delta_counts(tab, s, _counts(tab, s)), beta).sum(-1)
                      for s in _rows(sigma)])


def _term(c: torch.Tensor, sat: torch.Tensor) -> torch.Tensor:
    """A clause's term in the dE of one of its variables: +1 where the
    variable is its sole satisfier, -1 where it is violated."""
    return ((c == 1) & sat).long() - (c == 0).long()


def z_flipped(tab: Tables, sigma: torch.Tensor, beta: float) -> torch.Tensor:
    """[B, N] float64: z of each chain's spins with variable i flipped.
    The flip turns dE_i into -dE_i and moves the count of each clause a of
    i by one, which changes the term of a in the dE of each other variable
    j of a; the changes of a j that shares several clauses with i are
    summed before its weight is taken again."""
    out = []
    for s in _rows(sigma):
        c = _counts(tab, s)
        d = delta_counts(tab, s, c)
        z0 = _w(d, beta).sum(-1, keepdim=True)
        ca = c[:, tab.e_a]
        c2 = ca + torch.where(s[:, tab.e_i] == tab.e_li, -1, 1)
        sj = s[:, tab.e_j] == tab.e_lj
        moved = torch.zeros((s.shape[0], tab.p_i.numel()), dtype=torch.long,
                            device=s.device)
        moved.index_add_(1, tab.e_pair, _term(c2, sj) - _term(ca, sj))
        dj = d[:, tab.p_j]
        change = torch.zeros_like(d, dtype=torch.float64)
        change.index_add_(1, tab.p_i, _w(dj + moved, beta) - _w(dj, beta))
        out.append(z0 - _w(d, beta) + _w(-d, beta) + change)
    return torch.cat(out)
