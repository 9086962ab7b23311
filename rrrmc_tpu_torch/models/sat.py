"""Random K-SAT model, batch-explicit: energy = number of violated clauses.

The JAX package's rrrmc_tpu/models/sat.py (the reference's graphs/SAT.jl):

* clause-major:  A [Mc, K] var ids (pad N), L [Mc, K] literal signs +-1 (pad 0)
* var-major:     T [N, Cmax] clause ids (pad Mc), TL [N, Cmax] literal signs

aux = the satisfied counts [B, Mc] int32 (# literals of each clause that the
spins satisfy; a padded clause entry counts as satisfied, as in the JAX
model). A flip of variable i moves the counts of its clauses by
-sigma_i * TL[i], an O(Cmax) masked scatter-add (`flip_counts`);
dE_i = #{a : i the sole satisfier of a} - #{a : i in a, a violated}, gathered
over i's clauses (`delta_from_counts`). The race and EO kernels' plain
versions share both functions. Energies are exact int32; allDeltaE =
0..max_conn (SAT.jl:325).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.model import Model, default_device, flip_spin


def delta_from_counts(T: torch.Tensor, TL: torch.Tensor, sig: torch.Tensor,
                      sat: torch.Tensor) -> torch.Tensor:
    """[B, N] int32 energy changes of flipping each variable, from the spins
    sig [B, N] and the satisfied counts sat [B, Mc]: per clause slot of the
    variable, +1 where it is the clause's sole satisfier and -1 where the
    clause is violated (padded slots read the count 2 and add nothing; a
    literal sign 0 adds nothing, as in the JAX model)."""
    B = sig.shape[0]
    ext = torch.cat([sat.to(torch.int32),
                     torch.full((B, 1), 2, dtype=torch.int32,
                                device=sat.device)], dim=1)
    s = ext[:, T.long()]                                # [B, N, Cmax]
    m = sig.to(torch.int32)[:, :, None] == TL
    return ((m & (s == 1)).to(torch.int32)
            - ((s == 0) & (TL != 0)).to(torch.int32)).sum(-1,
                                                          dtype=torch.int32)


def flip_counts(T: torch.Tensor, TL: torch.Tensor, sat: torch.Tensor,
                i: torch.Tensor, new_spin: torch.Tensor, do: torch.Tensor):
    """Move the satisfied counts sat [B, Mc] of variable i[b]'s clauses by
    new_spin[b] * TL[i[b]] in place, in the chains where do (padded slots
    carry the sign 0)."""
    Mc = sat.shape[1]
    if Mc == 0:
        return sat
    upd = new_spin.to(torch.int32)[:, None] * TL[i]
    upd = torch.where(do[:, None], upd, torch.zeros_like(upd))
    sat.scatter_add_(1, T[i].clamp(max=Mc - 1).long(), upd)
    return sat


@dataclasses.dataclass(frozen=True, eq=False)
class SATModel(Model):
    A: torch.Tensor    # [Mc, K] int32 var ids, padded with N
    L: torch.Tensor    # [Mc, K] int32 literal signs (+-1), 0 on padding
    T: torch.Tensor    # [N, Cmax] int32 clause ids, padded with Mc
    TL: torch.Tensor   # [N, Cmax] int32 literal signs, 0 on padding
    N: int
    Mc: int
    K: int
    Cmax: int
    max_conn: int
    scale: float = 1.0

    @property
    def device(self) -> torch.device:
        return self.A.device

    def _sat_counts(self, sigma: torch.Tensor) -> torch.Tensor:
        B = sigma.shape[0]
        se = torch.cat([sigma.to(torch.int32),
                        torch.zeros((B, 1), dtype=torch.int32,
                                    device=sigma.device)], dim=1)
        return (se[:, self.A.long()] == self.L).sum(-1, dtype=torch.int32)

    def energy(self, sigma: torch.Tensor) -> torch.Tensor:
        return (self._sat_counts(sigma) == 0).sum(-1, dtype=torch.int32)

    def init_aux(self, sigma):
        return self._sat_counts(sigma)

    def delta_all(self, sigma, aux):
        """dE_i = #{a : i sole satisfier of a} - #{a : i in a, a violated}
        (the lfields of SAT.jl:213-225)."""
        return delta_from_counts(self.T, self.TL, sigma, aux)

    def delta_one(self, sigma, aux, i):
        B = sigma.shape[0]
        rows = torch.arange(B, device=sigma.device)
        ext = torch.cat([aux, torch.zeros((B, 1), dtype=aux.dtype,
                                          device=aux.device)], dim=1)
        sat_c = ext.gather(1, self.T[i].clamp(max=self.Mc).long())
        tl = self.TL[i]
        m = sigma[rows, i].to(torch.int32)[:, None] == tl
        d = ((m & (sat_c == 1)).to(torch.int32)
             - ((~m) & (sat_c == 0) & (tl != 0)).to(torch.int32))
        return d.sum(-1, dtype=torch.int32)

    def flip(self, sigma, aux, i, do):
        rows = torch.arange(sigma.shape[0], device=sigma.device)
        flip_counts(self.T, self.TL, aux, i, -sigma[rows, i], do)
        flip_spin(sigma, i, do)
        return sigma, aux

    def delta_classes(self):
        return tuple(float(x) for x in range(self.max_conn + 1))

    def var_neighb(self):
        """Per-variable neighbourhood (vars sharing a clause; SAT.jl:99-107),
        as ragged python lists."""
        A = self.A.cpu().numpy()
        neighb = [set() for _ in range(self.N)]
        for a in range(self.Mc):
            row = [int(v) for v in A[a] if v < self.N]
            for x in row:
                for y in row:
                    if x != y:
                        neighb[x].add(y)
        return [sorted(s) for s in neighb]


def GraphSAT(N: int, K: int, alpha: float, *, seed=None,
             device=None) -> SATModel:
    """Random K-SAT with round(alpha*N) clauses of K distinct vars and random
    literal signs (gen_randomKSAT, SAT.jl:42-56): the JAX builder's draws, in
    its order. The tables go to `device`, CUDA when none is given."""
    assert N > 0 and K > 0 and alpha >= 0 and N >= K
    rng = np.random.default_rng(seed)
    Mc = int(round(alpha * N))
    A = np.empty((Mc, K), dtype=np.int32)
    for a in range(Mc):
        A[a] = rng.choice(N, size=K, replace=False)
    L = rng.choice([-1, 1], size=(Mc, K)).astype(np.int32)
    return make_sat(N, A, L, device=device)


def make_sat(N: int, A, L, *, device=None) -> SATModel:
    """Build from explicit clause arrays: A [Mc, K] var ids (N pads), L
    [Mc, K] literal signs (+1: satisfied by sigma=+1). Each variable's
    clause slots follow the clauses' order, as in the JAX builder."""
    A = np.asarray(A, dtype=np.int32)
    L = np.asarray(L, dtype=np.int32)
    Mc, K = A.shape
    flat, lit = A.reshape(-1), L.reshape(-1)
    clause = np.repeat(np.arange(Mc, dtype=np.int32), K)
    ok = flat < N
    flat, lit, clause = flat[ok], lit[ok], clause[ok]
    counts = np.bincount(flat, minlength=N)
    Cmax = max(int(counts.max(initial=0)), 1)
    order = np.argsort(flat, kind="stable")             # (clause, k) order
    v = flat[order]
    slot = np.arange(len(v)) - (np.cumsum(counts) - counts)[v]
    T = np.full((N, Cmax), Mc, dtype=np.int32)
    TL = np.zeros((N, Cmax), dtype=np.int32)
    T[v, slot] = clause[order]
    TL[v, slot] = lit[order]
    device = default_device(device)

    def put(a):
        return torch.tensor(a, device=device)

    return SATModel(A=put(A), L=put(L), T=put(T), TL=put(TL), N=N, Mc=Mc,
                    K=K, Cmax=Cmax, max_conn=int(counts.max(initial=0)))


def export_cnf(X: SATModel, filename: str, decimate=None):
    """DIMACS CNF export (SAT.jl:129-140); with `decimate` (a list of
    1-based signed variables assumed fixed) performs unit propagation before
    writing, mirroring SAT.jl:142-187: satisfied clauses drop, falsified
    literals are removed, clauses reduced to units join the decimation list
    (contradictions raise)."""
    A = X.A.cpu().numpy()
    L = X.L.cpu().numpy()
    clauses = [[(int(A[a, k]), int(L[a, k])) for k in range(A.shape[1])
                if A[a, k] < X.N] for a in range(X.Mc)]
    decimate = list(dict.fromkeys(decimate)) if decimate else []  # dedupe
    if decimate:
        if any(-v in decimate for v in decimate):
            raise ValueError("contradiction in decimation list")
        T = [[] for _ in range(X.N)]
        for a, cl in enumerate(clauses):
            for i, _ in cl:
                T[i].append(a)
        j = 0
        while j < len(decimate):
            v = decimate[j]
            s, i = (1 if v > 0 else -1), abs(v) - 1
            for a in T[i]:
                cl = clauses[a]
                if not cl:
                    continue
                k = next(kk for kk, (ii, _) in enumerate(cl) if ii == i)
                if cl[k][1] == s:
                    clauses[a] = []          # clause satisfied
                else:
                    if len(cl) == 1:
                        raise ValueError("contradiction during decimation")
                    del cl[k]
                    if len(cl) == 1:
                        newv = (cl[0][0] + 1) * cl[0][1]
                        if -newv in decimate:
                            raise ValueError("contradiction during decimation")
                        if newv not in decimate:
                            decimate.append(newv)
                        clauses[a] = []      # emitted as a unit below
            T[i] = []
            j += 1
    n_out = sum(1 for cl in clauses if cl) + len(decimate)
    with open(filename, "w") as f:
        f.write(f"p cnf {X.N} {n_out}\n")
        for cl in clauses:
            if cl:
                f.write(" ".join(str(s * (i + 1)) for i, s in cl) + " 0\n")
        for v in decimate:
            f.write(f"{v} 0\n")


# --- replica-ensemble aliases (REAliases.jl, LEAliases.jl, TLEAliases.jl) --

def GraphSATRE(N, K, alpha, M, gamma, beta, *, seed=None, device=None):
    from .replicas import GraphRobustEnsemble
    return GraphRobustEnsemble(N, M, gamma, beta,
                               GraphSAT(N, K, alpha, seed=seed, device=device))


def GraphSATLE(N, K, alpha, M, gamma, beta, *, seed=None, device=None):
    from .replicas import GraphLocalEntropy
    return GraphLocalEntropy(N, M, gamma, beta,
                             GraphSAT(N, K, alpha, seed=seed, device=device))


def GraphSATTLE(N, K, alpha, M, gamma, lambda_, beta, *, seed=None,
                device=None):
    """The topological neighbourhood is the variables sharing a clause."""
    from .replicas import GraphTopologicalLocalEntropy
    base = GraphSAT(N, K, alpha, seed=seed, device=device)
    return GraphTopologicalLocalEntropy(N, M, gamma, lambda_, beta, base,
                                        neighb=base.var_neighb())
