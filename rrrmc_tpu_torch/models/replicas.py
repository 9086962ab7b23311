"""Replica-ensemble wrappers (the JAX package's rrrmc_tpu/models/replicas.py,
Quant and RE), batch-explicit: the quantum Suzuki-Trotter model
(`GraphQuant`, the reference's QT.jl) and the robust ensemble
(`GraphRobustEnsemble`, RE.jl).

M replicas of one base model on Nk spins form one composite of N = Nk * M
spins in the JAX package's REPLICA-MAJOR layout: spin (i, k) is i + k * Nk,
replica k the contiguous block [k * Nk, (k + 1) * Nk). For the robust
ensemble this deviates from the reference's site-major layout, as the JAX
package does; the converters to the reference layout come with the rest of
the replica models. Every replica shares the base model's disorder (the
reference's aliases pass one generated instance to all replicas).

Batch-explicit: a [B, N] batch of composites is a [B * M, Nk] batch of base
configurations (a view of the same memory), so the base model's own batched
methods serve every replica at once and its aux is batched on axis 0 as
[B * M, ...]. Energies are physical floats.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.dtypes import ftype
from ..core.model import Model, flip_spin
from .composite import Double
from .pairwise import Pairwise, make_pairwise

MAXDIGITS = 8  # fourK is rounded to 8 decimal digits (the reference's QT.jl)


def model_device(model) -> torch.device:
    """The device of a model's tables."""
    if hasattr(model, "device"):
        return model.device
    return next(v.device for v in vars(model).values() if torch.is_tensor(v))


@dataclasses.dataclass(frozen=True, eq=False)
class Replicated(Model):
    """M replicas of `base` (shared disorder), energy = weight * sum_k E_k,
    on the composite spin vector of N = Nk * n_slots spins: blocks
    [0, offset) are centre configurations, which contribute nothing here;
    replica k is the block offset + k."""
    base: Model
    N: int
    Nk: int
    n_slots: int
    offset: int = 0
    weight: float = 1.0
    scale: float = 1.0

    @property
    def M(self) -> int:
        return self.n_slots - self.offset

    def to_replicas(self, sigma):
        """[B, N] composites -> [B * M, Nk] replica rows, replica-major per
        chain (a view of sigma when offset == 0)."""
        return sigma[:, self.offset * self.Nk:].reshape(-1, self.Nk)

    def decompose(self, i):
        """Composite index -> (replica k, site ii, is_replica)."""
        k = (torch.div(i, self.Nk, rounding_mode="floor")
             - self.offset).clamp(min=0)
        return k, i % self.Nk, i >= self.offset * self.Nk

    def _base_energies(self, sigma):
        """[B, M] physical energies of the replicas."""
        rows = self.to_replicas(sigma)
        e = self.base.to_physical(self.base.energy(rows))
        return e.view(sigma.shape[0], self.M)

    def energy(self, sigma):
        return self.weight * self._base_energies(sigma).sum(dim=1)

    def init_aux(self, sigma):
        return self.base.init_aux(self.to_replicas(sigma))

    def delta_all(self, sigma, aux):
        d = self.base.to_physical(
            self.base.delta_all(self.to_replicas(sigma), aux))
        flat = d.reshape(sigma.shape[0], self.M * self.Nk)
        if self.offset:
            flat = torch.cat([flat.new_zeros(
                (sigma.shape[0], self.offset * self.Nk)), flat], dim=1)
        return self.weight * flat

    def _rows_of(self, i):
        """(row r[b] of the replica batch that holds spin i[b], the site
        index of i[b] given to every one of the B * M rows, and whether
        i[b] is a replica spin)."""
        k, ii, is_rep = self.decompose(i)
        B = i.shape[0]
        r = torch.arange(B, device=i.device) * self.M + k
        return r, ii.repeat_interleave(self.M), is_rep

    def delta_one(self, sigma, aux, i):
        """The base's batched delta_one over all B * M rows at the site of
        i, read at each chain's replica row."""
        r, ii_all, is_rep = self._rows_of(i)
        d = self.base.delta_one(self.to_replicas(sigma), aux, ii_all)[r]
        d = self.base.to_physical(d)
        return torch.where(is_rep, self.weight * d, torch.zeros_like(d))

    def flip(self, sigma, aux, i, do):
        """The base flips the replica row of spin i in every chain with do,
        through its own batched flip over all B * M rows (the other rows
        masked), updating aux in place."""
        r, ii_all, is_rep = self._rows_of(i)
        rows = self.to_replicas(sigma)
        sel = torch.zeros(rows.shape[0], dtype=torch.bool, device=i.device)
        sel[r] = do & is_rep
        self.base.flip(rows, aux, ii_all, sel)
        if self.offset:       # rows was a copy: flip the composite itself
            flip_spin(sigma, i, do)
        return sigma, aux

    def replica_energies(self, sigma):
        """[B, M] physical energies of the individual replicas (the
        reference's Renergies / REenergies)."""
        return self._base_energies(sigma)

    #: synthesize an all-but-self block table for dense bases up to this Nk
    DENSE_TABLE_MAX_NK = 4096

    def neighbor_table(self):
        """The base's neighbours shifted into each replica's block (a flip
        changes deltas in its own replica only); centre blocks get
        sentinel rows. A dense base gets an all-but-self block table when
        Nk is small enough, else None."""
        nb = self.base.neighbor_table()
        dev = model_device(self.base)
        if nb is None:
            if self.Nk > self.DENSE_TABLE_MAX_NK or self.Nk < 2:
                return None
            ar = torch.arange(self.Nk, device=dev)
            nb = (ar[:, None] + 1 + ar[None, :-1]) % self.Nk
        nb = nb.to(torch.int32)
        pad = nb >= self.Nk
        blocks = [torch.where(pad, self.N, nb + (self.offset + k) * self.Nk)
                  for k in range(self.M)]
        if self.offset:
            blocks.insert(0, torch.full((self.offset * self.Nk, nb.shape[1]),
                                        self.N, dtype=torch.int32,
                                        device=dev))
        return torch.cat(blocks, dim=0).to(torch.int32)


# ---------------------------------------------------------------------------
# GraphQT: the Suzuki-Trotter ring (QT.jl)
# ---------------------------------------------------------------------------

def four_K(beta: float, Gamma: float, M: int) -> float:
    """fourK = 2/beta * log(coth(beta*Gamma/M)), rounded to 8 digits."""
    x = beta * Gamma / M
    return round(2.0 / beta * math.log(1.0 / math.tanh(x)), MAXDIGITS)


def GraphQT(Nk: int, M: int, fourK: float, *, device=None) -> Pairwise:
    """Ferromagnetic ring over the M Trotter slices of each of Nk sites,
    E = -(fourK/4) sum_{i,k} s_{i,k} s_{i,k+1}: an exact integer Pairwise
    with scale fourK/4, spin j coupled to j +- Nk (mod N)."""
    if M <= 2:
        raise ValueError(f"M must be greater than 2, given: {M}")
    N = Nk * M
    adj = [[(j - Nk) % N, (j + Nk) % N] for j in range(N)]
    J = [[1.0, 1.0]] * N
    qt = make_pairwise(adj, J, N, integer_scale=1.0,
                       classes=(0.0, abs(fourK)), device=device)
    return dataclasses.replace(qt, scale=fourK / 4.0)


def transverse_mag(qt: Pairwise, sigma, beta: float) -> torch.Tensor:
    """[B] cosh(x) - p*sinh(x), x = beta*fourK/2, p = -energy0/N, energy0
    the ring's internal integer energy (QT.jl's transverse_mag)."""
    p = -qt.energy(sigma).to(ftype()) / qt.N
    x = beta * (4.0 * qt.scale) / 2.0
    return math.cosh(x) - p * math.sinh(x)


@dataclasses.dataclass(frozen=True, eq=False)
class QuantModel(Double):
    """GraphQuant: inner = the GraphQT ring, resid = M replicas of the base
    model with weight 1/M."""
    M: int = 0
    Nk: int = 0
    beta: float = 0.0
    Gamma: float = 0.0

    def Qenergy(self, sigma):
        """[B] average Hamiltonian per spin: -Gamma * transverse_mag +
        sum_k E_k / N (QT.jl)."""
        Es = self.resid_m.replica_energies(sigma)
        return -self.Gamma * self.transverse_mag(sigma) + Es.sum(dim=1) / self.N

    def transverse_mag(self, sigma):
        return transverse_mag(self.inner_m, sigma, self.beta)

    def Renergies(self, sigma):
        """[B, M] individual replica energies."""
        return self.resid_m.replica_energies(sigma)

    def overlaps(self, sigma):
        """[B, M // 2] average replica overlap by Trotter distance (QT.jl's
        overlaps); the spin products are summed exactly in float64."""
        M, Nk = self.M, self.Nk
        rows = sigma.reshape(-1, M, Nk).to(torch.float64)
        q = rows @ rows.transpose(1, 2)                       # [B, M, M]
        k = np.arange(M)
        d = np.abs(k[:, None] - k[None, :])
        d = np.minimum(d, M - d)
        out = []
        for delta in range(1, M // 2 + 1):
            mask = torch.as_tensor((d == delta) & (k[:, None] < k[None, :]),
                                   device=sigma.device)
            tot = (q * mask).sum(dim=(1, 2))
            denom = (M * Nk) if (M % 2 == 1 or delta < M // 2) \
                else (M * Nk // 2)
            out.append(tot / denom)
        return torch.stack(out, dim=1).to(ftype())


def GraphQuant(Nk: int, M: int, Gamma: float, beta: float,
               base: Model) -> QuantModel:
    """Suzuki-Trotter replication of the classical model `base` (on Nk
    spins) in transverse field Gamma at inverse temperature beta, on the
    base's device; every Trotter slice shares the base model."""
    if Gamma < 0:
        raise ValueError(f"Gamma must be >= 0, given: {Gamma}")
    if base.N != Nk:
        raise ValueError(f"base model has N={base.N}, expected {Nk}")
    N = Nk * M
    inner = GraphQT(Nk, M, four_K(beta, Gamma, M), device=model_device(base))
    resid = Replicated(base=base, N=N, Nk=Nk, n_slots=M, offset=0,
                       weight=1.0 / M)
    return QuantModel(inner_m=inner, resid_m=resid, N=N, M=M, Nk=Nk,
                      beta=beta, Gamma=Gamma)


# ---------------------------------------------------------------------------
# GraphRE: the robust-ensemble star (RE.jl)
# ---------------------------------------------------------------------------

def _log2cosh(x):
    """log(2 cosh x), overflow-safe."""
    ax = x.abs()
    return ax + torch.log1p(torch.exp(-2.0 * ax))


def _fk_table(M: int, gamma: float, beta: float) -> np.ndarray:
    """fk(mubar) = [log cosh(g(mubar+1)) - log cosh(g(mubar-1))]/beta for
    mubar in {-M+1, -M+3, ..., M-1}, in float64; entry d holds
    mubar = 2d - M + 1 (the reference's Delta-E list)."""
    def logcoshratio(a, b):
        a, b = abs(a), abs(b)
        return (a - b) + (math.log1p(math.exp(-2 * a))
                          - math.log1p(math.exp(-2 * b)))
    mubar = np.arange(M) * 2 - M + 1
    return np.array([logcoshratio(gamma * (m + 1), gamma * (m - 1)) / beta
                     for m in mubar])


@dataclasses.dataclass(frozen=True, eq=False)
class GraphRE(Model):
    """The robust ensemble's interaction: E = -sum_i log(2 cosh(gamma mu_i))
    / beta, mu_i the replica magnetization of site i; aux = mu [B, Nk]
    int32. Flipping (i, k) costs s_ik * fk(mu_i - s_ik)."""
    fk: torch.Tensor   # [M] float32, indexed by (mubar + M - 1) >> 1
    N: int
    Nk: int
    Mr: int
    gamma: float = 0.0
    beta_p: float = 0.0
    scale: float = 1.0

    def _mu(self, sigma):
        return sigma.reshape(-1, self.Mr, self.Nk).sum(dim=1,
                                                        dtype=torch.int32)

    def energy(self, sigma):
        mu = self._mu(sigma).to(ftype())
        return -_log2cosh(self.gamma * mu).sum(dim=1) / self.beta_p

    def init_aux(self, sigma):
        return self._mu(sigma)

    def delta_all(self, sigma, aux):
        s = sigma.to(torch.int32)
        mubar = aux.repeat(1, self.Mr) - s           # mu of each spin's site
        return s.to(self.fk.dtype) * self.fk[((mubar + self.Mr - 1) >> 1).long()]

    def delta_one(self, sigma, aux, i):
        rows = torch.arange(sigma.shape[0], device=sigma.device)
        s = sigma[rows, i].to(torch.int32)
        mubar = aux[rows, i % self.Nk] - s
        return s.to(self.fk.dtype) * self.fk[((mubar + self.Mr - 1) >> 1).long()]

    def flip(self, sigma, aux, i, do):
        rows = torch.arange(sigma.shape[0], device=sigma.device)
        s = sigma[rows, i].to(torch.int32)
        aux[rows, i % self.Nk] += torch.where(do, -2 * s, 0)
        return flip_spin(sigma, i, do), aux

    def delta_classes(self):
        return tuple(sorted({round(abs(float(v)), 12)
                             for v in self.fk.cpu().tolist()}))

    def neighbor_table(self):
        """Flipping (i, k) changes mu_i, hence the deltas of site i in every
        other replica: [N, M-1]."""
        j = torch.arange(self.N, dtype=torch.int32, device=self.fk.device)
        site, k = j % self.Nk, j // self.Nk
        return torch.stack([site + ((k + d) % self.Mr) * self.Nk
                            for d in range(1, self.Mr)], dim=1)


@dataclasses.dataclass(frozen=True, eq=False)
class REModel(Double):
    """GraphRobustEnsemble: inner = the GraphRE star, resid = M replicas of
    the base model (weight 1)."""
    M: int = 0
    Nk: int = 0

    def REenergies(self, sigma):
        """[B, M] individual replica energies."""
        return self.resid_m.replica_energies(sigma)


def GraphRobustEnsemble(Nk: int, M: int, gamma: float, beta: float,
                        base: Model) -> REModel:
    """Robust-ensemble replication of `base`, on the base's device; all M
    replicas share the base disorder."""
    if M <= 2:
        raise ValueError(f"M must be greater than 2, given: {M}")
    if base.N != Nk:
        raise ValueError(f"base model has N={base.N}, expected {Nk}")
    N = Nk * M
    fk = torch.tensor(_fk_table(M, gamma, beta), dtype=ftype(),
                      device=model_device(base))
    inner = GraphRE(fk=fk, N=N, Nk=Nk, Mr=M, gamma=gamma, beta_p=beta)
    resid = Replicated(base=base, N=N, Nk=Nk, n_slots=M, offset=0,
                       weight=1.0)
    return REModel(inner_m=inner, resid_m=resid, N=N, M=M, Nk=Nk)
