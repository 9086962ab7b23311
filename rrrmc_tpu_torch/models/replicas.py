"""Replica-ensemble wrappers (the JAX package's rrrmc_tpu/models/replicas.py),
batch-explicit: the quantum Suzuki-Trotter model (`GraphQuant`, the
reference's QT.jl), the robust ensemble (`GraphRobustEnsemble`, RE.jl), local
entropy (`GraphLocalEntropy`, LE.jl), topological local entropy
(`GraphTopologicalLocalEntropy`, TLE.jl) and the AddFields family
(AddFields.jl).

M replicas of one base model on Nk spins form one composite spin vector in
the JAX package's REPLICA-MAJOR block layout: spin (i, k) is i + k * Nk,
replica k the contiguous block [k * Nk, (k + 1) * Nk); LE and TLE put the
centre (reference) configuration first, so their replica k is block k + 1.
For RE, LE and TLE this deviates from the reference's site-major layouts, as
the JAX package does; `to_reference_layout` / `from_reference_layout`
convert. Every replica shares the base model's disorder (the reference's
aliases pass one generated instance to all replicas).

Batch-explicit: a [B, N] batch of composites is a [B * M, Nk] batch of base
configurations (a view of the same memory), so the base model's own batched
methods serve every replica at once and its aux is batched on axis 0 as
[B * M, ...]. Energies are physical floats.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ..core.dtypes import ftype
from ..core.model import Model, flip_spin
from .composite import Double, Mixed
from .pairwise import Pairwise, make_pairwise

MAXDIGITS = 8  # fourK is rounded to 8 decimal digits (the reference's QT.jl)


def model_device(model) -> torch.device:
    """The device of a model's tables, a composite's from its parts."""
    if hasattr(model, "device"):
        return model.device
    for v in vars(model).values():
        if torch.is_tensor(v):
            return v.device
    for v in vars(model).values():
        for part in (v if isinstance(v, tuple) else (v,)):
            if isinstance(part, Model):
                return model_device(part)
    raise ValueError(f"{type(model).__name__} holds no tensor")


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
        masked), updating aux in place; each spin flips once. With offset
        0 the rows are a view of sigma, so the base's flip is the
        composite's; with centre blocks they are always a copy (a reshape
        of one chain's rows would be a view), and the composite flips spin
        i itself."""
        r, ii_all, is_rep = self._rows_of(i)
        rows = self.to_replicas(sigma)
        if self.offset:
            rows = rows.clone()
        sel = torch.zeros(rows.shape[0], dtype=torch.bool, device=i.device)
        sel[r] = do & is_rep
        self.base.flip(rows, aux, ii_all, sel)
        if self.offset:
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


# ---------------------------------------------------------------------------
# GraphLE: the local-entropy star with an explicit reference (LE.jl)
# ---------------------------------------------------------------------------

def _le_classes(M: int, gammaT: float) -> Tuple[float, ...]:
    """The |dE| classes of GraphLE (the reference's allDeltaE)."""
    g = abs(gammaT)
    if M % 2 == 0:
        vals = {4.0 * d * g for d in range(M // 2 + 1)} | {2.0 * g}
    else:
        vals = {2.0 * (2 * d - 1) * g for d in range(1, (M + 1) // 2 + 1)}
    return tuple(sorted(vals))


def GraphLE(Nk: int, M: int, gammaT: float, *, device=None) -> Pairwise:
    """E = -gammaT sum_i s^c_i sum_k s_{i,k}: a star of M edges from each
    centre spin to its replicas, an exact integer Pairwise with scale
    gammaT, on `device` (CUDA when none is given). Replica-major blocks:
    the centre block is [0, Nk), replica k the block [(k+1) Nk, (k+2) Nk)."""
    if M <= 2:
        raise ValueError(f"M must be greater than 2, given: {M}")
    N = Nk * (M + 1)
    adj, J = [None] * N, [None] * N
    for i in range(Nk):
        adj[i] = [(k + 1) * Nk + i for k in range(M)]    # centre -> replicas
        J[i] = [1.0] * M
        for k in range(M):
            adj[(k + 1) * Nk + i] = [i]                   # replica -> centre
            J[(k + 1) * Nk + i] = [1.0]
    le = make_pairwise(adj, J, N, integer_scale=1.0,
                       classes=_le_classes(M, gammaT), device=device)
    return dataclasses.replace(le, scale=gammaT)


class _CentreMixin:
    """The observables LE and TLE share: the centre configuration, its base
    energy and the replicas' Hamming distances."""

    def center_config(self, sigma):
        """[B, Nk] reference configurations (the leading block)."""
        return sigma[:, : self.Nk]

    def cenergy(self, sigma):
        """[B] base-model energies of the reference configurations (not
        part of the Hamiltonian; LE.jl's cenergy)."""
        base = self.resid_m.base
        return base.to_physical(base.energy(self.center_config(sigma)))

    def distances(self, sigma):
        """[B, M, M] int32 Hamming distances between the replicas; the spin
        products are summed exactly in float64."""
        rows = sigma[:, self.Nk:].reshape(-1, self.M, self.Nk).to(
            torch.float64)
        q = rows @ rows.transpose(1, 2)
        return torch.div(self.Nk - q.to(torch.int32), 2,
                         rounding_mode="floor")


@dataclasses.dataclass(frozen=True, eq=False)
class LEModel(_CentreMixin, Double):
    """GraphLocalEntropy: inner = the GraphLE star, resid = M replicas of
    the base model; the reference configuration's own base energy is not
    part of the Hamiltonian (`cenergy` reports it)."""
    M: int = 0
    Nk: int = 0

    def LEenergies(self, sigma):
        """[B, M] individual replica energies."""
        return self.resid_m.replica_energies(sigma)


def GraphLocalEntropy(Nk: int, M: int, gamma: float, beta: float,
                      base: Model) -> LEModel:
    """Local-entropy replication of `base` with an explicit reference spin
    per site, on the base's device; coupling gammaT = gamma / beta."""
    if base.N != Nk:
        raise ValueError(f"base model has N={base.N}, expected {Nk}")
    N = Nk * (M + 1)
    inner = GraphLE(Nk, M, gamma / beta, device=model_device(base))
    resid = Replicated(base=base, N=N, Nk=Nk, n_slots=M + 1, offset=1,
                       weight=1.0)
    return LEModel(inner_m=inner, resid_m=resid, N=N, M=M, Nk=Nk)


# ---------------------------------------------------------------------------
# GraphTLE: topological local entropy (TLE.jl)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class GraphTLE(Model):
    """The LE star plus a topological 4-spin term over the base graph's
    edges:

        E = -gammaT sum_i c_i sum_k s_{i,k}
            -lambdaT sum_{<i1,i2>} c_{i1} c_{i2} sum_k s_{i1,k} s_{i2,k}

    (c the centre spins), in GraphLE's block layout. `neighb` [Nk, Kmax] is
    the site adjacency, padded with the sentinel Nk. No aux: delta_all
    recomputes every flip cost from sigma in one gather pass over
    [B, M, Nk, Kmax], the JAX package's shape. Physical float32 energies."""
    neighb: torch.Tensor   # [Nk, Kmax] int32, padded with Nk
    N: int
    Nk: int
    Mr: int
    gammaT: float = 0.0
    lambdaT: float = 0.0
    max_deg: int = 0
    scale: float = 1.0

    @property
    def device(self) -> torch.device:
        return self.neighb.device

    def _split(self, sigma):
        """(centre [B, Nk + 1], replicas [B, M, Nk + 1]) int32, each padded
        with a zero site for the sentinel."""
        s = sigma.to(torch.int32)
        B = s.shape[0]
        zero = s.new_zeros((B, 1))
        c = torch.cat([s[:, : self.Nk], zero], dim=1)
        r = s[:, self.Nk:].reshape(B, self.Mr, self.Nk)
        r = torch.cat([r, zero[:, None].expand(B, self.Mr, 1)], dim=2)
        return c, r

    def energy(self, sigma):
        c, r = self._split(sigma)
        nb = self.neighb.long()
        ri = r[:, :, : self.Nk]
        n = -(c[:, None, : self.Nk] * ri).sum(dim=(1, 2), dtype=torch.int64)
        # each edge once: i1 < i2 over the padded table
        i1 = torch.arange(self.Nk, device=nb.device)[:, None]
        mask = (nb > i1) & (nb < self.Nk)
        dots = (ri[..., None] * r[:, :, nb]).sum(1, dtype=torch.int32)
        cc = c[:, : self.Nk, None] * c[:, nb]
        t = -torch.where(mask, cc * dots, 0).sum(dim=(1, 2),
                                                 dtype=torch.int64)
        e = n.to(torch.float64) * self.gammaT \
            + t.to(torch.float64) * self.lambdaT
        return e.to(ftype())

    def init_aux(self, sigma):
        return ()

    def delta_all(self, sigma, aux):
        c, r = self._split(sigma)
        nb = self.neighb.long()
        cn = c[:, nb]                                     # [B, Nk, K]
        rn = r[:, :, nb]                                  # [B, M, Nk, K]
        ri = r[:, :, : self.Nk]                           # [B, M, Nk]
        ci = c[:, : self.Nk]                              # [B, Nk]
        dots = (ri[..., None] * rn).sum(1, dtype=torch.int32)  # [B, Nk, K]
        # replica spin (k, i): 2 gT c_i s_ki + 2 lT c_i s_ki sum_j c_j s_kj
        f_rep = (cn[:, None] * rn).sum(-1, dtype=torch.int32)
        cr = (ci[:, None] * ri).to(ftype())
        d_rep = (2.0 * self.gammaT) * cr \
            + (2.0 * self.lambdaT) * cr * f_rep.to(ftype())
        # centre spin i: 2 gT c_i mu_i + 2 lT c_i sum_j c_j dot_ij
        mu = ri.sum(1, dtype=torch.int32)
        d_ctr = (2.0 * self.gammaT) * (ci * mu).to(ftype()) \
            + (2.0 * self.lambdaT) * ci.to(ftype()) \
            * (cn * dots).sum(-1, dtype=torch.int32).to(ftype())
        return torch.cat([d_ctr, d_rep.reshape(sigma.shape[0], -1)], dim=1)

    def flip(self, sigma, aux, i, do):
        return flip_spin(sigma, i, do), aux

    def delta_classes(self):
        """The instance's |dE| classes (TLE.jl's allDeltaE)."""
        d1 = _le_classes(self.Mr, abs(self.gammaT))
        mn = self.Mr * self.max_deg
        d2 = [2.0 * d * self.lambdaT for d in range(-mn, mn + 1)]
        return tuple(sorted({round(abs(a + b), 9) for a in d1 for b in d2}))

    def neighbor_table(self):
        """The spins whose flip cost a flip changes, padded with the
        sentinel N to width max(1 + 2K, M + K + K M): a replica spin
        (i, k) moves its centre, the neighbour centres and its replica's
        neighbour spins; a centre spin i all replicas at i, the neighbour
        centres and all replicas at the neighbour sites."""
        Nk, M, K = self.Nk, self.Mr, self.neighb.shape[1]
        nb = self.neighb.to(torch.int32)
        pad = nb >= Nk
        sent = self.N
        nb_c = torch.where(pad, sent, nb)
        width = max(1 + 2 * K, M + K + K * M)

        def padded(rows):
            return torch.cat([rows, rows.new_full(
                (Nk, width - rows.shape[1]), sent)], dim=1)

        site = torch.arange(Nk, dtype=torch.int32, device=nb.device)
        reps_i = torch.stack([(k + 1) * Nk + site for k in range(M)], dim=1)
        rep_nb = [torch.where(pad, sent, (k + 1) * Nk + nb) for k in range(M)]
        out = [padded(torch.cat([reps_i, nb_c] + rep_nb, dim=1))]
        out += [padded(torch.cat([site[:, None], nb_c, rep_nb[k]], dim=1))
                for k in range(M)]
        return torch.cat(out, dim=0).to(torch.int32)


@dataclasses.dataclass(frozen=True, eq=False)
class TLEModel(_CentreMixin, Double):
    """GraphTopologicalLocalEntropy: inner = GraphTLE, resid = M replicas
    of the base model."""
    M: int = 0
    Nk: int = 0

    def TLEenergies(self, sigma):
        """[B, M] individual replica energies."""
        return self.resid_m.replica_energies(sigma)


def neighbor_lists(table) -> list:
    """Ragged lists of sites from an [N, K] neighbour table padded with N
    (a Pairwise's `neigh`, or a JAX TLE's `neighb`)."""
    tbl = np.asarray(table.cpu() if torch.is_tensor(table) else table)
    return [[int(j) for j in row if j < tbl.shape[0]] for row in tbl]


def GraphTopologicalLocalEntropy(Nk: int, M: int, gamma: float,
                                 lambda_: float, beta: float, base: Model,
                                 neighb=None) -> TLEModel:
    """TLE replication of `base`, on the base's device; the topological
    neighbourhood `neighb` (ragged lists of sites) defaults to a Pairwise
    base's adjacency. gammaT = gamma / beta, lambdaT = lambda_ / beta."""
    if base.N != Nk:
        raise ValueError(f"base model has N={base.N}, expected {Nk}")
    if neighb is None:
        if not isinstance(base, Pairwise):
            raise ValueError("neighb required unless base is a Pairwise "
                             "model")
        neighb = neighbor_lists(base.neigh)
    kmax = max(max((len(r) for r in neighb), default=0), 1)
    tbl = np.full((Nk, kmax), Nk, dtype=np.int32)
    for i, row in enumerate(neighb):
        if i in row:
            raise ValueError(f"neighb[{i}] contains itself")
        tbl[i, :len(row)] = row
    N = Nk * (M + 1)
    inner = GraphTLE(neighb=torch.as_tensor(tbl, device=model_device(base)),
                     N=N, Nk=Nk, Mr=M, gammaT=gamma / beta,
                     lambdaT=lambda_ / beta, max_deg=kmax)
    resid = Replicated(base=base, N=N, Nk=Nk, n_slots=M + 1, offset=1,
                       weight=1.0)
    return TLEModel(inner_m=inner, resid_m=resid, N=N, M=M, Nk=Nk)


# ---------------------------------------------------------------------------
# layout conversion to and from the reference's index conventions
# ---------------------------------------------------------------------------

def reference_permutation(model) -> np.ndarray:
    """perm with sigma_internal[perm[j]] the spin at reference index j.
    Quant is replica-major in the reference too (QT.jl); RE is site-major,
    j = k + i M (RE.jl); LE and TLE are site-major with slot 0 the
    reference, j = s + i (M + 1) (LE.jl)."""
    if isinstance(model, QuantModel):
        return np.arange(model.N)
    if isinstance(model, REModel):
        i, k = np.divmod(np.arange(model.N), model.M)
        return k * model.Nk + i
    if isinstance(model, (LEModel, TLEModel)):
        i, s = np.divmod(np.arange(model.N), model.M + 1)
        return s * model.Nk + i  # s = 0: the centre; s = k + 1: replica k
    raise TypeError(type(model).__name__)


def from_reference_layout(model, sigma_ref):
    """Configurations [..., N] in the reference's layout -> the internal
    block layout."""
    sigma_ref = torch.as_tensor(sigma_ref)
    perm = torch.as_tensor(reference_permutation(model),
                           device=sigma_ref.device)
    out = torch.zeros_like(sigma_ref)
    out[..., perm] = sigma_ref
    return out


def to_reference_layout(model, sigma):
    """Configurations [..., N] in the internal block layout -> the
    reference's layout."""
    sigma = torch.as_tensor(sigma)
    return sigma[..., torch.as_tensor(reference_permutation(model),
                                      device=sigma.device)]


# ---------------------------------------------------------------------------
# the AddFields family (AddFields.jl)
# ---------------------------------------------------------------------------

def GraphAF(fields, *, device=None) -> Pairwise:
    """External fields with the reference's sign, E = +sum_i h_i s_i: a
    float Pairwise with no edges and fields -h (Pairwise's E is
    -sum h s), on `device` (CUDA when none is given)."""
    h = -np.asarray(fields, dtype=np.float64)
    adj = [[] for _ in range(len(h))]
    return make_pairwise(adj, adj, len(h), h=h, device=device)


def _fields_of(fields, base: Model) -> Pairwise:
    af = GraphAF(fields, device=model_device(base))
    if af.N != base.N:
        raise ValueError(f"incompatible length, fields size={af.N} graph "
                         f"size={base.N}")
    return af


def GraphAddFields(fields, base: Model) -> Double:
    """inner = the fields (rrrMC samples them exactly), resid = the wrapped
    model."""
    return Double(inner_m=_fields_of(fields, base), resid_m=base, N=base.N)


@dataclasses.dataclass(frozen=True, eq=False)
class Scaled(Model):
    """`base` with its physical energy multiplied by `factor` (the
    add-and-subtract identity of GraphAddSubFields)."""
    base: Model
    N: int
    factor: float = 1.0
    scale: float = 1.0

    def energy(self, sigma):
        return self.factor * self.base.to_physical(self.base.energy(sigma))

    def init_aux(self, sigma):
        return self.base.init_aux(sigma)

    def delta_all(self, sigma, aux):
        return self.factor * self.base.to_physical(
            self.base.delta_all(sigma, aux))

    def delta_one(self, sigma, aux, i):
        return self.factor * self.base.to_physical(
            self.base.delta_one(sigma, aux, i))

    def flip(self, sigma, aux, i, do):
        return self.base.flip(sigma, aux, i, do)


def GraphAddSubFields(fields, base: Model) -> Double:
    """The add-and-subtract identity: the total energy is the base's, but
    rrrMC's inner part is the fields, corrected by resid = base - fields."""
    af = _fields_of(fields, base)
    resid = Mixed(parts=(base, Scaled(base=af, N=af.N, factor=-1.0)),
                  N=base.N)
    return Double(inner_m=af, resid_m=resid, N=base.N)
